"""Transfer model: datatypes, testbeds, the channel-rate model."""
