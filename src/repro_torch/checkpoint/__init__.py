"""Sharded checkpointing driven by the paper's transfer engine."""
