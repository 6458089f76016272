"""Scenario matrices, the batched sweep runner and golden snapshots."""
