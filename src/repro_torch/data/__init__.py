"""Synthetic datasets of the scenario matrices."""
