"""Distributed runtime: fault tolerance (host-side arithmetic)."""
