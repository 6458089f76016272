"""Serving steps of the LLM scaffold."""
