"""Serving and train steps of the LLM scaffold."""
