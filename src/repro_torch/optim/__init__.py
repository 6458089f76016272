"""Optimizers of the training path."""
