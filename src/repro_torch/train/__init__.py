"""Serving and train steps of the LLM scaffold, and the training loop (on
one device or over a group of ranks)."""
from .loop import LoopConfig, train, train_with_restarts
from .train_step import StepConfig, init_train_state, make_eval_step, make_train_step

__all__ = [
    "LoopConfig",
    "StepConfig",
    "init_train_state",
    "make_eval_step",
    "make_train_step",
    "train",
    "train_with_restarts",
]
