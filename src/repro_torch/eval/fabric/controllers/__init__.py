"""SC / MC / ProMC decision layer (Algorithms 1-3) as tensor kernels.

  * :mod:`.tuning`      — Algorithm 1 and the SC largest-class-first order;
  * :mod:`.alloc`       — Alg. 2 round-robin and Alg. 3 delta-weighted
    initial channel allocations;
  * :mod:`.decide`      — chunk ETAs and predicted rates, the ProMC streak
    state machine and the laggard grant loop;
  * :mod:`.transitions` — masked Open / Close / Move updates with the LIFO
    resume-file stack.

Every kernel takes tensors with the chunk (K) / channel (C) structure on
the trailing axes and broadcasts over a leading scenario axis.
"""
from __future__ import annotations

from .alloc import round_robin_alloc, weighted_alloc
from .decide import chunk_eta, laggard_grants, predicted_chunk_rate, promc_tick
from .transitions import (
    apply_grants,
    close_chunk,
    move_channel,
    open_ranked,
    sc_advance_cursor,
)
from .tuning import optimal_params, sc_chunk_order

__all__ = [
    "apply_grants",
    "chunk_eta",
    "close_chunk",
    "laggard_grants",
    "move_channel",
    "open_ranked",
    "optimal_params",
    "predicted_chunk_rate",
    "promc_tick",
    "round_robin_alloc",
    "sc_advance_cursor",
    "sc_chunk_order",
    "weighted_alloc",
]
