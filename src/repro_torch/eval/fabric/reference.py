"""Scalar semantics the batched kernels keep: the event simulator
(:mod:`repro_torch.core.simulator`) runs these per channel."""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.types import FileSpec

_EPS = 1e-12


def tick_rate_update(prev_estimate: float, delta_bytes: float, period: float) -> float:
    """Measured-rate refresh at a controller tick: the first measurement
    seeds the estimate, later ones blend 50/50 with it."""
    inst = delta_bytes / period
    return inst if prev_estimate == 0 else 0.5 * prev_estimate + 0.5 * inst


def next_event_dt(
    time_to_tick: float,
    deads: Sequence[float],
    remainings: Sequence[float],
    rates: Sequence[float],
) -> float:
    """Time to the next state change among busy channels, capped by
    ``time_to_tick``: a channel in dead time (``deads[i] > 0``) changes
    when it expires, a transferring one when it finishes its file
    (``remaining / rate``); a channel with no rate contributes nothing."""
    dt = time_to_tick
    for dead, rem, r in zip(deads, remainings, rates):
        if dead > _EPS:
            dt = min(dt, dead)
        elif r > _EPS:
            dt = min(dt, rem / r)
    return max(dt, 0.0)


def resume_file(remaining: float) -> FileSpec:
    """Synthetic file re-queued when a busy channel is closed mid-transfer:
    the in-flight remainder restarts, rounded up to whole bytes
    (``controllers.transitions.move_channel`` pushes its size)."""
    return FileSpec(name="__resume__", size=int(math.ceil(remaining)))
