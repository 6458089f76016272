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


def coupled_fair_share(
    demand: Sequence[float],
    member: Sequence[Sequence[bool]],
    link_cap: Sequence[float],
) -> list:
    """Progressive filling, the yardstick of ``kernels.waterfill_coupled``.

    Max-min fairness over rows sharing finite links: raise every unfrozen
    row's rate in lockstep until a link saturates (its members freeze at
    the common level) or a row reaches its demand (it freezes there),
    remove the bound capacity, repeat. ``member[l][r]`` is row r's
    membership of link l; a row on no link gets its whole demand. Returns
    the per-row rates. O(rows * links) scalar loops: a test oracle."""
    R = len(demand)
    L = len(link_cap)
    x = [0.0] * R
    frozen = [False] * R
    remaining_cap = [float(c) for c in link_cap]
    for r in range(R):
        if not any(member[l][r] for l in range(L)):
            x[r] = float(demand[r])
            frozen[r] = True
    level = 0.0
    for _ in range(R + L + 1):
        active = [r for r in range(R) if not frozen[r]]
        if not active:
            break
        # headroom to the next freezing event at the common level
        step = math.inf
        for r in active:
            step = min(step, demand[r] - level)
        for l in range(L):
            members = [r for r in active if member[l][r]]
            if members:
                step = min(step, remaining_cap[l] / len(members))
        if not math.isfinite(step):
            break
        step = max(step, 0.0)
        level += step
        for l in range(L):
            members = [r for r in active if member[l][r]]
            remaining_cap[l] -= step * len(members)
        newly = set()
        for l in range(L):
            if remaining_cap[l] <= _EPS * max(link_cap[l], 1.0):
                for r in active:
                    if member[l][r]:
                        newly.add(r)
        for r in active:
            if demand[r] - level <= _EPS * max(demand[r], 1.0):
                newly.add(r)
        for r in newly:
            x[r] = level
            frozen[r] = True
    for r in range(R):
        if not frozen[r]:
            x[r] = level
    return x


def resume_file(remaining: float) -> FileSpec:
    """Synthetic file re-queued when a busy channel is closed mid-transfer:
    the in-flight remainder restarts, rounded up to whole bytes
    (``controllers.transitions.move_channel`` pushes its size)."""
    return FileSpec(name="__resume__", size=int(math.ceil(remaining)))
