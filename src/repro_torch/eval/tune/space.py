"""Parameter space of the autotuner.

Algorithm 1 bounds the three knobs from the path's physics: pipelining is
useful up to ~BDP / avgFileSize (the command-queue depth that hides the
per-file control gap), parallelism up to ~BDP / bufferSize (streams beyond
a full window add only CPU tax, and servers clamp the stream count),
concurrency up to the user's maxCC budget. :func:`param_space` turns those
caps into log-spaced axes (each knob's response saturates, so geometric
spacing covers the range with few points); :class:`ParamSpace` is what
the searchers walk: the whole grid for the oracle, shrinking candidate
sets for successive halving, one-step axis neighbours for hill climbing.

:class:`StaticParamsScheduler` (from :mod:`repro_torch.core.baselines`)
is the evaluation vehicle: one undivided chunk at a fixed candidate
setting, a trivial controller on the batched sweep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import testbeds
from repro_torch.core.baselines import StaticParamsScheduler  # noqa: F401  (re-export)
from repro_torch.core.params import MAX_PIPELINING, find_optimal_parameters
from repro_torch.core.types import NetworkSpec, TransferParams

from ..scenarios import build_files

__all__ = [
    "ParamSpace",
    "StaticParamsScheduler",
    "algorithm1_params",
    "axis_sizes",
    "param_space",
    "scenario_space",
]


def _thin(values: Sequence[int], n: int) -> Tuple[int, ...]:
    """At most ``n`` values, uniform in index space, endpoints kept (a
    1-point budget keeps the low endpoint)."""
    vals = sorted(set(int(v) for v in values))
    if len(vals) <= n:
        return tuple(vals)
    if n <= 1:
        return (vals[0],)
    idx = {round(i * (len(vals) - 1) / (n - 1)) for i in range(n)}
    return tuple(vals[i] for i in sorted(idx))


def _axis(
    n: int,
    cap: int,
    *,
    include_zero: bool = False,
    extend_cap: Optional[int] = None,
    pin: Optional[int] = None,
) -> Tuple[int, ...]:
    """Up to ``n`` axis values over the useful range ``[lo, cap]``.

    Dense integers when the range fits the budget, log-spaced (powers of
    two and the endpoints, ``pin`` kept when it falls inside) otherwise.
    When the dense range is smaller than the budget and ``extend_cap`` is
    given, the axis continues past the useful cap by powers of two: such
    settings are admissible, only predicted useless by the closed form,
    and an oracle that never looks there would credit the heuristic with
    its own blind spot.
    """
    cap = max(1, int(cap))
    lo = 0 if include_zero else 1
    if cap - lo + 1 <= n:
        vals = set(range(lo, cap + 1))
    else:
        vals = {lo, 1, cap}
        v = 2
        while v < cap:
            vals.add(v)
            v *= 2
        if pin is not None and lo < pin < cap:
            vals.add(int(pin))
        vals = set(_thin(sorted(vals), n))
        if pin is not None and lo < pin < cap:
            vals.add(int(pin))
    if extend_cap is not None:
        v = max(cap, 1)
        while len(vals) < n:
            v *= 2
            if v > extend_cap:
                break
            vals.add(v)
    return tuple(sorted(vals))


def axis_sizes(n_candidates: int) -> Tuple[int, int, int]:
    """Split a candidate budget into (n_pp, n_par, n_cc) axis sizes.

    Concurrency is the most sensitive knob (disk saturation and contention
    put a sweet spot inside its range), so spare budget grows the cc axis
    first, then pipelining, then parallelism.
    """
    if n_candidates < 1:
        raise ValueError("n_candidates must be >= 1")
    base = max(1, int(math.floor(n_candidates ** (1.0 / 3.0) + 1e-9)))
    sizes = [base, base, base]  # [pp, par, cc]
    for axis in (2, 0, 1):
        grown = list(sizes)
        grown[axis] *= 2
        if grown[0] * grown[1] * grown[2] <= n_candidates:
            sizes = grown
    return tuple(sizes)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Log-spaced (pipelining, parallelism, concurrency) axes: the
    cartesian product is the oracle's grid, the axes what the hill climber
    walks (one step along one axis at a time)."""

    pp_axis: Tuple[int, ...]
    par_axis: Tuple[int, ...]
    cc_axis: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.pp_axis), len(self.par_axis), len(self.cc_axis))

    @property
    def size(self) -> int:
        return len(self.pp_axis) * len(self.par_axis) * len(self.cc_axis)

    def params_at(self, idx: Tuple[int, int, int]) -> TransferParams:
        i, j, k = idx
        return TransferParams(
            pipelining=self.pp_axis[i],
            parallelism=self.par_axis[j],
            concurrency=self.cc_axis[k],
        )

    def grid(self) -> List[TransferParams]:
        """Every axis combination, pp-major (stable candidate order)."""
        return [
            TransferParams(pipelining=pp, parallelism=par, concurrency=cc)
            for pp in self.pp_axis
            for par in self.par_axis
            for cc in self.cc_axis
        ]

    def nearest(self, params: TransferParams) -> Tuple[int, int, int]:
        """Axis indices of the grid point nearest ``params`` (geometric
        distance per axis: the axes are log-spaced)."""

        def pick(axis: Tuple[int, ...], v: int) -> int:
            return min(
                range(len(axis)),
                key=lambda i: abs(math.log1p(float(axis[i])) - math.log1p(float(v))),
            )

        return (
            pick(self.pp_axis, params.pipelining),
            pick(self.par_axis, params.parallelism),
            pick(self.cc_axis, params.concurrency),
        )

    def neighbors(self, idx: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
        """The one-step axis neighbourhood of ``idx`` (<= 6 points)."""
        out = []
        for axis in range(3):
            for step in (-1, 1):
                nxt = list(idx)
                nxt[axis] += step
                if 0 <= nxt[axis] < self.shape[axis]:
                    out.append(tuple(nxt))
        return out  # type: ignore[return-value]


def param_space(
    network: NetworkSpec,
    max_cc: int,
    avg_file_size: float,
    *,
    n_candidates: int = 64,
) -> ParamSpace:
    """BDP-capped log-spaced axes for one path and dataset shape.

    pipelining   0 .. BDP / avgFileSize (the queue depth that hides the
                 per-file control gap; deeper queues change nothing)
    parallelism  1 .. min(ceil(BDP / buffer), the server's stream clamp)
    concurrency  1 .. maxCC (the budget the heuristics get, so regret
                 compares equals), with the disk saturation point pinned
                 into the axis when it falls inside
    """
    if avg_file_size <= 0:
        avg_file_size = 1.0
    pp_cap = int(min(MAX_PIPELINING, max(1, round(network.bdp / avg_file_size))))
    par_cap = int(
        min(
            network.max_streams_per_channel,
            max(1, math.ceil(network.bdp / max(network.buffer_size, 1))),
        )
    )
    cc_cap = max(1, int(max_cc))
    sat = int(network.disk.saturation_cc)

    def build(n_pp: int, n_par: int, n_cc: int) -> ParamSpace:
        return ParamSpace(
            pp_axis=_axis(n_pp, pp_cap, include_zero=True, extend_cap=MAX_PIPELINING),
            par_axis=_axis(n_par, par_cap, extend_cap=network.max_streams_per_channel),
            cc_axis=_axis(n_cc, cc_cap, pin=sat),
        )

    sizes = list(axis_sizes(n_candidates))
    space = build(*sizes)
    # honour the candidate budget: when tight BDP caps leave the grid short
    # (huge-file datasets cap pipelining at ~1), grow axes (concurrency
    # first, dense up to the maxCC budget, then pipelining and parallelism
    # past their useful ranges) until the product reaches the budget or
    # nothing can grow
    for _ in range(64):
        if space.size >= n_candidates:
            break
        for axis in (2, 0, 1):  # cc, pp, par
            trial = list(sizes)
            trial[axis] += 1
            grown = build(*trial)
            if grown.shape[axis] > space.shape[axis]:
                sizes, space = trial, grown
                break
        else:
            break
    return space


def _avg_file_size(files) -> float:
    return sum(f.size for f in files) / len(files) if files else 1.0


def scenario_space(scenario, *, n_candidates: int = 64) -> ParamSpace:
    """The scenario's search space: its testbed's caps and its dataset's
    average file size."""
    files = build_files(scenario)
    return param_space(
        testbeds.TESTBEDS[scenario.network], scenario.max_cc,
        max(_avg_file_size(files), 1.0), n_candidates=n_candidates,
    )


def algorithm1_params(scenario) -> TransferParams:
    """The Algorithm-1 setting for the scenario's whole dataset (one
    undivided chunk): the hill climber's default start point."""
    network = testbeds.TESTBEDS[scenario.network]
    files = build_files(scenario)
    return find_optimal_parameters(
        avg_file_size=max(_avg_file_size(files), 1.0),
        bdp=network.bdp,
        buffer_size=network.buffer_size,
        max_cc=scenario.max_cc,
        num_files=len(files),
    )
