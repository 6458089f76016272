"""Cheaper-than-oracle searchers over the batched sweep.

Both compose several batched sweeps in a host loop: the card evaluates a
whole (context x candidate) plane a rung or an iteration, the host only
shrinks and re-batches the candidate axis between sweeps. Their rows are
Simulations built from explicit file sets (:func:`_builder`), run through
:func:`repro_torch.eval.runner.run_built` and the object ingest.

* :func:`successive_halving`: every candidate on a small deterministic
  sketch of the dataset, keep the top ``1/eta`` per context, re-evaluate
  the survivors on an ``eta``-times larger sketch, until the final rung
  runs the whole dataset. With 64 candidates and eta = 4 (64 at 1/16, 16
  at 1/4, 4 at full) the full-fidelity-equivalent cost is 12 evaluations
  a context, under a quarter of the oracle's.
* :func:`hill_climb`: coordinate descent on the log-spaced axes of
  :class:`.space.ParamSpace`: start at the remembered winner
  (:mod:`.history`) or the Algorithm-1 point, evaluate the <= 6 one-step
  neighbours of every live context's setting in one sweep, move each
  context to its best neighbour, repeat until none improves.

A rung's sketch is equal-count buckets over the size-sorted files, one
synthetic file a bucket at the bucket's mean size (:meth:`_Context.subset`),
the same for every candidate of the rung, so rung comparisons are fair and
the dataset's byte shares survive even a 1/16 sketch. ``equivalent_evals``
counts each rung at the fraction it simulated.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import testbeds
from repro_torch.core.runner import build_scheduler
from repro_torch.core.simulator import Simulation
from repro_torch.core.types import FileSpec

from ..fabric.driver import SweepStats
from ..runner import CHUNK_SIZE, cost_estimate, run_built
from ..scenarios import Scenario, build_files
from .oracle import (
    ContextKey,
    ContextTable,
    Triple,
    TuneResult,
    _entries,
    candidate_lists,
    group_contexts,
)
from .space import ParamSpace, algorithm1_params, scenario_space


def _builder(network, files, triple: Triple, max_cc: int, tick: float):
    """Zero-argument builder of one fresh static-candidate Simulation,
    through ``build_scheduler("static")`` as the oracle's matrix rows."""

    def build() -> Simulation:
        sched = build_scheduler("static", files, network, max_cc=max_cc, static_params=triple)
        return Simulation(sched.chunks, sched.network, sched, tick_period=tick)

    return build


class _Context:
    """Host-side search state of one deduplicated transfer context."""

    def __init__(self, key: ContextKey, rep: Scenario):
        self.key = key
        self.rep = rep
        self.network = testbeds.TESTBEDS[rep.network]
        self.files = build_files(rep)
        #: file indices ordered by size: sketches are size-stratified, so a
        #: rung keeps the dataset's small / huge mix
        self.by_size = sorted(range(len(self.files)), key=lambda i: (self.files[i].size, i))
        #: fraction -> sketch, shared by every candidate of a rung
        self._sketch: Dict[float, list] = {}

    def subset(self, fraction: float) -> list:
        """Deterministic ~``fraction``-sized sketch of the file set (the
        whole set at 1.0): the size-sorted files in ``ceil(fraction * m)``
        equal-count buckets, each one synthetic file at the bucket's mean
        size. Equal-count buckets scale every bucket's bytes by the same
        factor, so the byte shares of the size distribution survive
        (keeping real files at size quantiles would keep a multi-GB tail
        file and drop most bytes around it, so that every concurrency
        setting would rank equal)."""
        if fraction >= 1.0 or not self.files:
            return self.files
        cached = self._sketch.get(fraction)
        if cached is not None:
            return cached
        m = len(self.files)
        n = max(1, int(math.ceil(fraction * m)))
        if n >= m:
            return self.files
        out = []
        for b in range(n):
            lo = round(b * m / n)
            hi = max(round((b + 1) * m / n), lo + 1)
            run = [self.files[i].size for i in self.by_size[lo:hi]]
            out.append(FileSpec(name=f"sketch{b}", size=int(round(sum(run) / len(run)))))
        self._sketch[fraction] = out
        return out


def _evaluate(
    rows: Sequence[Tuple[_Context, Triple, float]],
    backend: str,
    device,
    chunk_size: int,
    stats: Optional[SweepStats],
    executor: Optional[str] = None,
) -> List[float]:
    """One batched sweep over (context, candidate, fraction) rows ->
    throughputs, input order (``executor``: the runner's chunk executor)."""
    builders, names, costs = [], [], []
    for ctx, triple, fraction in rows:
        files = ctx.subset(fraction)
        builders.append(
            _builder(ctx.network, files, triple, ctx.rep.max_cc, ctx.rep.tick_period)
        )
        names.append("{}|pp{}.p{}.cc{}|f{:g}".format(ctx.rep.name, *triple, fraction))
        costs.append(cost_estimate(ctx.network, files, triple[2], ctx.rep.tick_period))
    results = run_built(
        builders, names, costs, backend=backend, device=device,
        chunk_size=chunk_size, stats=stats, executor=executor,
    )
    return [r.throughput for r in results]


# --------------------------------------------------------------------------
# successive halving
# --------------------------------------------------------------------------


def _diverse_keep(by_idx: Dict[int, float], cands: Sequence[Triple], keep: int) -> List[int]:
    """Top-``keep`` selection that never collapses the concurrency axis.

    Sketch rungs rank pipelining and parallelism reliably (their effects
    are per file) but are biased on concurrency: a sketch shifts where the
    disk-saturation sweet spot lies, and a plain top-k would keep one cc
    value into the final rung. So the best candidate of each distinct cc
    value comes first (cc groups ordered by their best), then the rest of
    the slots by plain rank.
    """
    groups: Dict[int, List[int]] = {}
    for i in by_idx:
        groups.setdefault(cands[i][2], []).append(i)
    for cc in groups:
        groups[cc].sort(key=lambda i: -by_idx[i])
    order = sorted(groups, key=lambda cc: -by_idx[groups[cc][0]])
    kept = [groups[cc][0] for cc in order[:keep]]
    taken = set(kept)
    rest = sorted((i for i in by_idx if i not in taken), key=lambda i: -by_idx[i])
    kept += rest[: keep - len(kept)]
    return sorted(kept)


def _sha_schedule(n: int, eta: int) -> Tuple[List[int], List[float]]:
    """Candidate counts per rung and the dataset fraction each rung runs
    at (the final rung at full fidelity). The rung count is
    ``round(log_eta n)``: rounding, so that a set a hair over a power of
    eta (the Algorithm-1 and history additions to a 64-grid) grows no
    extra near-zero-fidelity rung."""
    rungs = max(1, round(math.log(max(n, 1)) / math.log(eta)))
    counts = [min(n, max(1, round(n / eta**r))) for r in range(rungs)]
    fractions = [float(eta) ** -(rungs - 1 - r) for r in range(rungs)]
    return counts, fractions


def successive_halving(
    scenarios: Sequence[Scenario],
    *,
    backend: str = "batch",
    device=None,
    n_candidates: int = 64,
    eta: int = 4,
    space: Optional[Callable[[Scenario], Sequence]] = None,
    history=None,
    chunk_size: int = CHUNK_SIZE,
    stats: Optional[SweepStats] = None,
    executor: Optional[str] = None,
) -> TuneResult:
    """Budgeted grid search: shrink the candidate axis between sweeps."""
    if eta < 2:
        raise ValueError("eta must be >= 2")
    keys, reps, cands = candidate_lists(
        scenarios, n_candidates=n_candidates, space=space, history=history
    )
    contexts = {key: _Context(key, reps[key]) for key in keys}
    survivors = {key: list(range(len(cands[key]))) for key in keys}
    schedules = {key: _sha_schedule(len(cands[key]), eta) for key in keys}
    rungs = max(len(s[0]) for s in schedules.values())
    trace: Dict[ContextKey, List[dict]] = {key: [] for key in keys}
    final: Dict[ContextKey, Dict[int, float]] = {key: {} for key in keys}
    evals = 0
    equivalent = 0.0
    for r in range(rungs):
        rows: List[Tuple[_Context, Triple, float]] = []
        row_of: List[Tuple[ContextKey, int]] = []
        actual_frac: Dict[ContextKey, float] = {}
        scores: Dict[ContextKey, Dict[int, float]] = {}
        for key in keys:
            counts, fractions = schedules[key]
            if r >= len(counts):
                continue  # this context's schedule already finished
            fraction = fractions[r]
            ctx = contexts[key]
            # cost is counted at the fraction actually simulated (ceil()
            # and the 1-file floor round small rungs up)
            actual_frac[key] = len(ctx.subset(fraction)) / len(ctx.files) if ctx.files else 1.0
            for idx in survivors[key]:
                if idx in final[key]:
                    # scored at full fidelity in an earlier rung (small
                    # file sets: the sketch is the whole set before the
                    # schedule reaches 1.0): reuse, do not re-simulate
                    scores.setdefault(key, {})[idx] = final[key][idx]
                    continue
                rows.append((ctx, cands[key][idx], fraction))
                row_of.append((key, idx))
        throughputs = _evaluate(rows, backend, device, chunk_size, stats, executor)
        evals += len(rows)
        for (key, idx), thr in zip(row_of, throughputs):
            scores.setdefault(key, {})[idx] = thr
            equivalent += actual_frac[key]
            # a sketch that covers the whole file set is the exact objective
            if actual_frac[key] >= 1.0:
                final[key][idx] = thr
        for key, by_idx in scores.items():
            counts, fractions = schedules[key]
            keep = counts[r + 1] if r + 1 < len(counts) else 1
            survivors[key] = _diverse_keep(by_idx, cands[key], keep)
            trace[key].append(
                {
                    "rung": r,
                    "fraction": fractions[r],
                    "evaluated": sorted(by_idx),
                    "scores": dict(by_idx),
                    "best_throughput": max(by_idx.values()),
                    "kept": list(survivors[key]),
                }
            )
    tables: Dict[ContextKey, ContextTable] = {}
    for key in keys:
        by_idx = final[key]
        if not by_idx:
            raise RuntimeError(f"context {key}: no candidate ran at full fidelity")
        idxs = sorted(by_idx)
        tables[key] = ContextTable(
            candidates=tuple(cands[key][i] for i in idxs),
            throughputs=tuple(by_idx[i] for i in idxs),
        )
        if history is not None:
            history.record(
                reps[key], tables[key].best_params, tables[key].best_throughput, method="sha"
            )
    return TuneResult(
        method="sha",
        entries=_entries(scenarios, tables, {k: len(cands[k]) for k in keys}),
        tables=tables,
        evals=evals,
        equivalent_evals=equivalent,
        trace=trace,
    )


# --------------------------------------------------------------------------
# hill climbing
# --------------------------------------------------------------------------


def hill_climb(
    scenarios: Sequence[Scenario],
    *,
    backend: str = "batch",
    device=None,
    n_candidates: int = 64,
    max_iters: int = 12,
    space_builder: Optional[Callable[[Scenario], ParamSpace]] = None,
    history=None,
    chunk_size: int = CHUNK_SIZE,
    stats: Optional[SweepStats] = None,
    executor: Optional[str] = None,
) -> TuneResult:
    """Coordinate descent on the log-spaced knob axes.

    ``n_candidates`` sets the axis density of the default space (the
    budget spent depends on the walk). Every iteration is one batched
    sweep over all live contexts' unevaluated neighbour settings; a
    context converges when no axis neighbour beats its current point. The
    climber needs axis structure, so its override is ``space_builder``
    (scenario -> :class:`.space.ParamSpace`), not a flat ``space``.
    """
    keys, reps = group_contexts(scenarios)
    spaces: Dict[ContextKey, ParamSpace] = {}
    contexts: Dict[ContextKey, _Context] = {}
    current: Dict[ContextKey, Tuple[int, int, int]] = {}
    cache: Dict[ContextKey, Dict[Tuple[int, int, int], float]] = {}
    trace: Dict[ContextKey, List[dict]] = {}
    for key in keys:
        rep = reps[key]
        spaces[key] = (
            space_builder(rep) if space_builder is not None
            else scenario_space(rep, n_candidates=n_candidates)
        )
        contexts[key] = _Context(key, rep)
        start = history.seed(rep) if history is not None else None
        if start is None:
            start = algorithm1_params(rep)
        current[key] = spaces[key].nearest(start)
        cache[key] = {}
        trace[key] = []
    live = set(keys)
    evals = 0
    for it in range(max_iters):
        rows: List[Tuple[_Context, Triple, float]] = []
        row_of: List[Tuple[ContextKey, Tuple[int, int, int]]] = []
        for key in sorted(live, key=keys.index):
            sp = spaces[key]
            for idx in [current[key]] + sp.neighbors(current[key]):
                if idx not in cache[key]:
                    rows.append((contexts[key], _triple_of(sp, idx), 1.0))
                    row_of.append((key, idx))
        if rows:
            throughputs = _evaluate(rows, backend, device, chunk_size, stats, executor)
            evals += len(rows)
            for (key, idx), thr in zip(row_of, throughputs):
                cache[key][idx] = thr
        next_live = set()
        for key in live:
            sp = spaces[key]
            frontier = [current[key]] + sp.neighbors(current[key])
            best = max(frontier, key=lambda i: cache[key][i])
            trace[key].append(
                {
                    "iter": it,
                    "current": current[key],
                    "throughput": cache[key][current[key]],
                    "best_neighbor": best,
                    "frontier": {i: cache[key][i] for i in frontier},
                }
            )
            if cache[key][best] > cache[key][current[key]]:
                current[key] = best
                next_live.add(key)
        live = next_live
        if not live:
            break
    tables: Dict[ContextKey, ContextTable] = {}
    for key in keys:
        sp = spaces[key]
        idxs = sorted(cache[key])
        tables[key] = ContextTable(
            candidates=tuple(_triple_of(sp, i) for i in idxs),
            throughputs=tuple(cache[key][i] for i in idxs),
        )
        if history is not None:
            history.record(
                reps[key], tables[key].best_params, tables[key].best_throughput, method="hill"
            )
    return TuneResult(
        method="hill",
        entries=_entries(scenarios, tables, {k: len(cache[k]) for k in keys}),
        tables=tables,
        evals=evals,
        equivalent_evals=float(evals),
        trace=trace,
    )


def _triple_of(sp: ParamSpace, idx: Tuple[int, int, int]) -> Triple:
    p = sp.params_at(idx)
    return (p.pipelining, p.parallelism, p.concurrency)
