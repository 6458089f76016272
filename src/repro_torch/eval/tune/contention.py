"""Fleet contention report: greedy per-tenant tuning against a coupled oracle.

The paper's heuristics tune each transfer as if it owned the network;
:func:`repro_torch.eval.scenarios.tenant_matrix` couples tenants through
shared backbone links. This module asks whether greedy per-tenant
Algorithm-1 tuning collapses under contention against a static oracle that
knows about it. Per fabric group it compares:

  - **heuristic**: the tenant matrix as it is, each adaptive tenant (SC /
    MC / ProMC) running its controller blind to the other tenants on its
    links, its chunk parameters from Algorithm 1 on its own testbed and
    dataset;
  - **oracle**: the best static per-tenant settings found with the
    contention in view, by coordinate descent over a group's tenants
    (sweep one tenant's candidates while the others hold theirs, keep the
    one with the best **group aggregate** throughput, go on to the next
    tenant). It starts at each tenant's Algorithm-1 setting; the candidates
    are that setting's grid neighbours (the hill climber's axis moves) and
    the incumbent, so each accepted step can only raise the aggregate.

``regret = heuristic_aggregate / oracle_aggregate`` a group. An isolated
leg (the same rows with the fabric stripped) gives how hard contention
binds: ``contention_factor = coupled_aggregate / isolated_aggregate``.

Every candidate evaluation is an ordinary coupled batch: the trial group
is cloned under a renamed fabric group (``g000.p0k2c5``) so that clones
never couple with each other or the original, and all clones of one
descent step run through one :func:`repro_torch.eval.runner.run_matrix`
call::

    python -m repro_torch.eval.tune.contention --groups 6 --device cpu
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import TransferParams, param_triple

from ..runner import CHUNK_SIZE, run_matrix
from ..scenarios import Scenario, tenant_matrix
from .space import algorithm1_params, scenario_space


def _group_rows(scenarios: Sequence[Scenario]) -> Dict[str, List[Scenario]]:
    """Coupled rows by fabric group, in order of first appearance;
    uncoupled rows are no contention subjects and are skipped."""
    groups: Dict[str, List[Scenario]] = {}
    for sc in scenarios:
        if sc.shared_fabric is not None:
            groups.setdefault(sc.shared_fabric.group, []).append(sc)
    return groups


def _configured_group(
    rows: Sequence[Scenario], settings: Sequence[Tuple[int, int, int]], tag: str,
) -> List[Scenario]:
    """The group pinned at fixed static settings, cloned under a renamed
    fabric group so that the clone couples with nothing else."""
    out: List[Scenario] = []
    for sc, trip in zip(rows, settings):
        fab = dataclasses.replace(sc.shared_fabric, group=f"{sc.shared_fabric.group}.{tag}")
        out.append(
            dataclasses.replace(
                sc, algorithm="static", static_params=tuple(trip),
                record_timeline=False, shared_fabric=fab,
            )
        )
    return out


def _candidate_grid(sc: Scenario, n_candidates: int) -> List[Tuple[int, int, int]]:
    """A tenant's candidates: its Algorithm-1 setting snapped to the search
    grid, then one step along each axis (the hill climber's neighbours).
    Not the whole grid: degenerate corners (``cc=1, pp=0`` on a many-file
    dataset) make a lockstep group crawl at its slowest member's pace, and
    under contention the moves of interest are local back-off and growth."""
    space = scenario_space(sc, n_candidates=max(n_candidates, 8))
    anchor = sc.static_params if sc.static_params is not None else param_triple(algorithm1_params(sc))
    start = space.nearest(
        TransferParams(pipelining=anchor[0], parallelism=anchor[1], concurrency=anchor[2])
    )
    idxs = [tuple(start)]
    for axis in range(3):
        for d in (-1, 1):
            j = list(start)
            j[axis] += d
            if 0 <= j[axis] < space.shape[axis] and tuple(j) not in idxs:
                idxs.append(tuple(j))
    out: List[Tuple[int, int, int]] = []
    for idx in idxs:
        trip = param_triple(space.params_at(idx))
        if trip not in out:
            out.append(trip)
    return out[:n_candidates]


@dataclasses.dataclass
class ContentionReport:
    """Per-group and aggregate contention outcomes (see the module doc)."""

    backend: str
    n_candidates: int
    per_group: List[dict]
    per_algorithm: Dict[str, dict]
    aggregate: dict

    def to_json(self) -> dict:
        return {
            "backend": self.backend,
            "candidates": self.n_candidates,
            "aggregate": self.aggregate,
            "per_algorithm": self.per_algorithm,
            "per_group": self.per_group,
        }

    def summary(self) -> dict:
        """The aggregate and each algorithm's median regret."""
        return {
            "backend": self.backend,
            "candidates": self.n_candidates,
            **self.aggregate,
            "regret_median_by_algorithm": {
                algo: agg["median"] for algo, agg in self.per_algorithm.items()
            },
        }


def greedy_static_oracle(
    groups: Dict[str, List[Scenario]],
    *,
    backend: str = "batch",
    device=None,
    n_candidates: int = 8,
    passes: int = 1,
    chunk_size: int = CHUNK_SIZE,
    stats=None,
) -> Tuple[Dict[str, List[Tuple[int, int, int]]], int]:
    """Coordinate-descent static oracle under contention. Returns
    ``(settings, evals)``: each group's per-tenant static triples and the
    number of coupled candidate rows simulated. Every group advances the
    same tenant slot together, so a descent step is one ``run_matrix``
    call over every group's clones. ``stats`` (a ``SweepStats``)
    accumulates the batched runs' counts."""
    settings: Dict[str, List[Tuple[int, int, int]]] = {}
    cands: Dict[str, List[List[Tuple[int, int, int]]]] = {}
    for g, rows in groups.items():
        settings[g] = [
            sc.static_params if sc.static_params is not None else param_triple(algorithm1_params(sc))
            for sc in rows
        ]
        cands[g] = [_candidate_grid(sc, n_candidates) for sc in rows]
    evals = 0
    max_tenants = max((len(rows) for rows in groups.values()), default=0)
    for p in range(passes):
        for k in range(max_tenants):
            batch: List[Scenario] = []
            spans: List[Tuple[str, int, int, int]] = []
            for g, rows in groups.items():
                if k >= len(rows):
                    continue
                # the incumbent is always candidate 0: an accepted step can
                # only raise the aggregate
                options = [settings[g][k]] + [c for c in cands[g][k] if c != settings[g][k]]
                cands[g][k] = options
                for ci, trip in enumerate(options):
                    trial = list(settings[g])
                    trial[k] = trip
                    clone = _configured_group(rows, trial, f"p{p}k{k}c{ci}")
                    spans.append((g, ci, len(batch), len(batch) + len(clone)))
                    batch.extend(clone)
            if not batch:
                continue
            results = run_matrix(
                batch, device=device, backend=backend, chunk_size=chunk_size, stats=stats
            )
            evals += len(batch)
            best: Dict[str, Tuple[float, int]] = {}
            for g, ci, lo, hi in spans:
                agg = float(sum(r.throughput for r in results[lo:hi]))
                if g not in best or agg > best[g][0]:
                    best[g] = (agg, ci)
            for g, (_, ci) in best.items():
                settings[g][k] = cands[g][k][ci]
    return settings, evals


def contention_report(
    scenarios: Optional[Sequence[Scenario]] = None,
    *,
    backend: str = "batch",
    device=None,
    n_candidates: int = 8,
    passes: int = 1,
    chunk_size: int = CHUNK_SIZE,
    stats=None,
) -> ContentionReport:
    """Run the three legs (the heuristics coupled, the rows isolated, the
    greedy static oracle) over a tenant matrix and score the contended
    regret. ``backend`` is the runner's (``"batch"`` on ``device``, the
    card unless given, or ``"event"``); ``stats`` accumulates the batched
    runs' counts."""
    if scenarios is None:
        scenarios = tenant_matrix()
    groups = _group_rows(scenarios)
    if not groups:
        raise ValueError(
            "contention_report needs coupled scenarios (every row had "
            "shared_fabric=None): build the matrix with tenant_matrix()"
        )
    dev = device if backend == "batch" else None

    # legs 1 and 2 in one run: the fleet as it is, and fabric-stripped
    # copies (independent rows, so batching them beside the groups changes
    # nothing)
    coupled: List[Scenario] = [sc for rows in groups.values() for sc in rows]
    isolated = [dataclasses.replace(sc, shared_fabric=None) for sc in coupled]
    res = run_matrix(coupled + isolated, device=dev, backend=backend, chunk_size=chunk_size,
                     stats=stats)
    h_res, iso_res = res[: len(coupled)], res[len(coupled):]
    h_of = {sc.name: r for sc, r in zip(coupled, h_res)}
    iso_of = {sc.name: r for sc, r in zip(coupled, iso_res)}

    # leg 3: the contended static oracle, then one run at the chosen
    # settings for the per-tenant oracle throughputs
    settings, evals = greedy_static_oracle(
        groups, backend=backend, device=dev, n_candidates=n_candidates, passes=passes,
        chunk_size=chunk_size, stats=stats,
    )
    final: List[Scenario] = []
    fspans: Dict[str, Tuple[int, int]] = {}
    for g, rows in groups.items():
        clone = _configured_group(rows, settings[g], "opt")
        fspans[g] = (len(final), len(final) + len(clone))
        final.extend(clone)
    fin_res = run_matrix(final, device=dev, backend=backend, chunk_size=chunk_size, stats=stats)
    evals += len(final)

    per_group: List[dict] = []
    algo_regret: Dict[str, List[float]] = {}
    for g, rows in groups.items():
        lo, hi = fspans[g]
        o_rows = fin_res[lo:hi]
        h_agg = float(sum(h_of[sc.name].throughput for sc in rows))
        iso_agg = float(sum(iso_of[sc.name].throughput for sc in rows))
        o_agg = float(sum(r.throughput for r in o_rows))
        for sc, o in zip(rows, o_rows):
            algo_regret.setdefault(sc.algorithm, []).append(
                h_of[sc.name].throughput / max(o.throughput, 1e-12)
            )
        per_group.append(
            {
                "group": g,
                "tenants": len(rows),
                "links": len({ln for sc in rows for ln in sc.shared_fabric.links}),
                "algorithms": [sc.algorithm for sc in rows],
                "heuristic_bps": h_agg,
                "oracle_bps": o_agg,
                "isolated_bps": iso_agg,
                "regret": h_agg / max(o_agg, 1e-12),
                "contention_factor": h_agg / max(iso_agg, 1e-12),
                "oracle_params": [list(t) for t in settings[g]],
            }
        )
    regrets = np.asarray([row["regret"] for row in per_group])
    factors = np.asarray([row["contention_factor"] for row in per_group])
    per_algorithm = {
        algo: {
            "median": float(np.median(vals)),
            "mean": float(np.mean(vals)),
            "min": float(np.min(vals)),
            "n": len(vals),
        }
        for algo, vals in algo_regret.items()
    }
    aggregate = {
        "groups": len(per_group),
        "tenants": len(coupled),
        "oracle_evals": evals,
        "regret_median": float(np.median(regrets)),
        "regret_mean": float(np.mean(regrets)),
        "regret_min": float(np.min(regrets)),
        "frac_groups_above_1": float(np.mean(regrets > 1.0)),
        "contention_factor_median": float(np.median(factors)),
    }
    return ContentionReport(
        backend=backend, n_candidates=n_candidates, per_group=per_group,
        per_algorithm=per_algorithm, aggregate=aggregate,
    )


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", choices=("batch", "event"), default="batch")
    ap.add_argument("--device", default="cuda", help="the batched backend's device")
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--groups", type=int, default=None,
                    help="tenant_matrix n_groups (default: all 36)")
    ap.add_argument("--json", action="store_true",
                    help="print the whole report, not just the summary")
    args = ap.parse_args(argv)
    matrix = tenant_matrix(n_groups=args.groups) if args.groups else tenant_matrix()
    t0 = time.perf_counter()
    report = contention_report(
        matrix, backend=args.backend, device=args.device, n_candidates=args.candidates,
        passes=args.passes,
    )
    payload = report.to_json() if args.json else report.summary()
    payload["wall_s"] = time.perf_counter() - t0
    print(json.dumps(payload, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
