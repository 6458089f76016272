"""Exhaustive static-parameter oracle and the heuristics' regret.

The paper's headline claim, that the adaptive heuristics come close to
the best static (pipelining, parallelism, concurrency) setting without
knowing it in advance, needs that optimum computed. :func:`oracle_search`
treats the batched sweep as a black-box objective ``f(scenario, pp, p,
cc) -> throughput``: the matrix is expanded along the candidate axis
(:func:`repro_torch.eval.scenarios.expand_candidates`), every (scenario x
candidate) row becomes an ordinary ``static`` scenario, and one
:func:`repro_torch.eval.runner.run_matrix` call sweeps the whole plane.

Scenarios that share a transfer context (testbed, dataset, seed, tick
period and maxCC budget) have the same candidate objective (static rows
ignore ``num_chunks`` and ``algorithm``), so each context is evaluated
once and its argmax broadcast to every member row.

:func:`regret_report` scores the heuristics:
``regret = heuristic_throughput / oracle_throughput`` per scenario,
aggregated per algorithm. Above 1.0 the adaptive controller beat every
static setting (per-chunk parameters and re-allocation are what a single
static setting cannot express).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import SimResult
from repro_torch.core.types import param_triple

from ..fabric.driver import SweepStats
from ..runner import CHUNK_SIZE, run_matrix
from ..scenarios import Scenario, expand_candidates
from .space import algorithm1_params, scenario_space

#: the scenario fields a static candidate's throughput depends on
#: (``num_chunks`` / ``algorithm`` / ``record_timeline`` concern heuristic
#: rows; maxCC stays because it caps the search space)
ContextKey = Tuple[str, str, int, float, int]

Triple = Tuple[int, int, int]


def context_key(sc: Scenario) -> ContextKey:
    return (sc.network, sc.dataset, sc.seed, sc.tick_period, sc.max_cc)


def group_contexts(
    scenarios: Sequence[Scenario],
) -> Tuple[List[ContextKey], Dict[ContextKey, Scenario]]:
    """Unique transfer contexts (insertion-ordered) and one representative
    scenario each."""
    keys: List[ContextKey] = []
    reps: Dict[ContextKey, Scenario] = {}
    for sc in scenarios:
        key = context_key(sc)
        if key not in reps:
            keys.append(key)
            reps[key] = sc
    return keys, reps


@dataclasses.dataclass(frozen=True)
class ContextTable:
    """One context's candidate evaluations: the searched settings and the
    throughput each achieved (aligned, search order)."""

    candidates: Tuple[Triple, ...]
    throughputs: Tuple[float, ...]

    @property
    def best_index(self) -> int:
        return int(np.argmax(self.throughputs))

    @property
    def best_params(self) -> Triple:
        return self.candidates[self.best_index]

    @property
    def best_throughput(self) -> float:
        return float(self.throughputs[self.best_index])


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    """Per-scenario search outcome (broadcast from its context)."""

    scenario: str
    context: ContextKey
    best_params: Triple
    best_throughput: float
    n_candidates: int


@dataclasses.dataclass
class TuneResult:
    """Outcome of one search over a scenario matrix.

    ``entries`` follows the input scenario order; ``tables`` holds the
    per-context evidence; ``evals`` counts candidate simulations run and
    ``equivalent_evals`` their full-fidelity cost (they differ only for
    successive halving's subsampled rungs); ``trace`` is the per-context
    search trace (successive halving: a dict a rung; hill climbing: a dict
    an iteration).
    """

    method: str
    entries: List[TuneEntry]
    tables: Dict[ContextKey, ContextTable]
    evals: int
    equivalent_evals: float
    trace: Optional[Dict[ContextKey, List[dict]]] = None

    def to_json(self) -> dict:
        return {
            "method": self.method,
            "evals": self.evals,
            "equivalent_evals": round(self.equivalent_evals, 3),
            "entries": [
                {
                    "scenario": e.scenario,
                    "best_params": {
                        "pipelining": e.best_params[0],
                        "parallelism": e.best_params[1],
                        "concurrency": e.best_params[2],
                    },
                    "best_throughput": e.best_throughput,
                    "n_candidates": e.n_candidates,
                }
                for e in self.entries
            ],
        }


def candidate_lists(
    scenarios: Sequence[Scenario],
    *,
    n_candidates: int = 64,
    space: Optional[Callable[[Scenario], Sequence]] = None,
    history=None,
) -> Tuple[List[ContextKey], Dict[ContextKey, Scenario], Dict[ContextKey, List[Triple]]]:
    """Deduplicated contexts and their candidate sets.

    ``space`` overrides the default BDP-capped grid
    (:func:`.space.scenario_space`). The Algorithm-1 whole-dataset point
    always joins the set (the heuristics' own operating point must be
    inside the searched space, or grid granularity alone would hand them
    regret > 1 on one-chunk datasets), as does a ``history`` store's
    remembered winner for the context when the grid lacks it.
    """
    keys, reps = group_contexts(scenarios)
    cands: Dict[ContextKey, List[Triple]] = {}
    for key in keys:
        rep = reps[key]
        if space is not None:
            raw = space(rep)
        else:
            raw = scenario_space(rep, n_candidates=n_candidates).grid()
        triples = [param_triple(p) for p in raw]
        alg1 = param_triple(algorithm1_params(rep))
        if alg1 not in triples:
            triples.append(alg1)
        if history is not None:
            seed = history.seed(rep)
            if seed is not None and param_triple(seed) not in triples:
                triples.append(param_triple(seed))
        if not triples:
            raise ValueError(f"empty candidate set for context {key}")
        cands[key] = triples
    return keys, reps, cands


def _entries(
    scenarios: Sequence[Scenario],
    tables: Dict[ContextKey, ContextTable],
    n_cands: Dict[ContextKey, int],
) -> List[TuneEntry]:
    return [
        TuneEntry(
            scenario=sc.name,
            context=context_key(sc),
            best_params=tables[context_key(sc)].best_params,
            best_throughput=tables[context_key(sc)].best_throughput,
            n_candidates=n_cands[context_key(sc)],
        )
        for sc in scenarios
    ]


def oracle_search(
    scenarios: Sequence[Scenario],
    *,
    backend: str = "batch",
    device=None,
    n_candidates: int = 64,
    space: Optional[Callable[[Scenario], Sequence]] = None,
    history=None,
    chunk_size: int = CHUNK_SIZE,
    stats: Optional[SweepStats] = None,
    executor: Optional[str] = None,
) -> TuneResult:
    """Exhaustive grid search, run as one batched sweep: per-context
    argmax over the whole candidate grid, the ground truth of the regret
    claims and the budget the cheaper searchers are measured against.
    ``device`` is the batched backend's (default: the card); ``stats``
    accumulates the sweep's counts; ``executor`` is the runner's chunk
    executor."""
    keys, reps, cands = candidate_lists(
        scenarios, n_candidates=n_candidates, space=space, history=history
    )
    expanded: List[Scenario] = []
    spans: List[Tuple[ContextKey, int, int]] = []
    for key in keys:
        rows = expand_candidates([reps[key]], cands[key])
        spans.append((key, len(expanded), len(expanded) + len(rows)))
        expanded.extend(rows)
    results = run_matrix(
        expanded, device=device, stats=stats, backend=backend, chunk_size=chunk_size,
        executor=executor,
    )
    tables = {
        key: ContextTable(
            candidates=tuple(cands[key]),
            throughputs=tuple(r.throughput for r in results[lo:hi]),
        )
        for key, lo, hi in spans
    }
    if history is not None:
        for key in keys:
            history.record(
                reps[key], tables[key].best_params, tables[key].best_throughput,
                method="oracle",
            )
    return TuneResult(
        method="oracle",
        entries=_entries(scenarios, tables, {k: len(cands[k]) for k in keys}),
        tables=tables,
        evals=len(expanded),
        equivalent_evals=float(len(expanded)),
    )


# --------------------------------------------------------------------------
# regret
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RegretReport:
    """Heuristic-vs-oracle scoring of one matrix run.

    ``per_scenario`` holds one dict a heuristic row (name, algorithm,
    heuristic and oracle throughput, the oracle's parameters, regret);
    ``per_algorithm`` aggregates (median / mean / min / max regret and the
    fraction of rows where the adaptive controller beat every static
    candidate).
    """

    method: str
    per_scenario: List[dict]
    per_algorithm: Dict[str, dict]

    def to_json(self) -> dict:
        return {
            "method": self.method,
            "per_algorithm": self.per_algorithm,
            "n_scenarios": len(self.per_scenario),
            "per_scenario": [
                dict(row, oracle_params=list(row["oracle_params"]))
                for row in self.per_scenario
            ],
        }

    def format_table(self) -> str:
        lines = [
            f"{'algorithm':<12} {'median':>8} {'mean':>8} {'min':>8} "
            f"{'max':>8} {'beats-oracle':>13} {'n':>5}"
        ]
        for algo, agg in sorted(self.per_algorithm.items()):
            lines.append(
                f"{algo:<12} {agg['median']:>8.3f} {agg['mean']:>8.3f} "
                f"{agg['min']:>8.3f} {agg['max']:>8.3f} "
                f"{agg['frac_above_1']:>12.0%} {agg['n']:>5d}"
            )
        return "\n".join(lines)


def regret_report(
    scenarios: Sequence[Scenario],
    heuristic_results: Sequence[SimResult],
    tune_result: TuneResult,
) -> RegretReport:
    """Score every heuristic scenario against its context's static
    optimum: ``regret = heuristic_throughput / oracle_throughput``
    (static rows are candidates, not contestants, and are left out)."""
    by_context = {e.context: e for e in tune_result.entries}
    rows: List[dict] = []
    buckets: Dict[str, List[float]] = {}
    for sc, res in zip(scenarios, heuristic_results):
        if sc.algorithm == "static":
            continue
        entry = by_context[context_key(sc)]
        regret = res.throughput / max(entry.best_throughput, 1e-12)
        rows.append(
            {
                "scenario": sc.name,
                "algorithm": sc.algorithm,
                "heuristic_throughput": res.throughput,
                "oracle_throughput": entry.best_throughput,
                "oracle_params": entry.best_params,
                "regret": regret,
            }
        )
        buckets.setdefault(sc.algorithm, []).append(regret)
    per_algorithm = {
        algo: {
            "median": float(np.median(vals)),
            "mean": float(np.mean(vals)),
            "min": float(np.min(vals)),
            "max": float(np.max(vals)),
            "frac_above_1": float(np.mean(np.asarray(vals) > 1.0)),
            "n": len(vals),
        }
        for algo, vals in buckets.items()
    }
    return RegretReport(
        method=tune_result.method, per_scenario=rows, per_algorithm=per_algorithm
    )


def save_report(path: str, report: RegretReport, tune_result: TuneResult) -> None:
    """Write a regret report and the search it scored as JSON: the
    per-algorithm aggregates, the per-scenario regret rows and every
    context's candidate table (the reference implementation's format)."""
    payload = {
        "regret": report.to_json(),
        "search": tune_result.to_json(),
        "tables": {
            "/".join(str(part) for part in key): {
                "candidates": [list(c) for c in table.candidates],
                "throughputs": list(table.throughputs),
            }
            for key, table in tune_result.tables.items()
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
