"""Write ``tests/golden/tune_full_oracle.json``: the reference
implementation's autotuner (``repro.eval.tune`` on its NumPy backend) over
the full grid and the smoke grid, as the goldens the port's tuner is held
to on the card (``chip_smoke.py`` phase 5c), which may not import the
reference. Run from the repository root (~2 min on one CPU core)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_tune_golden.py

What it keeps, per context of the full grid's 64-candidate oracle: the
best throughput and the tied-best set (every candidate within
``TIE_RTOL`` relative of the best; the reference's tables have exact ties
at the top in most contexts), and the five algorithms' regret aggregates;
per grid, successive halving's and hill climbing's evaluation counts, the
worst context's ratio to the oracle, and their decision paths (the kept
sets of every rung; the climb's points).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro.eval.runner import run_matrix
from repro.eval.scenarios import full_matrix, smoke_matrix
from repro.eval.tune import hill_climb, oracle_search, regret_report, successive_halving

OUT = Path(__file__).resolve().parent / "golden" / "tune_full_oracle.json"
COMMAND = "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_tune_golden.py"
N_CANDIDATES = 64
#: candidates this close to a context's best are one tied set
TIE_RTOL = 1e-9


def ctx_name(key) -> str:
    return "/".join(str(part) for part in key)


def worst_vs(result, oracle) -> float:
    best = {e.context: e.best_throughput for e in oracle.entries}
    return min(e.best_throughput / best[e.context] for e in result.entries)


def searches(scenarios, oracle) -> dict:
    sha = successive_halving(scenarios, backend="numpy", n_candidates=N_CANDIDATES)
    hill = hill_climb(scenarios, backend="numpy", n_candidates=N_CANDIDATES)
    return {
        "sha": {
            "evals": sha.evals,
            "equivalent_evals": sha.equivalent_evals,
            "worst_vs_oracle": worst_vs(sha, oracle),
            "kept": {ctx_name(k): [r["kept"] for r in rungs] for k, rungs in sha.trace.items()},
        },
        "hill": {
            "evals": hill.evals,
            "worst_vs_oracle": worst_vs(hill, oracle),
            "walk": {ctx_name(k): [list(it["current"]) for it in its]
                     for k, its in hill.trace.items()},
        },
    }


def main() -> int:
    full = full_matrix()
    oracle = oracle_search(full, backend="numpy", n_candidates=N_CANDIDATES)
    report = regret_report(full, run_matrix(full, backend="numpy"), oracle)
    contexts = {}
    for key, table in oracle.tables.items():
        best = table.best_throughput
        contexts[ctx_name(key)] = {
            "best_throughput": best,
            "tied_best": [list(c) for c, t in zip(table.candidates, table.throughputs)
                          if t >= best * (1.0 - TIE_RTOL)],
        }
    smoke = smoke_matrix()
    smoke_oracle = oracle_search(smoke, backend="numpy", n_candidates=N_CANDIDATES)
    payload = {
        "command": COMMAND,
        "source": "repro.eval.tune, backend numpy, full_matrix() and smoke_matrix(), "
                  f"{N_CANDIDATES} candidates",
        "tie_rtol": TIE_RTOL,
        "oracle": {"evals": oracle.evals, "contexts": contexts},
        "regret": report.per_algorithm,
        "full": searches(full, oracle),
        "smoke": searches(smoke, smoke_oracle),
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=None, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {OUT}: {len(contexts)} contexts, oracle {oracle.evals} evaluations; "
          f"regret medians {({a: v['median'] for a, v in report.per_algorithm.items()})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
