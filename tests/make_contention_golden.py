"""Write ``tests/golden/contention_tenant.json``: the reference
implementation's fleet contention report (``repro.eval.tune.contention``
on its NumPy backend) over tenant matrices, as the goldens the port's
report is held to on the CPU (``tests/test_torch_contention.py``) and on
the card (``chip_smoke.py`` phase 5d), which may not import the reference.
Run from the repository root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_contention_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_contention_golden.py --case full

The default writes the two cases the checks read (~2.5 min on one CPU
core): ``small`` (``tenant_matrix(n_groups=2)``, 4 candidates) and
``tenant-smoke`` (``tenant_matrix(n_groups=6)``, 8 candidates). ``--case
full`` adds the whole 206-row ``tenant_matrix()`` at 8 candidates, which
takes tens of minutes. Each case keeps the whole report
(``ContentionReport.to_json``) and the wall seconds it took; a run updates
only its own cases in the file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro.eval.scenarios import tenant_matrix
from repro.eval.tune.contention import contention_report

OUT = Path(__file__).resolve().parent / "golden" / "contention_tenant.json"
COMMAND = "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_contention_golden.py"

#: case -> (tenant_matrix n_groups, or None for the default 36; candidates)
CASES = {
    "small": (2, 4),
    "tenant-smoke": (6, 8),
    "full": (None, 8),
}


def run_case(name: str) -> dict:
    groups, n_candidates = CASES[name]
    matrix = tenant_matrix() if groups is None else tenant_matrix(n_groups=groups)
    t0 = time.perf_counter()
    report = contention_report(matrix, backend="numpy", n_candidates=n_candidates)
    return {
        "n_groups": groups,
        "n_candidates": n_candidates,
        "rows": len(matrix),
        "wall_s": time.perf_counter() - t0,
        "report": report.to_json(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="case to (re)write; default: small and tenant-smoke")
    args = ap.parse_args(argv)
    names = args.case or ["small", "tenant-smoke"]
    done = {name: run_case(name) for name in names}
    payload = json.loads(OUT.read_text()) if OUT.exists() else {"cases": {}}
    payload["command"] = COMMAND
    payload["cases"].update(done)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    for name, case in done.items():
        agg = case["report"]["aggregate"]
        print(f"{name}: {case['rows']} rows, {case['wall_s']:.1f} s, "
              f"regret median {agg['regret_median']!r}, "
              f"{agg['oracle_evals']} oracle evaluations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
