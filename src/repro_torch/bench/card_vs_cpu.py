"""Where the sweep on the card parts from the port's CPU run.

    python -m repro_torch.bench.card_vs_cpu [--trace 3]

Runs the smoke grid's oracle plane (2,061 static rows: every context's
64-candidate grid and its Algorithm-1 point) on the card and on the CPU,
where the kernels' plain versions run, and counts the rows whose event
counts or completion times differ. With ``--trace N`` it then steps the
first N such rows one loop step a launch (``ROUND_CAP`` = 1) on both
devices and reports the first step at which any row tensor differs, the
differing values in hex. Prints one JSON line with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import List, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.eval import runner
from repro_torch.eval.fabric import driver
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.scenarios import expand_candidates, smoke_matrix
from repro_torch.eval.tune import candidate_lists


def _hex(t: torch.Tensor) -> list:
    return [float(v).hex() if isinstance(v, float) else v for v in t.flatten().tolist()]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN equal to NaN."""
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def first_difference(scenario, max_steps: int = 100_000) -> Optional[dict]:
    """The first step at which the one-row sweep of ``scenario`` differs
    between the card and the CPU, one loop step a launch."""
    cap = driver.ROUND_CAP
    driver.ROUND_CAP = 1
    try:
        plan = build_plan([scenario])
        card = driver.TorchFabricSimulation(plan, device="cuda")
        cpu = driver.TorchFabricSimulation(plan, device="cpu")
        card.start()
        cpu.start()
        for step in range(max_steps):
            differ = {
                name: {"card": _hex(getattr(card, name)), "cpu": _hex(getattr(cpu, name))}
                for name in driver._ROW_ARRAYS
                if not _same(getattr(card, name).cpu(), getattr(cpu, name))
            }
            if differ:
                return {"row": scenario.name, "step": step, "differ": differ}
            if not (card.step() | cpu.step()):
                return None
        return None
    finally:
        driver.ROUND_CAP = cap


def plane_apart():
    """The smoke grid's oracle plane on the card and on the CPU: the plane's
    rows, and ``(row, card events, CPU events)`` for each row whose event
    count or completion time differs."""
    keys, reps, cands = candidate_lists(smoke_matrix())
    plane = [row for key in keys for row in expand_candidates([reps[key]], cands[key])]
    card = runner.run_matrix(plane, device="cuda")
    cpu = runner.run_matrix(plane, device="cpu")
    return plane, [
        (sc, a.n_events, b.n_events) for sc, a, b in zip(plane, card, cpu)
        if (a.n_events, a.total_time) != (b.n_events, b.total_time)
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    resolve_device("cuda")  # raises without a card
    plane, apart = plane_apart()
    out = {
        "rows": len(plane),
        "apart": len(apart),
        "events_card_cpu": [[sc.name, a, b] for sc, a, b in apart],
        "first_differences": [first_difference(sc) for sc, _, _ in apart[: args.trace]],
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
