"""Matrix runner: scenarios -> columnar plan -> batched sweep on the card ->
per-scenario results -> golden compare.

Two backends:

  - ``batch`` (the default): the columnar plan through
    :class:`TorchFabricSimulation`, on the card unless the caller passes
    ``device="cpu"``;
  - ``event``: one :class:`repro_torch.core.simulator.Simulation` per
    row (``build_simulation(sc).run()``), a scalar loop on the host, the
    semantics the sweep is held to (:mod:`repro_torch.eval.difftest`).

Rows run in chunks of :data:`CHUNK_SIZE` scenarios ordered by the plan's cost
proxy, so each chunk is cost-homogeneous and a long straggler does not
pin the whole matrix's sweep width; results come back in input order.
Golden snapshots map scenario names to throughput, completion time,
bytes and moves; the port compares against the same files as the
reference implementation (``tests/golden/``)::

    python -m repro_torch.eval.runner --matrix default \\
        --out tests/golden/eval_matrix.json
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.device import resolve_device
from repro_torch.core.simulator import SimResult, Simulation

from .fabric.bucketing import chunk_spans
from .fabric.driver import SweepStats, TorchFabricSimulation
from .fabric.plan import build_plan, plan_supported
from .scenarios import (
    Scenario,
    build_simulation,
    default_matrix,
    full_matrix,
    smoke_matrix,
)

#: scenarios per batched execution chunk (bounds device memory; the
#: 276-row default grid runs as one chunk, the full grid as two)
CHUNK_SIZE = 1024

MATRIX_NAMES = ("default", "smoke", "full")

BACKENDS = ("batch", "event")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")


def _no_object_ingest():
    return NotImplementedError(
        "the batched backend ingests columnar plans only; prebuilt "
        "Simulations run on backend='event'"
    )


def run_plan(
    plan,
    device=None,
    fused_step: str = "rounds",
    waterfill_impl: str = "kernel",
    stats: Optional[SweepStats] = None,
) -> List[SimResult]:
    """Run every row of ``plan``, serially chunk by chunk, on ``device``
    (default: the card). ``stats``, when given, accumulates every
    chunk's sweep counts."""
    dev = resolve_device(device)
    costs = plan.cost_proxy()
    order = sorted(range(plan.n_rows), key=lambda i: costs[i])
    results: List[Optional[SimResult]] = [None] * plan.n_rows
    for lo, hi in chunk_spans(len(order), CHUNK_SIZE):
        part = order[lo:hi]
        drv = TorchFabricSimulation(
            plan.take(part), device=dev, fused_step=fused_step,
            waterfill_impl=waterfill_impl,
        )
        for i, res in zip(part, drv.run()):
            results[i] = res
        if stats is not None:
            for f in dataclasses.fields(SweepStats):
                setattr(stats, f.name, getattr(stats, f.name) + getattr(drv.stats, f.name))
    return results  # type: ignore[return-value]


def run_matrix(
    scenarios: Sequence[Scenario],
    device=None,
    fused_step: str = "rounds",
    waterfill_impl: str = "kernel",
    stats: Optional[SweepStats] = None,
    backend: str = "batch",
) -> List[SimResult]:
    """Run every scenario; results in input order. The batched backend
    runs the columnar plan on ``device`` (default: the card; it raises
    without one); the event backend runs one event simulation a row on
    the host and takes no device."""
    _check_backend(backend)
    if backend == "event":
        if device is not None:
            raise ValueError("the event backend runs on the host; it takes no device")
        return [build_simulation(sc).run() for sc in scenarios]
    dev = resolve_device(device)
    if not plan_supported(scenarios):
        raise ValueError("every scenario needs a built-in algorithm")
    return run_plan(
        build_plan(scenarios), device=dev, fused_step=fused_step,
        waterfill_impl=waterfill_impl, stats=stats,
    )


def run_scenario(scenario: Scenario, backend: str = "event", device=None) -> SimResult:
    """One scenario on ``backend`` (the event simulation by default)."""
    return run_matrix([scenario], device=device, backend=backend)[0]


def run_built(builders: Sequence, backend: str = "event") -> List[SimResult]:
    """Run lazily built Simulations: ``builders[i]`` is a zero-argument
    callable returning a fresh one (schedulers are stateful). Only the
    event backend runs them."""
    _check_backend(backend)
    if backend != "event":
        raise _no_object_ingest()
    return [b().run() for b in builders]


def run_simulations(sims: Sequence[Simulation], backend: str = "event") -> List[SimResult]:
    """Run prebuilt Simulations (sweeps that do not fit the Scenario
    grid); only the event backend runs them."""
    _check_backend(backend)
    if backend != "event":
        raise _no_object_ingest()
    return [sim.run() for sim in sims]


def build_matrix(name: str) -> List[Scenario]:
    if name == "default":
        return default_matrix()
    if name == "smoke":
        return smoke_matrix()
    if name == "full":
        return full_matrix()
    raise ValueError(f"unknown matrix {name!r}; options: {', '.join(MATRIX_NAMES)}")


# --------------------------------------------------------------------------
# golden snapshots
# --------------------------------------------------------------------------


def metrics_snapshot(
    scenarios: Sequence[Scenario], results: Sequence[SimResult]
) -> Dict[str, Dict[str, float]]:
    snap: Dict[str, Dict[str, float]] = {}
    for sc, r in zip(scenarios, results):
        snap[sc.name] = {
            "throughput_gbps": round(r.throughput_gbps, 6),
            "total_time": round(r.total_time, 6),
            "total_bytes": float(r.total_bytes),
            "n_moves": int(r.n_moves),
        }
    return snap


def load_golden(path: str) -> Dict[str, Dict[str, float]]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class GoldenDeviation:
    scenario: str
    field: str
    golden: float
    observed: float

    @property
    def rel_err(self) -> float:
        denom = max(abs(self.golden), 1e-12)
        return abs(self.observed - self.golden) / denom


def compare_golden(
    golden: Dict[str, Dict[str, float]],
    observed: Dict[str, Dict[str, float]],
    rtol: float = 1e-6,
    fields: Iterable[str] = ("throughput_gbps", "total_time"),
) -> List[GoldenDeviation]:
    """Deviations of ``observed`` from ``golden`` beyond ``rtol`` (plus any
    scenario missing from either side, reported with NaN metrics)."""
    out: List[GoldenDeviation] = []
    for name in sorted(set(golden) | set(observed)):
        if name not in golden or name not in observed:
            out.append(GoldenDeviation(name, "presence", float("nan"), float("nan")))
            continue
        for f in fields:
            dev = GoldenDeviation(name, f, golden[name][f], observed[name][f])
            if dev.rel_err > rtol:
                out.append(dev)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--matrix", choices=MATRIX_NAMES, default="default")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="tests/golden/eval_matrix.json")
    args = ap.parse_args(argv)

    scenarios = build_matrix(args.matrix)
    stats = SweepStats()
    results = run_matrix(scenarios, device=args.device, stats=stats)
    devs = compare_golden(load_golden(args.out), metrics_snapshot(scenarios, results))
    for d in devs[:20]:
        print(f"DEVIATION {d.scenario} {d.field}: golden={d.golden} observed={d.observed}")
    print(
        f"{len(scenarios)} scenarios, {len(devs)} deviations "
        f"({stats.sweeps} host rounds: {stats.fused} fused, {stats.split} split; "
        f"{stats.steps} row steps; {stats.host_syncs} host syncs)"
    )
    return 1 if devs else 0


if __name__ == "__main__":
    raise SystemExit(main())
