"""Matrix runner: scenarios -> columnar plan -> batched sweep on the card ->
per-scenario results -> golden compare.

Two backends:

  - ``batch`` (the default): the columnar plan through
    :class:`TorchFabricSimulation`, on the card unless the caller passes
    ``device="cpu"``; prebuilt Simulations (:func:`run_built`,
    :func:`run_simulations`) reach it through the object ingest
    :func:`repro_torch.eval.fabric.plan.from_simulations`;
  - ``event``: one :class:`repro_torch.core.simulator.Simulation` per
    row (``build_simulation(sc).run()``), a scalar loop on the host, the
    semantics the sweep is held to (:mod:`repro_torch.eval.difftest`);
    the rows of a shared-fabric group run in lockstep
    (:func:`repro_torch.eval.fabric.coupled_event.run_event_coupled`).

Rows run in chunks of :data:`CHUNK_SIZE` scenarios ordered by a cost
proxy, so each chunk is cost-homogeneous and a long straggler does not
pin the whole matrix's sweep width; results come back in input order.
A fabric group is coupled only inside one chunk, so its rows leave the
cost order and are packed whole into chunks of their own
(:func:`_group_atomic_parts`). The chunks go through the executor
(:mod:`.fabric.executor`, ``executor=`` / ``--executor``): ``"serial"``,
the default, is the plain loop; ``"async"`` builds the next chunk on the
host while the card runs the current one. ``--verbose`` prints where the
host's time went (:mod:`.fabric.stats`).
Golden snapshots map scenario names to throughput, completion time,
bytes and moves; the port compares against the same files as the
reference implementation (``tests/golden/``)::

    python -m repro_torch.eval.runner --matrix default \\
        --out tests/golden/eval_matrix.json
    python -m repro_torch.eval.runner --matrix full --tune oracle

``--refresh-golden`` writes the snapshot to ``--out`` instead of comparing;
``--tune {oracle,sha,hill}`` searches the static (pipelining,
parallelism, concurrency) space over the matrix (:mod:`.tune`) and prints
every heuristic's regret against the result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.core import netmodel, testbeds
from repro_torch.core.device import resolve_device
from repro_torch.core.simulator import SimResult, Simulation

from .fabric.bucketing import chunk_spans
from .fabric.coupled_event import run_event_coupled
from .fabric.driver import TorchFabricSimulation
from .fabric.executor import EXECUTOR_MODES, execute_chunks
from .fabric.plan import build_plan, from_simulations, plan_supported
from .fabric.stats import SweepStats, record_wall
from .scenarios import (
    Scenario,
    build_files,
    build_simulation,
    default_matrix,
    full_matrix,
    smoke_matrix,
    tenant_matrix,
)

#: scenarios per batched execution chunk (bounds device memory; the
#: 276-row default grid runs as one chunk, the full grid as two)
CHUNK_SIZE = 1024

MATRIX_NAMES = ("default", "smoke", "full", "tenant", "tenant-smoke")

BACKENDS = ("batch", "event")

def _check_backend(backend: str, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend == "event" and device is not None:
        raise ValueError("the event backend runs on the host; it takes no device")


def cost_estimate(network, files, concurrency: int, tick_period: float) -> float:
    """Cheap event-count estimate for cost-homogeneous chunking: the
    transfer duration at the achievable rate (window-limited streams on
    lossy paths run far below line rate) in ticks, plus the file count.
    The same doubles as :meth:`ScenarioPlan.cost_proxy`; the autotuner's
    explicit file-set rows (successive halving's sketch rungs) use it."""
    total = sum(f.size for f in files)
    est_rate = min(
        network.bandwidth,
        network.disk.streaming_rate,
        max(1, concurrency) * netmodel.channel_rate_cap(network, 4),
    )
    duration = total / max(est_rate, 1.0)
    return duration / max(tick_period, 1e-9) + len(files)


def _effective_cc(scenario: Scenario) -> int:
    # static candidate rows run at their own fixed concurrency, not the
    # heuristics' maxCC budget
    return scenario.static_params[2] if scenario.static_params is not None else scenario.max_cc


def _cost_proxy(scenario: Scenario) -> float:
    return cost_estimate(
        testbeds.TESTBEDS[scenario.network], build_files(scenario),
        _effective_cc(scenario), scenario.tick_period,
    )


def _group_atomic_parts(order: Sequence[int], fabrics: Sequence, size: int) -> tuple:
    """Split a cost-sorted row order into ``(uncoupled_order,
    coupled_parts)``. A fabric group couples only inside one batch, so the
    coupled rows leave the cost-sorted spans and are packed whole, group
    by group in order of first appearance, into parts of at most ``size``
    rows (a larger group stays whole in a part of its own). The uncoupled
    rows keep the span path, so a matrix without fabrics chunks as
    before."""
    uncoupled = [i for i in order if fabrics[i] is None]
    groups: Dict[str, List[int]] = {}
    for i in order:
        if fabrics[i] is not None:
            groups.setdefault(fabrics[i].group, []).append(i)
    parts: List[List[int]] = []
    cur: List[int] = []
    for rows in groups.values():
        if cur and len(cur) + len(rows) > size:
            parts.append(cur)
            cur = []
        cur.extend(rows)
    if cur:
        parts.append(cur)
    return uncoupled, parts


def _run_chunks(
    n: int,
    costs,
    make_plan: Callable,
    device,
    fused_step: str,
    waterfill_impl: str,
    stats: Optional[SweepStats],
    chunk_size: int,
    fabrics: Optional[Sequence] = None,
    executor: Optional[str] = None,
) -> List[SimResult]:
    """Rows ordered by ``costs`` (input order without), cut into spans of
    ``chunk_size``, the rows of fabric groups (``fabrics``, a per-row
    column) packed whole into parts of their own; each part's plan
    (``make_plan(rows)``, its seconds added to ``ingest_s``) runs as one
    driver, through the executor (``executor``). Results in input
    order."""
    dev = resolve_device(device)
    order = list(range(n)) if costs is None else sorted(range(n), key=lambda i: costs[i])
    results: List[Optional[SimResult]] = [None] * n
    coupled: List[List[int]] = []
    if fabrics is not None and any(f is not None for f in fabrics):
        order, coupled = _group_atomic_parts(order, fabrics, chunk_size)
    parts = [order[lo:hi] for lo, hi in chunk_spans(len(order), chunk_size)] + coupled

    def make_chunk(part, slot):
        t0 = time.perf_counter()
        plan = make_plan(part)
        ingest_s = time.perf_counter() - t0
        drv = TorchFabricSimulation(
            plan, device=slot, fused_step=fused_step, waterfill_impl=waterfill_impl,
        )
        drv.stats.ingest_s += ingest_s  # merged into ``stats`` with the run's counts
        return drv

    return execute_chunks(
        parts, make_chunk, results, mode=executor, device=dev, stats=stats,
    )


def run_plan(
    plan,
    device=None,
    fused_step: str = "rounds",
    waterfill_impl: str = "kernel",
    stats: Optional[SweepStats] = None,
    chunk_size: int = CHUNK_SIZE,
    executor: Optional[str] = None,
) -> List[SimResult]:
    """Run every row of ``plan``, chunk by chunk in cost order, on
    ``device`` (default: the card), through the executor (``executor``).
    ``stats``, when given, accumulates every chunk's sweep counts and
    seconds."""
    return _run_chunks(
        plan.n_rows, plan.cost_proxy(), plan.take, device, fused_step,
        waterfill_impl, stats, chunk_size, plan.fabrics, executor,
    )


def run_matrix(
    scenarios: Sequence[Scenario],
    device=None,
    fused_step: str = "rounds",
    waterfill_impl: str = "kernel",
    stats: Optional[SweepStats] = None,
    backend: str = "batch",
    chunk_size: int = CHUNK_SIZE,
    executor: Optional[str] = None,
) -> List[SimResult]:
    """Run every scenario; results in input order. The batched backend
    runs the columnar plan on ``device`` (default: the card; it raises
    without one) through the executor (``executor``); the event backend
    runs one event simulation a row on the host and takes no device; it
    runs the rows of each shared-fabric group in lockstep."""
    _check_backend(backend, device)
    if backend == "event":
        if any(sc.shared_fabric is not None for sc in scenarios):
            return run_event_coupled(scenarios)
        return [build_simulation(sc).run() for sc in scenarios]
    dev = resolve_device(device)
    if not plan_supported(scenarios):
        raise ValueError("every scenario needs a built-in algorithm")
    t0 = time.perf_counter()
    plan = build_plan(scenarios)
    record_wall(stats, "ingest_s", time.perf_counter() - t0)
    return run_plan(
        plan, device=dev, fused_step=fused_step, waterfill_impl=waterfill_impl,
        stats=stats, chunk_size=chunk_size, executor=executor,
    )


def run_scenario(scenario: Scenario, backend: str = "event", device=None) -> SimResult:
    """One scenario on ``backend`` (the event simulation by default)."""
    return run_matrix([scenario], device=device, backend=backend)[0]


def run_built(
    builders: Sequence[Callable[[], Simulation]],
    names: Sequence[str],
    costs: Optional[Sequence[float]] = None,
    backend: str = "batch",
    device=None,
    chunk_size: int = CHUNK_SIZE,
    stats: Optional[SweepStats] = None,
    executor: Optional[str] = None,
) -> List[SimResult]:
    """Run lazily built Simulations: ``builders[i]`` is a zero-argument
    callable returning a fresh one (schedulers are stateful). On the
    batched backend rows run in the order and spans of :func:`run_plan`
    (by ``costs``, input order without); a chunk's Simulations are built
    only when it is, then ingested with :func:`from_simulations`, so
    memory holds a few chunks' queues (under the async executor the
    builds take the host turn, so no two builders ever run at once). This
    is the primitive the autotuner's
    rungs sweep through: their sketch file sets are not Scenarios. A
    custom scheduler (any controller class beside the built-in ones) runs
    its callbacks on the host (``SweepStats.post_row_replays`` counts the
    loop's stops for them)."""
    _check_backend(backend, device)
    if len(names) != len(builders):
        raise ValueError(f"{len(names)} names for {len(builders)} builders")
    if backend == "event":
        return [b().run() for b in builders]

    def ingest(part):
        return from_simulations([builders[i]() for i in part], [names[i] for i in part])

    return _run_chunks(
        len(builders), costs, ingest, device, "rounds", "kernel", stats, chunk_size,
        executor=executor,
    )


def run_simulations(
    sims: Sequence[Simulation],
    names: Optional[Sequence[str]] = None,
    backend: str = "batch",
    device=None,
    stats: Optional[SweepStats] = None,
    executor: Optional[str] = None,
) -> List[SimResult]:
    """Run prebuilt, not yet started Simulations (sweeps that do not fit
    the Scenario grid, or whose scheduler is a custom class), in input
    order. The batched backend leaves the Simulations unstarted; the event
    backend runs them."""
    if names is None:
        names = [f"scenario{i}" for i in range(len(sims))]
    return run_built(
        [(lambda sim=sim: sim) for sim in sims], names, backend=backend,
        device=device, stats=stats, executor=executor,
    )


def build_matrix(name: str) -> List[Scenario]:
    if name == "default":
        return default_matrix()
    if name == "smoke":
        return smoke_matrix()
    if name == "full":
        return full_matrix()
    if name == "tenant":
        return tenant_matrix()
    if name == "tenant-smoke":
        return tenant_matrix(n_groups=6)
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


def save_golden(path: str, snapshot: Dict[str, Dict[str, float]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=1, sort_keys=True)
        f.write("\n")


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


def run_tune(args, scenarios: Sequence[Scenario]) -> int:
    """The ``--tune`` subcommand: search the static knob space over the
    matrix, then print every heuristic's regret against the result, the
    search's wall time and its sweep counts."""
    from . import tune

    history = tune.HistoryStore(args.history) if args.history else None
    searchers = {
        "oracle": tune.oracle_search,
        "sha": tune.successive_halving,
        "hill": tune.hill_climb,
    }
    device = args.device if args.backend == "batch" else None
    stats = SweepStats()
    t0 = time.perf_counter()
    result = searchers[args.tune](
        scenarios, backend=args.backend, device=device,
        n_candidates=args.candidates, history=history, stats=stats, executor=args.executor,
    )
    search_s = time.perf_counter() - t0
    heuristics = run_matrix(scenarios, device=device, backend=args.backend,
                            executor=args.executor)
    report = tune.regret_report(scenarios, heuristics, result)
    print(
        f"tune[{args.tune}]: {len(scenarios)} scenarios, {len(result.tables)} contexts, "
        f"{result.evals} candidate evaluations "
        f"({result.equivalent_evals:.1f} full-fidelity-equivalent)"
    )
    print(
        f"search on {args.backend} ({device or 'host'}): {search_s:.3f}s wall, "
        f"{stats.ingest_s:.3f}s plan ingest; {stats.sweeps} host rounds, "
        f"{stats.steps} row steps, {stats.host_syncs} host syncs, "
        f"{stats.host_transitions} host transitions"
    )
    if args.verbose:
        print(wall_breakdown(stats))
    print(f"regret = heuristic_throughput / {args.tune}_throughput:")
    print(report.format_table())
    if history is not None:
        history.save()
        print(f"warm-start history ({len(history)} winners) -> {args.history}")
    if args.regret_out:
        tune.save_report(args.regret_out, report, result)
        print(f"regret report -> {args.regret_out}")
    return 0


def wall_breakdown(stats: SweepStats) -> str:
    """The ``--verbose`` line: the host thread-seconds of the plan build
    and of each chunk phase, with their shares (under the async executor
    the phases overlap, so they may sum to more than the wall)."""
    spans = {"ingest": stats.ingest_s, "build": stats.build_wall_s,
             "compute": stats.compute_wall_s, "download": stats.download_wall_s}
    total = max(sum(spans.values()), 1e-9)
    return "wall breakdown (thread-seconds, phases overlap): " + " | ".join(
        f"{k} {v:.3f}s ({100.0 * v / total:.1f}%)" for k, v in spans.items()
    )


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--matrix", choices=MATRIX_NAMES, default="default")
    ap.add_argument("--backend", choices=BACKENDS, default="batch")
    ap.add_argument("--device", default="cuda", help="the batched backend's device")
    ap.add_argument("--executor", choices=EXECUTOR_MODES, default=None,
                    help="chunk execution: 'serial' (the default: the plain loop) or 'async' "
                    "(the next chunk is built while the device runs the current one); also "
                    "REPRO_FABRIC_EXECUTOR")
    ap.add_argument("--verbose", action="store_true",
                    help="print the host's wall split: plan ingest, chunk build, compute "
                    "and device-to-host downloads")
    ap.add_argument("--out", default="tests/golden/eval_matrix.json")
    ap.add_argument("--refresh-golden", action="store_true",
                    help="write the snapshot to --out instead of comparing")
    ap.add_argument(
        "--tune", choices=("oracle", "sha", "hill"), default=None,
        help="search the static (pipelining, parallelism, concurrency) "
        "space over the matrix (exhaustive grid / successive halving / "
        "hill climbing) and report per-algorithm regret vs the result",
    )
    ap.add_argument("--candidates", type=int, default=64,
                    help="--tune: candidate-grid budget per scenario context")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="--tune: JSON warm-start store; read to seed the search, "
                    "updated with the winners afterwards")
    ap.add_argument("--regret-out", default=None, metavar="PATH",
                    help="--tune: write the regret report + search tables as JSON")
    args = ap.parse_args(argv)

    scenarios = build_matrix(args.matrix)
    if args.tune:
        return run_tune(args, scenarios)
    device = args.device if args.backend == "batch" else None
    stats = SweepStats()
    results = run_matrix(scenarios, device=device, stats=stats, backend=args.backend,
                         executor=args.executor)
    if args.verbose:
        print(wall_breakdown(stats))
    snap = metrics_snapshot(scenarios, results)
    if args.refresh_golden:
        save_golden(args.out, snap)
        print(f"wrote {len(snap)} scenario metrics to {args.out}")
        return 0
    devs = compare_golden(load_golden(args.out), snap)
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
