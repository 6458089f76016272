"""Differential testing: the batched sweep against the event simulator.

The sweep (:class:`repro_torch.eval.fabric.driver.TorchFabricSimulation`)
re-implements the event semantics with batched tensor code and CUDA
kernels; this harness is the contract that holds it to them. For each
scenario of a matrix it runs the event simulator
(:class:`repro_torch.core.simulator.Simulation`, a scalar loop on the
host) and the sweep on one route, and compares throughput (completion
time is 1:1 with it for a fixed byte count) under a relative tolerance:
the bar is 2% on every scenario, not on the average. In practice the
agreement is at the last bits: both execute the same event sequence.

The sweep's legs, each on the card unless ``--device cpu`` is given:

  - ``rounds``: the loop kernel, many steps a launch (the default route);
  - ``kernel``: the one-step fused kernel, a launch a sweep;
  - ``none``: every sweep split, with the bisected water-fill kernel;
  - ``none-closed`` (``--closed``): the split route with the sort-based
    closed-form water-fill.

::

    python -m repro_torch.eval.difftest --smoke --route all
    python -m repro_torch.eval.difftest --matrix full --device cpu --sample 64

Rows count their events too: where the sweep's water level (bisected, or
the closed form's sums) and the event loop's part in the last bits, a
row may take a step more or fewer, with its times equal to ~1e-16
(:func:`event_count_differences` lists such rows; they are not gated;
the reference's NumPy driver does the same).

``--expect-zero-replays`` fails the run unless every leg run through the
loop kernel (:data:`LOOP_LEGS`) left no transition to the host
(``SweepStats.host_transitions``, the rows a capacity guard stopped, and
``SweepStats.post_row_replays``, the custom-scheduler rows stopped at a
callback: the counterparts of the reference's parked-row replays; the
matrices hold built-in schedulers only).

Rows that are not Scenarios (prebuilt Simulations, custom-scheduler rows
among them) run through ``runner.run_simulations`` on both legs;
:func:`pair_results` and :func:`event_count_differences` take their names.

The shared-fabric matrices (``--matrix tenant``, ``tenant-smoke``) pair
the routes that take coupled rows, ``rounds`` (the coupled loop kernel)
and ``none``, with the coupled event leg (the group's Simulations in
lockstep); ``kernel`` has no coupled form and is left out there::

    python -m repro_torch.eval.difftest --matrix tenant-smoke --route all --device cpu
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.device import resolve_device

from .runner import MATRIX_NAMES, build_matrix, run_matrix
from .scenarios import Scenario

DEFAULT_RTOL = 0.02

#: the sweep's routes; ``"all"`` on the command line runs each
ROUTES = ("rounds", "kernel", "none")

#: the legs that run through the loop kernel
LOOP_LEGS = ("rounds",)

#: the routes that take rows of shared fabrics
COUPLED_ROUTES = ("rounds", "none")

#: leg name -> (fused_step, waterfill_impl) of the batched driver
SWEEP_LEGS: Dict[str, Tuple[str, str]] = {
    "rounds": ("rounds", "kernel"),
    "kernel": ("kernel", "kernel"),
    "none": ("none", "kernel"),
    "none-closed": ("none", "closed"),
}


@dataclasses.dataclass(frozen=True)
class DiffReport:
    scenario: str
    event_throughput: float  # reference leg
    batch_throughput: float  # leg under test
    event_time: float
    batch_time: float
    reference: str = "event"
    backend: str = "rounds"

    @property
    def rel_err(self) -> float:
        denom = max(abs(self.event_throughput), 1e-12)
        return abs(self.batch_throughput - self.event_throughput) / denom

    def ok(self, rtol: float = DEFAULT_RTOL) -> bool:
        return self.rel_err <= rtol


def run_leg(scenarios: Sequence[Scenario], leg: str, device=None, stats=None):
    """Results of one leg: ``"event"`` on the host, a sweep leg of
    :data:`SWEEP_LEGS` on ``device`` (default: the card; raises without
    one). ``stats``, a ``SweepStats``, accumulates a sweep leg's counts."""
    if leg == "event":
        return run_matrix(scenarios, backend="event")
    try:
        fused_step, waterfill_impl = SWEEP_LEGS[leg]
    except KeyError:
        raise ValueError(f"unknown leg {leg!r}; options: event, {', '.join(SWEEP_LEGS)}") from None
    return run_matrix(
        scenarios, device=device, fused_step=fused_step, waterfill_impl=waterfill_impl,
        stats=stats,
    )


def _name(row) -> str:
    """A row's name: a Scenario's, or the name given to a Simulation (a
    row of the object ingest, such as a custom-scheduler row)."""
    return row if isinstance(row, str) else row.name


def pair_results(
    scenarios: Sequence,
    ref_results,
    test_results,
    reference: str = "event",
    backend: str = "rounds",
) -> List[DiffReport]:
    """Pair two legs' already computed results into DiffReports. The rows
    are Scenarios or names (Simulations run through
    ``runner.run_simulations`` on both legs, custom-scheduler rows
    included)."""
    return [
        DiffReport(
            scenario=_name(sc),
            event_throughput=e.throughput,
            batch_throughput=b.throughput,
            event_time=e.total_time,
            batch_time=b.total_time,
            reference=reference,
            backend=backend,
        )
        for sc, e, b in zip(scenarios, ref_results, test_results)
    ]


def event_count_differences(
    scenarios: Sequence, ref_results, test_results
) -> List[Tuple[str, int, int]]:
    """``(scenario, reference events, tested events)`` of every row whose
    event counts differ (rows: Scenarios or names)."""
    return [
        (_name(sc), e.n_events, b.n_events)
        for sc, e, b in zip(scenarios, ref_results, test_results)
        if e.n_events != b.n_events
    ]


def diff_matrix(
    scenarios: Sequence[Scenario],
    backend: str = "rounds",
    reference: str = "event",
    device=None,
) -> List[DiffReport]:
    """Run the ``reference`` and ``backend`` legs over the matrix and pair
    the results."""
    ref = run_leg(scenarios, reference, device)
    test = run_leg(scenarios, backend, device)
    return pair_results(scenarios, ref, test, reference, backend)


def assert_agreement(reports: Sequence[DiffReport], rtol: float = DEFAULT_RTOL) -> None:
    """Raise with a readable table of every violator (not just the first)."""
    bad = [r for r in reports if not r.ok(rtol)]
    if not bad:
        return
    lines = [f"{len(bad)}/{len(reports)} scenarios exceed rtol={rtol:.3%}:"]
    for r in sorted(bad, key=lambda r: -r.rel_err)[:25]:
        lines.append(
            f"  {r.scenario}: {r.reference}={r.event_throughput:.4g} B/s "
            f"{r.backend}={r.batch_throughput:.4g} B/s rel_err={r.rel_err:.3%}"
        )
    raise AssertionError("\n".join(lines))


def diff_backend(
    scenarios: Sequence[Scenario],
    backend: str,
    rtol: float = DEFAULT_RTOL,
    device=None,
    results_cache: Optional[dict] = None,
    stats=None,
) -> List[DiffReport]:
    """Hold one sweep leg to the event leg. Each leg runs at most once:
    pass ``results_cache`` to share the runs across calls; the pairings
    reuse the results. ``stats`` accumulates the sweep leg's counts when
    it runs."""
    cache = results_cache if results_cache is not None else {}

    def results(leg: str):
        if leg not in cache:
            if stats is not None and leg == backend:
                cache[leg] = run_leg(scenarios, leg, device, stats=stats)
            else:
                cache[leg] = run_leg(scenarios, leg, device)
        return cache[leg]

    reports = pair_results(scenarios, results("event"), results(backend), "event", backend)
    assert_agreement(reports, rtol)
    return reports


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--route", choices=ROUTES + ("all",), default="rounds")
    ap.add_argument("--matrix", choices=MATRIX_NAMES, default="full")
    ap.add_argument("--smoke", action="store_true", help="shorthand for --matrix smoke")
    ap.add_argument(
        "--closed", action="store_true",
        help="also run the split route with the closed-form water-fill",
    )
    ap.add_argument("--device", default="cuda", help="the sweep's device (the event leg runs on the host)")
    ap.add_argument("--rtol", type=float, default=DEFAULT_RTOL)
    ap.add_argument(
        "--sample", type=int, default=None, metavar="N",
        help="a deterministic N-scenario subsample of the matrix (seeded shuffle)",
    )
    ap.add_argument("--sample-seed", type=int, default=0, help="seed for --sample")
    ap.add_argument(
        "--expect-zero-replays", action="store_true",
        help="fail unless every leg through the loop kernel left no transition to the host",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any leg runs

    matrix = "smoke" if args.smoke else args.matrix
    scenarios = build_matrix(matrix)
    if args.sample is not None and args.sample < len(scenarios):
        import random

        scenarios = random.Random(args.sample_seed).sample(scenarios, args.sample)
        matrix = f"{matrix}[sample {args.sample}]"
    legs = list(ROUTES if args.route == "all" else (args.route,))
    if any(sc.shared_fabric is not None for sc in scenarios) and "kernel" in legs:
        print(f"route kernel has no coupled form: not run on matrix {matrix}, whose rows "
              f"share fabrics (coupled routes: {', '.join(COUPLED_ROUTES)})")
        legs.remove("kernel")
    if args.closed:
        legs.append("none-closed")

    cache: dict = {}
    t0 = time.perf_counter()
    cache["event"] = run_leg(scenarios, "event")
    event_s = time.perf_counter() - t0
    print(
        f"event leg: {len(scenarios)} scenarios, "
        f"{sum(r.n_events for r in cache['event'])} events in {event_s:.3f}s on the host"
    )
    from .fabric.driver import SweepStats

    failed = []
    for leg in legs:
        stats = SweepStats() if args.expect_zero_replays and leg in LOOP_LEGS else None
        reports = diff_backend(
            scenarios, leg, rtol=args.rtol, device=device, results_cache=cache, stats=stats
        )
        worst = max((r.rel_err for r in reports), default=0.0)
        differ = event_count_differences(scenarios, cache["event"], cache[leg])
        print(
            f"difftest OK: route={leg} matrix={matrix} "
            f"({len(scenarios)} scenarios, worst rel_err {worst:.3e}; "
            f"{len(differ)} rows count other events)"
        )
        for name, n_ref, n_leg in differ[:20]:
            print(f"  events {name}: event={n_ref} {leg}={n_leg}")
        if stats is not None:
            print(f"  host transitions (rows a capacity guard stopped): {stats.host_transitions}; "
                  f"post-row replays (custom rows stopped at a callback): "
                  f"{stats.post_row_replays}")
            if stats.host_transitions or stats.post_row_replays:
                failed.append(leg)
    if failed:
        print(f"difftest FAILED: --expect-zero-replays, host transitions on {failed}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
