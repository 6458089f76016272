"""The whole device loop on the CPU: the loop kernel's plain version (every
row's steps, completions, handlers, ticks, ProMC moves, resume-stack feed
and timeline ring, until it is done) through the sweep's default
``"rounds"`` route.

* The ``"rounds"`` route (``fused_rounds_plain``) against the one-step
  ``"kernel"`` route, whose transitions the host's ``_post`` takes and
  which the reference's NumPy driver and the goldens hold: bit-identical
  results (times, events, moves, per-chunk bytes and times, timelines) on
  the smoke matrix, the compacting default-grid subset, rows with resume
  files, recording rows (whose rings also equal a chain of
  ``timeline_push`` calls), SC rows that open several waves and MC rows
  whose completions grant channels.
* The four cases of the reference's ``tests/test_zero_host_rounds.py``,
  built through the port's plan (the two empty-class cases through the
  object ingest ``from_simulations``, which keeps the empty chunks that
  ``build_plan`` drops): each runs with ``host_transitions == 0``
  and matches the port's event simulator: moves exact and throughput
  within 1e-9 relative (the reference's limits), events exact on the
  empty-class cases; on the two slow-pool cases the bisected water level
  takes 1 step more and 9 fewer than the event loop, and those counts are
  pinned (the loop kernel's own counts on an H100: the plain level sums in
  the kernel's order, ``waterfill_bisect.lane_sum``).
* Each capacity guard, with C or P shrunk below the need: the guard fires,
  the host takes those rows' transitions (growing the axis), the results
  do not change, and ``host_transitions`` counts the rows stopped.
* ``difftest --expect-zero-replays``: exit 0 on the smoke matrix, 1 when a
  guard fired.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import testbeds
from repro_torch.core.runner import prepare_chunks
from repro_torch.core.schedulers import (
    MultiChunkScheduler,
    ProActiveMultiChunkScheduler,
    SingleChunkScheduler,
)
from repro_torch.core.simulator import Simulation
from repro_torch.core.types import (
    GB,
    KB,
    MB,
    Chunk,
    ChunkType,
    DiskSpec,
    FileSpec,
    NetworkSpec,
    gbps,
)
from repro_torch.eval import difftest, runner
from repro_torch.eval import scenarios as scenario_mod
from repro_torch.eval.fabric import driver, kernels
from repro_torch.eval.fabric import transition as tr
from repro_torch.eval.fabric.driver import TorchFabricSimulation
from repro_torch.eval.fabric.plan import build_plan, from_simulations
from repro_torch.eval.scenarios import Scenario, default_matrix, full_matrix, smoke_matrix

#: slow shared pool: long-lived huge files and a dead-time-bound swarm, the
#: regime that drives repeated ProMC moves off still-busy channels
SLOW_POOL = NetworkSpec(
    name="slow-pool",
    bandwidth=gbps(2),
    rtt=60e-3,
    buffer_size=32 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(2),
        per_file_overhead=0.004,
        saturation_cc=8,
        contention=0.02,
        per_channel_rate=gbps(0.4),
    ),
    unhidden_overhead=0.055,
)

#: the file sets of the reference's cases, by dataset name
DATASETS = {
    "empty-classes": lambda: [FileSpec(f"s{i}", 4 * MB) for i in range(30)]
    + [FileSpec(f"h{i}", 8 * GB) for i in range(4)],
    "resume-stack": lambda: [FileSpec(f"a{i}", 512 * MB) for i in range(10)]
    + [FileSpec(f"b{i}", 128 * KB) for i in range(12000)],
    "order-tie": lambda: [FileSpec(f"a{i}", 512 * MB) for i in range(10)]
    + [FileSpec(f"b{i}", 256 * KB) for i in range(2000)],
}


@pytest.fixture
def registered(monkeypatch):
    """The cases' network and file sets in the port's registries."""
    monkeypatch.setitem(testbeds.TESTBEDS, SLOW_POOL.name, SLOW_POOL)
    for name, files in DATASETS.items():
        monkeypatch.setitem(scenario_mod.DATASET_BUILDERS, name, lambda seed, f=files: f())


def _identical(a, b):
    """Bit-identical results (per-chunk times may be NaN where a chunk never
    completed)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.total_time == y.total_time and x.n_events == y.n_events
        assert x.n_moves == y.n_moves and x.total_bytes == y.total_bytes
        assert x.per_chunk_bytes == y.per_chunk_bytes
        np.testing.assert_array_equal(
            list(x.per_chunk_time.values()), list(y.per_chunk_time.values())
        )
        assert x.timeline == y.timeline


def _routes(plan, setup=None, peak=False):
    """Results and drivers of the ``"kernel"`` and ``"rounds"`` routes on
    ``plan`` (held bit for bit to each other); ``setup(drv)`` adjusts a
    driver before its run. With ``peak`` (batches too narrow to compact)
    the one-step route's driver keeps the deepest resume stack it saw
    between sweeps (``peak_stack``)."""
    out, drivers = {}, {}
    for route in ("kernel", "rounds"):
        drv = drivers[route] = TorchFabricSimulation(plan, device="cpu", fused_step=route)
        if setup is not None:
            setup(drv)
        drv.rts = list(drv.rt)  # rows in plan order, with their archives after the run
        if peak and route == "kernel":
            drv.start()
            drv.peak_stack = 0
            while drv.step():
                drv.peak_stack = max(drv.peak_stack, int(drv.prepend_n.max()))
        out[route] = drv.run()
    _identical(out["rounds"], out["kernel"])
    return out, drivers


def _promc(ratio, patience):
    def setup(drv):
        drv.promc_ratio.fill_(ratio)
        drv.promc_patience.fill_(patience)
    return setup


# ---------------------------------------------------------------------- #
# the plain whole loop against the one-step route
# ---------------------------------------------------------------------- #


def _sc_rows():
    return [s for s in default_matrix() if s.algorithm == "sc"]


def _mc_rows():
    return [s for s in default_matrix() if s.algorithm == "mc"]


@pytest.mark.parametrize("case", ["smoke", "compacting", "sc_waves", "mc_grants"])
def test_plain_whole_loop_equals_the_kernel_route(case):
    """Bit-identical results; the whole loop takes each chunk's rows to
    their end in one host round (no row of these needs 2,048 steps)."""
    scs = {
        "smoke": smoke_matrix,
        "compacting": lambda: [
            dataclasses.replace(default_matrix()[i], record_timeline=i % 2 == 0)
            for i in range(0, 276, 3)
        ],
        "sc_waves": _sc_rows,
        "mc_grants": _mc_rows,
    }[case]()
    out, drivers = _routes(build_plan(scs))
    k, r = drivers["kernel"].stats, drivers["rounds"].stats
    assert r.sweeps == 1 < k.sweeps and r.host_transitions == 0
    assert r.steps == k.steps == sum(x.n_events for x in out["kernel"])
    if case == "sc_waves":  # rows that opened a second wave after a completion
        assert sum(len(x.per_chunk_time) > 1 for x in out["rounds"]) > 10
    if case == "mc_grants":  # completions that granted channels to laggards
        assert sum(x.n_moves > 0 for x in out["rounds"]) > 10


def test_plain_whole_loop_equals_the_kernel_route_with_resume_files(registered):
    """ProMC rows that move channels off busy ones: their remainders go on
    the LIFO resume stack and come back off it in the loop's feed."""
    scs = [
        Scenario(network=SLOW_POOL.name, dataset=d, algorithm="promc", max_cc=cc,
                 tick_period=1.0)
        for d, cc in (("resume-stack", 30), ("order-tie", 24))
    ]
    out, drivers = _routes(build_plan(scs), _promc(1.2, 1), peak=True)
    assert drivers["rounds"].stats.sweeps == 1
    assert all(x.n_moves > 10 for x in out["rounds"])
    assert drivers["kernel"].peak_stack > 1


def test_recording_rows_equal_a_chain_of_timeline_pushes(monkeypatch):
    """Rows recording a timeline into a ring of 16 samples (halved, stride
    doubled, many times over): the loop's rings equal the one-step route's,
    and each equals a chain of ``timeline_push`` calls over the samples the
    one-step route pushed for that row."""
    monkeypatch.setattr(driver, "TIMELINE_BUDGET", 16)
    scs = [dataclasses.replace(s, record_timeline=i % 2 == 0)
           for i, s in enumerate(default_matrix()[::7])]
    assert len(scs) <= driver.COMPACT_FLOOR  # rows keep their index
    samples = []
    real_push = kernels.timeline_push

    def logged(rec, t, rate, *ring):
        samples.append((rec.clone(), t.clone(), rate.clone()))
        return real_push(rec, t, rate, *ring)

    monkeypatch.setattr(kernels, "timeline_push", logged)
    out, drivers = _routes(build_plan(scs))
    names = ("tl_t", "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate")
    halved = 0
    for i, (rk, rr) in enumerate(zip(drivers["kernel"].rts, drivers["rounds"].rts)):
        for name in names:
            np.testing.assert_array_equal(rr.archive[name], rk.archive[name])
        if not scs[i].record_timeline:
            assert rr.archive["tl_seen"] == 0
            continue
        ring = (torch.zeros((1, 16), dtype=torch.float64), torch.zeros((1, 16), dtype=torch.float64),
                torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.float64),
                torch.zeros(1, dtype=torch.float64))
        for rec, t, rate in samples:
            if rec[i]:
                ring = real_push(rec[i: i + 1], t[i: i + 1], rate[i: i + 1], *ring)
        for name, want in zip(names, ring):
            np.testing.assert_array_equal(rr.archive[name], want[0].numpy())
        halved += int(rr.archive["tl_stride"]) > 1
    assert halved > 10
    assert all(len(x.timeline) > 0 for x, s in zip(out["rounds"], scs) if s.record_timeline)


# ---------------------------------------------------------------------- #
# the reference's zero-host-round cases, through the port's plan
# ---------------------------------------------------------------------- #


def _empty_classes_sim(scheduler_cls):
    """The reference's chunk list: SMALL and HUGE with two empty size
    classes between them, all four complete-able at t=0."""
    files = DATASETS["empty-classes"]()
    chunks = [
        Chunk(ctype=ChunkType.SMALL, files=files[:30]),
        Chunk(ctype=ChunkType.MEDIUM, files=[]),
        Chunk(ctype=ChunkType.LARGE, files=[]),
        Chunk(ctype=ChunkType.HUGE, files=files[30:]),
    ]
    sched = scheduler_cls(chunks, testbeds.XSEDE, 8)
    return Simulation(sched.chunks, testbeds.XSEDE, sched, tick_period=5.0)


def _zero_host_rounds_and_exact(plan, mk_sim, setup=None, events=0, peak=False):
    """The plan on the ``"rounds"`` route: no transition left to the host,
    equal to the ``"kernel"`` route, and to a fresh event simulation: moves
    exact, throughput within 1e-9, and events exact, or ``events`` more
    than the event leg's. The sweep's routes all take the bisected water
    level, whose rates part from the event loop's closed form in the last
    bits, so a row may take a few zero-length steps more or fewer (80 rows
    of the full grid do; the split route with the closed form takes the
    event leg's count on the order-tie case)."""
    out, drivers = _routes(plan, setup, peak)
    assert drivers["rounds"].stats.host_transitions == 0
    res = out["rounds"][0]
    ev = mk_sim().run()
    assert res.n_events == ev.n_events + events
    assert res.n_moves == ev.n_moves
    assert res.throughput == pytest.approx(ev.throughput, rel=1e-9)
    return res, ev, drivers


@pytest.mark.parametrize("scheduler", ["mc", "promc"])
def test_multi_chunk_same_sweep_completion(scheduler, registered):
    """Two chunks (the empty classes) complete in the first step; their
    handlers drain inside the loop, lowest chunk first."""
    cls = {"mc": MultiChunkScheduler, "promc": ProActiveMultiChunkScheduler}[scheduler]
    sc = Scenario(network=testbeds.XSEDE.name, dataset="empty-classes", algorithm=scheduler)
    completed = []
    real = tr.completions

    def counted(s, act):
        c, t = real(s, act)
        completed.append(int(c.sum(dim=-1).max()))
        return c, t

    plan = from_simulations([_empty_classes_sim(cls)], [sc.name])
    tr.completions = counted
    try:
        _zero_host_rounds_and_exact(plan, lambda: _empty_classes_sim(cls))
    finally:
        tr.completions = real
    assert max(completed) >= 2


def test_sc_open_wave_needs_no_growth(registered):
    """The SC empty-class cascade opens SMALL's 8-channel wave while HUGE's
    2 channels still run; the closed-form bound sizes C for both waves, so
    no guard fires."""
    sc = Scenario(network=testbeds.XSEDE.name, dataset="empty-classes", algorithm="sc")
    plan = from_simulations([_empty_classes_sim(SingleChunkScheduler)], [sc.name])
    assert int(plan.cap_need[0]) >= 10
    _, _, drivers = _zero_host_rounds_and_exact(
        plan, lambda: _empty_classes_sim(SingleChunkScheduler)
    )
    assert drivers["rounds"].C >= 10


def _slow_pool_sim(dataset, max_cc, ratio):
    files = DATASETS[dataset]()
    chunks = prepare_chunks(files, SLOW_POOL, 4, max_cc)
    sched = ProActiveMultiChunkScheduler(chunks, SLOW_POOL, max_cc, patience=1, ratio=ratio)
    return Simulation(sched.chunks, SLOW_POOL, sched, tick_period=1.0)


def _slow_pool_plan(dataset, max_cc):
    return build_plan([Scenario(network=SLOW_POOL.name, dataset=dataset, algorithm="promc",
                                max_cc=max_cc, tick_period=1.0)])


def test_resume_stack_overflow_stays_on_device(registered):
    """ProMC with patience 1 on the slow pool: each tick's move takes a busy
    huge-file channel, so the resume stack grows past 4 (the reference's old
    fixed depth); the plan's bound sizes P above the deepest stack."""
    plan = _slow_pool_plan("resume-stack", 30)
    _, _, drivers = _zero_host_rounds_and_exact(
        plan, lambda: _slow_pool_sim("resume-stack", 30, 1.2), _promc(1.2, 1), events=1,
        peak=True,
    )
    assert 4 < drivers["kernel"].peak_stack < drivers["rounds"].P


def test_channel_order_tie_regression(registered):
    """Moves into a channel-starved chunk leave idle channels with other
    residual dead times: the victim follows the event simulator's channel
    order (closes left-pack the columns)."""
    res, _, _ = _zero_host_rounds_and_exact(
        _slow_pool_plan("order-tie", 24), lambda: _slow_pool_sim("order-tie", 24, 1.01),
        _promc(1.01, 1), events=-9,
    )
    assert res.n_moves > 30


# ---------------------------------------------------------------------- #
# the capacity guards
# ---------------------------------------------------------------------- #


def _count_guard_stops(monkeypatch):
    """Count the rows each loop launch stopped at a guard."""
    stops = []
    real = driver.fused_rounds

    def counted(s, max_steps):
        out = real(s, max_steps)
        stops.append(int((s["act"] & (s["stop"] == tr.STOP_GUARD)).sum()))
        return out

    monkeypatch.setattr(driver, "fused_rounds", counted)
    return stops


def test_sc_guard_leaves_the_transition_to_the_host(registered, monkeypatch):
    """The SC cascade's plan with its channel bound cut to 1: C starts at 4,
    SMALL's wave does not fit beside HUGE's, the loop stops the row, and the
    host grows C and takes the transition. Results equal the unshrunk
    run's."""
    sc = Scenario(network=testbeds.XSEDE.name, dataset="empty-classes", algorithm="sc")
    full = from_simulations([_empty_classes_sim(SingleChunkScheduler)], [sc.name])
    want, _ = _routes(full)
    cut = dataclasses.replace(full, cap_need=np.array([1], dtype=np.int64))
    monkeypatch.setattr(driver, "PLAN_C_FLOOR", 1)
    stops = _count_guard_stops(monkeypatch)
    got, drivers = _routes(cut)
    assert drivers["rounds"].stats.host_transitions == sum(stops) >= 1
    assert drivers["rounds"].C >= 10
    _identical(got["rounds"], want["rounds"])


def test_stack_guard_leaves_the_transition_to_the_host(registered, monkeypatch):
    """The resume-stack row with its stack depth cut to 1: each tick that
    finds a full stack stops the row, and the host doubles P and takes the
    transition. Results equal the unshrunk run's."""
    plan = _slow_pool_plan("resume-stack", 30)
    full = TorchFabricSimulation(plan, device="cpu")
    _promc(1.2, 1)(full)
    want = {"rounds": full.run()}

    def shrink(drv):
        _promc(1.2, 1)(drv)
        drv.prepend_sizes = drv.prepend_sizes[..., :1].contiguous()
        drv.P = 1

    stops = _count_guard_stops(monkeypatch)
    got, drivers = _routes(plan, shrink)
    assert drivers["rounds"].stats.host_transitions == sum(stops) >= 3
    assert drivers["rounds"].P > 4
    _identical(got["rounds"], want["rounds"])


# ---------------------------------------------------------------------- #
# the difftest's --expect-zero-replays
# ---------------------------------------------------------------------- #


def test_difftest_expect_zero_replays_exit_code(registered, monkeypatch):
    """Exit 0 on the smoke matrix; exit 1 on the SC cascade row (its plan
    with the empty classes, the channel bound cut to 1) once a guard stops
    it."""
    argv = ["--smoke", "--device", "cpu", "--route", "rounds", "--expect-zero-replays"]
    assert difftest.main(argv) == 0
    sc = Scenario(network=testbeds.XSEDE.name, dataset="empty-classes", algorithm="sc")
    cut = dataclasses.replace(
        from_simulations([_empty_classes_sim(SingleChunkScheduler)], [sc.name]),
        cap_need=np.array([1], dtype=np.int64),
    )
    monkeypatch.setattr(driver, "PLAN_C_FLOOR", 1)
    monkeypatch.setattr(difftest, "build_matrix", lambda name: [sc])
    monkeypatch.setattr(runner, "build_plan", lambda scs: cut)
    assert difftest.main(argv) == 1


def test_full_grid_sample_needs_no_host_transition():
    """A seeded sample of the full grid (impaired and time-varying
    testbeds among its rows) on the loop's route: no guard fires."""
    full = full_matrix()
    pick = sorted(np.random.RandomState(0).choice(len(full), 48, replace=False).tolist())
    stats = driver.SweepStats()
    runner.run_matrix([full[i] for i in pick], device="cpu", stats=stats)
    assert stats.host_transitions == 0 and stats.steps > 0
