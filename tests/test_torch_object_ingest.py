"""The batched backend's object ingest: ``plan.from_simulations`` builds
the plan of prebuilt event Simulations (the autotuner's sketch rows are
not Scenarios), and ``runner.run_built`` / ``run_simulations`` run them on
the ``"batch"`` backend.

* Every smoke and default-grid scenario (none has an empty chunk): the
  object ingest of ``build_simulation(sc)`` equals the columnar
  ``build_plan([sc])`` column for column, bit for bit (``ROW_COLUMNS``,
  each row's ``qsizes`` slice, the names).
* Rows whose Simulation keeps empty chunks (which ``build_plan`` drops):
  through ``run_simulations(..., backend="batch")`` on the CPU they equal
  the event leg, moves exact and throughput within 1e-9 relative (the
  reference's limits for these cases).
* ``run_built`` on the batched backend: any chunk size and cost order give
  the same results, bit for bit, and they match the event leg.
* What the plan has no column for raises, naming the field.
* A custom controller (a subclass of a built-in class with no method of
  its own too) is a row of kind -1 with the reference's trivial flags and
  no t=0 layout (``tests/test_torch_custom_rows.py`` runs such rows).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core import testbeds
from repro_torch.core.baselines import UntunedScheduler
from repro_torch.core.schedulers import (
    Close,
    MultiChunkScheduler,
    ProActiveMultiChunkScheduler,
    Scheduler,
    SingleChunkScheduler,
)
from repro_torch.core.simulator import Simulation
from repro_torch.core.types import GB, MB, Chunk, ChunkType, FileSpec
from repro_torch.eval.fabric.driver import SweepStats
from repro_torch.eval.fabric.plan import ROW_COLUMNS, build_plan, from_simulations
from repro_torch.eval.runner import _cost_proxy, run_built, run_simulations
from repro_torch.eval.scenarios import build_simulation, default_matrix, smoke_matrix

GRIDS = {"smoke": smoke_matrix, "default": default_matrix}


def _row_slices(plan, k_rows):
    return [plan.qsizes[plan.qoff[0, k]: plan.qoff[0, k] + plan.qlen[0, k]].tolist()
            for k in range(k_rows)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_object_ingest_equals_the_columnar_plan(grid):
    checked = 0
    for sc in GRIDS[grid]():
        sim = build_simulation(sc)
        if any(len(st.chunk.files) == 0 for st in sim.states):
            continue
        got, want = from_simulations([sim], [sc.name]), build_plan([sc])
        assert got.K == want.K and got.names == want.names == [sc.name]
        assert got.sched_names == want.sched_names and got.chunk_names == want.chunk_names
        assert [n.name for n in got.networks] == [n.name for n in want.networks]
        for col in ROW_COLUMNS:
            a, b = getattr(got, col), getattr(want, col)
            assert a.dtype == b.dtype and a.shape == b.shape, (sc.name, col)
            np.testing.assert_array_equal(a, b, err_msg=f"{sc.name}: {col}")
        n = int(want.n_chunks[0])
        assert _row_slices(got, n) == _row_slices(want, n)
        checked += 1
    assert checked == len(GRIDS[grid]())


def _empty_classes_sim(scheduler_cls):
    """SMALL and HUGE with two empty size classes between them."""
    files = [FileSpec(f"s{i}", 4 * MB) for i in range(30)] + [
        FileSpec(f"h{i}", 8 * GB) for i in range(4)
    ]
    chunks = [
        Chunk(ctype=ChunkType.SMALL, files=files[:30]),
        Chunk(ctype=ChunkType.MEDIUM, files=[]),
        Chunk(ctype=ChunkType.LARGE, files=[]),
        Chunk(ctype=ChunkType.HUGE, files=files[30:]),
    ]
    sched = scheduler_cls(chunks, testbeds.XSEDE, 8)
    return Simulation(sched.chunks, testbeds.XSEDE, sched, tick_period=5.0)


@pytest.mark.parametrize(
    "cls", [SingleChunkScheduler, MultiChunkScheduler, ProActiveMultiChunkScheduler],
    ids=["sc", "mc", "promc"],
)
def test_empty_chunk_rows_run_on_the_batched_backend(cls):
    plan = from_simulations([_empty_classes_sim(cls)], ["empty"])
    assert plan.chunk_names == [("SMALL", "MEDIUM", "LARGE", "HUGE")]
    assert plan.qlen[0].tolist() == [30, 0, 0, 4]
    stats = SweepStats()
    got = run_simulations([_empty_classes_sim(cls)], ["empty"], device="cpu", stats=stats)[0]
    want = _empty_classes_sim(cls).run()
    assert stats.host_transitions == 0 and stats.ingest_s > 0
    assert got.n_moves == want.n_moves
    assert got.throughput == pytest.approx(want.throughput, rel=1e-9)
    assert got.total_bytes == want.total_bytes


def test_run_built_is_independent_of_chunking_and_matches_the_event_leg():
    scs = smoke_matrix()
    builders = [(lambda sc=sc: build_simulation(sc)) for sc in scs]
    names = [sc.name for sc in scs]
    costs = [_cost_proxy(sc) for sc in scs]
    whole = run_built(builders, names, costs, device="cpu")
    for size, cost in ((5, costs), (7, None)):
        parts = run_built(builders, names, cost, device="cpu", chunk_size=size)
        assert [(r.total_time, r.n_events, r.n_moves) for r in parts] == [
            (r.total_time, r.n_events, r.n_moves) for r in whole
        ]
    event = run_built(builders, names, costs, backend="event")
    for g, e in zip(whole, event):
        assert g.total_bytes == e.total_bytes
        assert g.throughput == pytest.approx(e.throughput, rel=1e-9)
    with pytest.raises(ValueError, match="names"):
        run_built(builders, names[:-1], device="cpu")


class _Closer(Scheduler):
    name = "closer"

    def initial_actions(self, view):
        return [Close(chunk=0, n=1)]


class _Custom(SingleChunkScheduler):
    pass


def _sim(cls, max_time=48 * 3600.0, **kw):
    chunks = [Chunk(ctype=ChunkType.ALL, files=[FileSpec("a", 4 * MB)])]
    sched = cls(chunks, testbeds.XSEDE, 4, **kw)
    return Simulation(sched.chunks, testbeds.XSEDE, sched, max_time=max_time)


@pytest.mark.parametrize(
    "make,exc,field",
    [
        (lambda: _sim(UntunedScheduler, max_time=3600.0), ValueError, "max_time"),
        (lambda: _sim(ProActiveMultiChunkScheduler, ratio=1.5), ValueError, "ratio"),
        (lambda: _sim(ProActiveMultiChunkScheduler, patience=1), ValueError, "patience"),
        (lambda: _sim(_Closer), ValueError, "initial action"),
    ],
    ids=["max_time", "ratio", "patience", "close_at_start"],
)
def test_object_ingest_refuses_what_the_plan_cannot_hold(make, exc, field):
    with pytest.raises(exc, match=field):
        from_simulations([make()])


def _tick_only(mod):
    """A controller class over a schedulers module's ``Scheduler`` with its
    own ``on_tick`` and no ``on_chunk_complete``."""
    return type("TickOnly", (mod.Scheduler,), {
        "name": "tick-only",
        "initial_actions": lambda self, view: [mod.Open(chunk=0, n=2)],
        "on_tick": lambda self, view: [],
    })


@pytest.mark.parametrize(
    "base,kw",
    [
        ("SingleChunkScheduler", {}),
        ("MultiChunkScheduler", {}),
        ("ProActiveMultiChunkScheduler", {"ratio": 1.5, "patience": 1}),
        ("Scheduler", {}),
    ],
    ids=["sc_subclass", "mc_subclass", "promc_subclass_own_ratio", "tick_only"],
)
def test_object_ingest_takes_custom_rows(base, kw):
    """A custom controller (a subclass of a built-in class with no method
    of its own too) is a row of kind -1 whose trivial flags follow its
    class's methods as the reference's class checks take them, with no t=0
    layout; the plan keeps its scheduler and chunks (a ProMC subclass its
    own ratio and patience); a built-in row beside it keeps its layout."""
    from repro.core import schedulers as ref_schedulers
    from repro.core.simulator import Simulation as RefSimulation
    from repro.core.types import Chunk as RefChunk
    from repro.core.types import ChunkType as RefChunkType
    from repro.core.types import FileSpec as RefFileSpec
    from repro.eval.fabric.driver import _ScenarioRuntime, _scheduler_kind
    from repro_torch.core import schedulers as port_schedulers

    def make(mod):
        if base == "Scheduler":
            return _tick_only(mod)
        return type("Custom", (getattr(mod, base),), {})

    sims = [_sim(make(port_schedulers), **kw), _sim(MultiChunkScheduler)]
    plan = from_simulations(sims, ["custom", "mc"])
    ref_chunks = [RefChunk(ctype=RefChunkType.ALL, files=[RefFileSpec("a", 4 * MB)])]
    from repro.core import testbeds as ref_testbeds

    ref_sched = make(ref_schedulers)(ref_chunks, ref_testbeds.XSEDE, 4, **kw)
    ref_rt = _ScenarioRuntime(0, "custom", RefSimulation(ref_sched.chunks, ref_testbeds.XSEDE,
                                                         ref_sched))
    assert plan.kind.tolist() == [_scheduler_kind(ref_sched), 3] == [-1, 3]
    assert (bool(plan.trivial_tick[0]), bool(plan.trivial_complete[0])) == (
        ref_rt.trivial_tick, ref_rt.trivial_complete)
    assert plan.open_n[0].tolist() == [0] * plan.K
    assert plan.open_n[1].sum() > 0
    assert plan.custom[0].scheduler is sims[0].scheduler and plan.custom[1] is None
    assert plan.custom[0].chunks == tuple(st.chunk for st in sims[0].states)
    # the chunks' concurrency sum
    assert plan.cap_need[0] == max(1, sum(st.chunk.params.concurrency for st in sims[0].states))
    assert plan.take([1, 0]).custom[1] is plan.custom[0]


def test_scenario_cost_proxy_equals_the_plans():
    """``runner._cost_proxy`` (what ``run_built``'s callers order rows by)
    computes the plan's own cost doubles, static candidate rows included,
    so both ingests cut the same chunks."""
    from repro_torch.eval.scenarios import expand_candidates

    scs = smoke_matrix()
    scs += expand_candidates(scs[:4], [(0, 1, 1), (8, 4, 16)])
    np.testing.assert_array_equal([_cost_proxy(sc) for sc in scs], build_plan(scs).cost_proxy())
