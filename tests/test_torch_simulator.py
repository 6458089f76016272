"""The port's event simulator, its scheduler facade and the scalar model
it runs, held to the reference implementation (``repro.core``, which
imports no JAX) on the same inputs.

Limits: event and move counts, chunk names and byte totals exact; times,
throughput and per-chunk bytes within 1e-12 relative (the two execute the
same float64 operations in the same order, so they agree bit for bit);
scheduler actions, Algorithm-1 parameters, partitions and allocations
equal; the scalar rate model equal to the reference's. The scalar model
is also held to the sweep's own plan columns (equal) and fluid kernels
(equal, the rate pool within one ulp, the water-fill within 1e-12).
"""
from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import baselines as r_base
from repro.core import chunking as r_chunking
from repro.core import netmodel as r_net
from repro.core import params as r_params
from repro.core import runner as r_runner
from repro.core import schedulers as r_sched
from repro.core import simulator as r_sim
from repro.core import testbeds as r_testbeds
from repro.core import types as r_types
from repro.data import filesets as r_files
from repro.eval import scenarios as r_scen
from repro.eval.fabric import reference as r_ref
from repro_torch.core import baselines as p_base
from repro_torch.core import chunking as p_chunking
from repro_torch.core import netmodel as p_net
from repro_torch.core import params as p_params
from repro_torch.core import runner as p_runner
from repro_torch.core import schedulers as p_sched
from repro_torch.core import simulator as p_sim
from repro_torch.core import testbeds as p_testbeds
from repro_torch.core import types as p_types
from repro_torch.data import filesets as p_files
from repro_torch.eval import scenarios as p_scen
from repro_torch.eval.fabric import reference as p_ref

RTOL = 1e-12
FULL_SAMPLE = 128


def _rel(a, b):
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _same_result(port, ref, name):
    assert port.network == ref.network, name
    assert port.scheduler == ref.scheduler, name
    assert port.n_events == ref.n_events, name
    assert port.n_moves == ref.n_moves, name
    assert port.total_bytes == ref.total_bytes, name
    assert list(port.per_chunk_time) == list(ref.per_chunk_time), name
    assert list(port.per_chunk_bytes) == list(ref.per_chunk_bytes), name
    worst = max(
        [_rel(port.total_time, ref.total_time), _rel(port.throughput, ref.throughput)]
        + [_rel(port.per_chunk_time[c], ref.per_chunk_time[c]) for c in ref.per_chunk_time]
        + [_rel(port.per_chunk_bytes[c], ref.per_chunk_bytes[c]) for c in ref.per_chunk_bytes]
    )
    assert worst <= RTOL, (name, worst)
    return worst


def _full_sample():
    rows = list(zip(p_scen.full_matrix(), r_scen.full_matrix()))
    return random.Random(0).sample(rows, FULL_SAMPLE)


def _groups():
    smoke = list(zip(p_scen.smoke_matrix(), r_scen.smoke_matrix()))
    default = list(zip(p_scen.default_matrix(), r_scen.default_matrix()))
    out = [("smoke", smoke)]
    for net in p_scen.NETWORKS:
        out.append((f"default[{net}]", [(p, r) for p, r in default if p.network == net]))
    out.append((f"full[sample {FULL_SAMPLE}]", _full_sample()))
    return out


GROUPS = _groups()


def test_groups_cover_the_smoke_and_default_matrices():
    assert sum(len(rows) for _, rows in GROUPS) == 32 + 276 + FULL_SAMPLE
    for _, rows in GROUPS:
        assert all(p.name == r.name for p, r in rows)


@pytest.mark.parametrize("label,rows", GROUPS, ids=[g[0] for g in GROUPS])
def test_event_simulator_matches_the_reference(label, rows):
    worst = 0.0
    for psc, rsc in rows:
        port = p_scen.build_simulation(psc).run()
        ref = r_scen.build_simulation(rsc).run()
        worst = max(worst, _same_result(port, ref, psc.name))
    print(f"{label}: {len(rows)} rows, worst relative difference {worst:.3g}")


def test_timelines_match_the_reference_on_recording_rows():
    for sc in p_scen.smoke_matrix():
        psc = dataclasses.replace(sc, record_timeline=True)
        assert psc.name.endswith("|tl")
        rsc = next(r for r in r_scen.smoke_matrix() if r.name == sc.name)
        rsc = dataclasses.replace(rsc, record_timeline=True)
        port = p_scen.build_simulation(psc).run()
        ref = r_scen.build_simulation(rsc).run()
        _same_result(port, ref, psc.name)
        assert len(port.timeline) == len(ref.timeline) == port.n_events
        assert [t for t, _ in port.timeline] == [t for t, _ in ref.timeline]
        for (_, a), (_, b) in zip(port.timeline, ref.timeline):
            assert _rel(a, b) <= RTOL


def test_the_event_leg_matches_the_default_golden():
    from pathlib import Path

    from repro_torch.eval.runner import compare_golden, load_golden, metrics_snapshot, run_matrix

    scs = p_scen.default_matrix()
    golden = load_golden(str(Path(__file__).resolve().parent / "golden" / "eval_matrix.json"))
    assert compare_golden(golden, metrics_snapshot(scs, run_matrix(scs, backend="event"))) == []


@pytest.mark.parametrize("algorithm", ["sc", "mc", "promc", "globus", "untuned", "static"])
def test_run_transfer_matches_the_reference(algorithm):
    kw = {"static_params": (4, 2, 3)} if algorithm == "static" else {}
    files_p = p_files.mixed_dataset(scale=0.004, seed=3)
    files_r = r_files.mixed_dataset(scale=0.004, seed=3)
    for net in ("xsede-lonestar-gordon", "steppy-backbone"):
        port = p_runner.run_transfer(
            files_p, p_testbeds.TESTBEDS[net], algorithm, num_chunks=3, record_timeline=True, **kw
        )
        ref = r_runner.run_transfer(
            files_r, r_testbeds.TESTBEDS[net], algorithm, num_chunks=3, record_timeline=True, **kw
        )
        _same_result(port, ref, f"{net}|{algorithm}")


def test_globus_connect_personal_matches_the_reference():
    files = p_files.uniform_files(30, 64 * p_types.MB)
    lan = "didclab-lan-glusterfs"
    port = p_runner.run_transfer(files, p_testbeds.TESTBEDS[lan], "globus", connect_personal=True)
    ref = r_runner.run_transfer(
        r_files.uniform_files(30, 64 * r_types.MB), r_testbeds.TESTBEDS[lan], "globus",
        connect_personal=True,
    )
    assert port.network == ref.network == lan + "+gcp"
    _same_result(port, ref, "gcp")
    degraded = p_base.degrade_for_connect_personal(p_testbeds.LAN)
    r_degraded = r_base.degrade_for_connect_personal(r_testbeds.LAN)
    for f in ("buffer_size", "unhidden_overhead", "max_streams_per_channel", "name"):
        assert getattr(degraded, f) == getattr(r_degraded, f)


@pytest.mark.parametrize("algorithm", ["mc", "promc", "sc"])
def test_stepping_under_a_granted_pool_matches_the_reference(algorithm):
    """``step(max_dt, bandwidth)``, ``next_dt`` and ``transfer_demand`` (the
    hooks a coupled driver uses) against the reference, step by step, with
    a seeded pool below the link's and a seeded cap on each horizon."""
    rng = np.random.RandomState(7)
    sims = []
    for scen in (p_scen, r_scen):
        sc = next(s for s in scen.full_matrix() if s.network == "steppy-backbone"
                  and s.dataset == "mixed" and s.algorithm == algorithm)
        sims.append(scen.build_simulation(sc))
    port, ref = sims
    port.start()
    ref.start()
    while not ref.done:
        assert not port.done
        grant = float(rng.uniform(0.2, 1.0)) * ref.network.bandwidth_at(ref.t)
        assert port.transfer_demand() == ref.transfer_demand()
        assert port.next_dt() == ref.next_dt()
        assert port.next_dt(grant) == ref.next_dt(grant)
        cap = float(rng.uniform(0.1, 3.0))
        port.step(max_dt=cap, bandwidth=grant)
        ref.step(max_dt=cap, bandwidth=grant)
        assert (port.t, port.n_events, port.n_moves) == (ref.t, ref.n_events, ref.n_moves)
    assert port.done
    _same_result(port.result(), ref.result(), algorithm)


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------


def _errors(mod_sim, mod_sched, mod_runner, testbeds, types):
    files = [types.FileSpec(f"f{i}", 50 * types.MB) for i in range(20)]
    net = testbeds.TESTBEDS["xsede-lonestar-gordon"]
    out = {}
    sched = mod_runner.build_scheduler("mc", files, net, max_cc=4)
    sim = mod_sim.Simulation(sched.chunks, net, sched, max_time=0.5)
    with pytest.raises(RuntimeError) as exc:
        sim.run()
    out["max_time"] = str(exc.value)

    class Idle(mod_sched.Scheduler):
        name = "Idle"

        def initial_actions(self, view):
            return []

    chunks = mod_runner.prepare_chunks(files, net, 2, 4)
    sim = mod_sim.Simulation(chunks, net, Idle(chunks, net, 4))
    with pytest.raises(RuntimeError) as exc:
        sim.run()
    out["stranded"] = str(exc.value)
    sim = mod_sim.Simulation(chunks, net, Idle(chunks, net, 4))
    for call in (sim.step, sim.result):
        with pytest.raises(RuntimeError) as exc:
            call()
        out[call.__name__] = str(exc.value)
    with pytest.raises(ValueError) as exc:
        mod_sched.make_scheduler("fifo", chunks, net, 4)
    out["unknown"] = str(exc.value)
    with pytest.raises(ValueError) as exc:
        mod_runner.build_scheduler("static", files, net)
    out["static"] = str(exc.value)
    return out


def test_errors_raise_as_in_the_reference():
    port = _errors(p_sim, p_sched, p_runner, p_testbeds, p_types)
    ref = _errors(r_sim, r_sched, r_runner, r_testbeds, r_types)
    assert port == ref
    assert "exceeded max_time=0.5s" in port["max_time"]
    assert "stranded chunks" in port["stranded"]


# --------------------------------------------------------------------------
# schedulers: the same actions on the same views
# --------------------------------------------------------------------------


def _dataset(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(3, 40))
    sizes = np.exp(rng.uniform(np.log(1e3), np.log(8e9), size=n)).astype(np.int64)
    return [int(s) for s in sizes]


def _chunks_both(sizes, net, num_chunks, max_cc):
    p = p_runner.prepare_chunks(
        [p_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)],
        p_testbeds.TESTBEDS[net], num_chunks, max_cc,
    )
    r = r_runner.prepare_chunks(
        [r_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)],
        r_testbeds.TESTBEDS[net], num_chunks, max_cc,
    )
    return p, r


def _random_views(rng, chunks, max_cc):
    """(port views, reference views) of one seeded random state, ties and
    infinite ETAs included."""
    pv, rv = [], []
    for i, c in enumerate(chunks):
        done = bool(rng.rand() < 0.2)
        left = 0.0 if done else float(rng.choice([0.0, rng.uniform(1, 1e10), 1e9]))
        thr = float(rng.choice([0.0, rng.uniform(1e6, 1e9), 5e8]))
        pred = float(rng.choice([0.0, rng.uniform(1e6, 1e9)]))
        n_ch = int(rng.randint(0, max_cc + 2))
        fields = dict(index=i, ctype=c.ctype, bytes_remaining=left, files_remaining=int(left > 0),
                      throughput=thr, n_channels=n_ch, done=done, predicted_rate=pred)
        pv.append(p_sched.ChunkView(**fields))
        rv.append(r_sched.ChunkView(**fields))
    return pv, rv


def _as_tuples(actions):
    return [(type(a).__name__, dataclasses.astuple(a)) for a in actions]


NETS = ["xsede-lonestar-gordon", "didclab-lan-glusterfs", "supermic-bridges", "lossy-transatlantic"]


@pytest.mark.parametrize("name", ["sc", "mc", "promc"])
@pytest.mark.parametrize("seed", range(6))
def test_scheduler_actions_match_the_reference(name, seed):
    rng = np.random.RandomState(100 + seed)
    net = NETS[seed % len(NETS)]
    max_cc = int(rng.choice([1, 2, 4, 8, 16]))
    pch, rch = _chunks_both(_dataset(seed), net, int(rng.randint(1, 5)), max_cc)
    ps = p_sched.make_scheduler(name, pch, p_testbeds.TESTBEDS[net], max_cc)
    rs = r_sched.make_scheduler(name, rch, r_testbeds.TESTBEDS[net], max_cc)
    assert [c.params for c in ps.chunks] == [
        p_types.TransferParams(*dataclasses.astuple(c.params)) for c in rs.chunks
    ]
    pv, rv = _random_views(rng, pch, max_cc)
    assert _as_tuples(ps.initial_actions(pv)) == _as_tuples(rs.initial_actions(rv))
    for _ in range(40):
        pv, rv = _random_views(rng, pch, max_cc)
        assert [v.eta for v in pv] == [v.eta for v in rv]
        if rng.rand() < 0.8:
            assert _as_tuples(ps.on_tick(pv)) == _as_tuples(rs.on_tick(rv))
        else:
            cid = int(rng.randint(len(pv)))
            assert _as_tuples(ps.on_chunk_complete(pv, cid)) == _as_tuples(
                rs.on_chunk_complete(rv, cid)
            )
        if name == "promc":
            assert (ps._streak, ps._streak_pair) == (rs._streak, rs._streak_pair)


def test_promc_streak_fires_as_in_the_reference():
    """A balanced-then-imbalanced tick sequence: the streak builds over
    ``patience`` periods, fires one Move and resets."""
    pch, rch = _chunks_both([10_000] * 30 + [5 * 10**9] * 4, "xsede-lonestar-gordon", 4, 8)
    ps = p_sched.ProActiveMultiChunkScheduler(pch, p_testbeds.XSEDE, 8)
    rs = r_sched.ProActiveMultiChunkScheduler(rch, r_testbeds.XSEDE, 8)
    seq = [(1e9, 1e9), (1e9, 1e7), (1e9, 1e7), (1e9, 1e7), (1e9, 1e7), (1e9, 0.0)]
    fired = 0
    for thr0, thr1 in seq:
        views = []
        for mod in (p_sched, r_sched):
            views.append([
                mod.ChunkView(0, pch[0].ctype, 1e10, 5, thr0, 4, False),
                mod.ChunkView(1, pch[1].ctype, 1e10, 5, thr1, 4, False),
            ])
        a, b = ps.on_tick(views[0]), rs.on_tick(views[1])
        assert _as_tuples(a) == _as_tuples(b)
        assert (ps._streak, ps._streak_pair) == (rs._streak, rs._streak_pair)
        fired += len(a)
    assert fired == 1


def test_laggard_discount_is_float64():
    """Two grants: the first goes to chunk 1 (ETA 3), whose ETA becomes
    3 * 2/3 = 2.0 exactly in float64 and ties chunk 0, which then wins on
    its lower index. A float32 factor (2/3 rounded up) kept the second
    grant on chunk 1."""
    def views(mod):
        return [
            mod.ChunkView(0, p_types.ChunkType.SMALL, 2.0, 1, 1.0, 2, False),
            mod.ChunkView(1, p_types.ChunkType.LARGE, 3.0, 1, 1.0, 2, False),
            mod.ChunkView(2, p_types.ChunkType.HUGE, 0.0, 0, 0.0, 2, True),
        ]

    port = p_sched.Scheduler.distribute_to_laggards(views(p_sched), 2, 2)
    ref = r_sched.Scheduler.distribute_to_laggards(views(r_sched), 2, 2)
    assert _as_tuples(port) == _as_tuples(ref)
    assert _as_tuples(port) == [("Move", (2, 1, 1)), ("Move", (2, 0, 1))]


@pytest.mark.parametrize("name", ["globus", "untuned", "static"])
def test_static_schedulers_match_the_reference(name):
    for seed in range(4):
        sizes = _dataset(seed)
        net = NETS[seed]
        kw = {"static_params": (seed, 1 + seed, 2 + seed)} if name == "static" else {}
        ps = p_runner.build_scheduler(
            name, [p_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)],
            p_testbeds.TESTBEDS[net], max_cc=8, **kw,
        )
        rs = r_runner.build_scheduler(
            name, [r_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)],
            r_testbeds.TESTBEDS[net], max_cc=8, **kw,
        )
        assert ps.name == rs.name
        assert dataclasses.astuple(ps.params) == dataclasses.astuple(rs.params)
        assert [len(c) for c in ps.chunks] == [len(c) for c in rs.chunks] == [len(sizes)]
        pv = [p_sched.ChunkView(0, p_types.ChunkType.ALL, 1.0, 1, 0.0, 0, False)]
        rv = [r_sched.ChunkView(0, r_types.ChunkType.ALL, 1.0, 1, 0.0, 0, False)]
        assert _as_tuples(ps.initial_actions(pv)) == _as_tuples(rs.initial_actions(rv))
        assert ps.on_tick(pv) == rs.on_tick(rv) == []
        assert p_base.globus_class(sum(sizes) / len(sizes)) == r_base.globus_class(
            sum(sizes) / len(sizes)
        )


_CTYPES = st.sampled_from(list(p_types.ChunkType))


@settings(max_examples=150, deadline=None)
@given(
    st.lists(st.tuples(_CTYPES, st.integers(0, 6), st.integers(1, 10**10)), min_size=0, max_size=5),
    st.integers(1, 40),
)
def test_distributions_match_the_reference(spec, max_cc):
    pch = [p_types.Chunk(ct, [p_types.FileSpec("f", sz)] * n) for ct, n, sz in spec]
    rch = [r_types.Chunk(r_types.ChunkType(int(ct)), [r_types.FileSpec("f", sz)] * n)
           for ct, n, sz in spec]
    for pf, rf in ((p_sched.round_robin_distribution, r_sched.round_robin_distribution),
                   (p_sched.weighted_distribution, r_sched.weighted_distribution)):
        a, b = pf(pch, max_cc), rf(rch, max_cc)
        assert list(a.items()) == list(b.items())


# --------------------------------------------------------------------------
# the scalar model
# --------------------------------------------------------------------------


_SIZES = st.lists(st.integers(0, 2 * 10**10), min_size=0, max_size=60)


@settings(max_examples=120, deadline=None)
@given(_SIZES, st.sampled_from(sorted(p_testbeds.TESTBEDS)), st.integers(1, 4), st.integers(1, 64))
def test_partition_and_algorithm1_match_the_reference(sizes, net, num_chunks, max_cc):
    pf = [p_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)]
    rf = [r_types.FileSpec(f"f{i}", s) for i, s in enumerate(sizes)]
    thr = p_chunking.size_thresholds(p_testbeds.TESTBEDS[net].bandwidth, num_chunks)
    for s in sizes:
        assert p_chunking.classify(s, thr) == r_chunking.classify(s, thr)
    pch = p_chunking.partition_files(pf, p_testbeds.TESTBEDS[net], num_chunks)
    rch = r_chunking.partition_files(rf, r_testbeds.TESTBEDS[net], num_chunks)
    assert [(int(c.ctype), [f.size for f in c.files]) for c in pch] == [
        (int(c.ctype), [f.size for f in c.files]) for c in rch
    ]
    for pc, rc in zip(pch, rch):
        assert (pc.name, len(pc), pc.total_bytes, pc.avg_file_size) == (
            rc.name, len(rc), rc.total_bytes, rc.avg_file_size)
        p_params.assign_chunk_params(pc, p_testbeds.TESTBEDS[net], max_cc)
        r_params.assign_chunk_params(rc, r_testbeds.TESTBEDS[net], max_cc)
        assert dataclasses.astuple(pc.params) == dataclasses.astuple(rc.params)
    assert p_types.dataset_total(pf) == r_types.dataset_total(rf)


@settings(max_examples=150, deadline=None)
@given(
    st.floats(1.0, 1e11), st.floats(0.0, 1e10), st.floats(1.0, 1e9), st.integers(1, 64),
    st.one_of(st.none(), st.integers(1, 10**5)),
)
def test_find_optimal_parameters_matches_the_reference(avg, bdp, buf, max_cc, n):
    a = p_params.find_optimal_parameters(avg, bdp, buf, max_cc, n)
    b = r_params.find_optimal_parameters(avg, bdp, buf, max_cc, n)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_find_optimal_parameters_rejects_what_the_reference_rejects():
    for args in ((0.0, 1.0, 1.0, 2), (1.0, 1.0, 1.0, 0)):
        with pytest.raises(ValueError) as pe:
            p_params.find_optimal_parameters(*args)
        with pytest.raises(ValueError) as re_:
            r_params.find_optimal_parameters(*args)
        assert str(pe.value) == str(re_.value)


_RATE = st.floats(0.0, 1e10, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(st.lists(_RATE, min_size=0, max_size=24), st.floats(-1.0, 5e10))
def test_waterfill_matches_the_reference(caps, pool):
    assert p_net.waterfill(caps, pool) == r_net.waterfill(caps, pool)


@settings(max_examples=150, deadline=None)
@given(
    st.sampled_from(sorted(p_testbeds.TESTBEDS)),
    st.lists(st.tuples(st.integers(1, 80), st.booleans()), min_size=0, max_size=24),
    st.one_of(st.none(), st.floats(0.0, 5e9)),
    st.floats(0.0, 200.0),
)
def test_allocate_rates_and_the_path_match_the_reference(net, chans, bandwidth, t):
    pn, rn = p_testbeds.TESTBEDS[net], r_testbeds.TESTBEDS[net]
    par = [p for p, _ in chans]
    act = [a for _, a in chans]
    assert p_net.allocate_rates(pn, par, act, bandwidth) == r_net.allocate_rates(rn, par, act, bandwidth)
    assert p_net.allocate_rates(pn, par) == r_net.allocate_rates(rn, par)
    assert pn.bandwidth_at(t) == rn.bandwidth_at(t)
    assert pn.next_profile_change(t) == rn.next_profile_change(t)
    for n in range(-1, 30):
        assert pn.disk.aggregate_rate(n) == rn.disk.aggregate_rate(n)


@settings(max_examples=150, deadline=None)
@given(
    st.sampled_from(sorted(p_testbeds.TESTBEDS)), st.integers(0, 5000), st.integers(1, 80),
    st.integers(0, 5000), st.integers(1, 80), st.floats(0.0, 1e11), st.integers(-1, 40),
    st.one_of(st.none(), st.integers(0, 60)),
)
def test_channel_costs_and_predictions_match_the_reference(net, pp, par, pp2, par2, avg, n_ch, total):
    pn, rn = p_testbeds.TESTBEDS[net], r_testbeds.TESTBEDS[net]
    a, a2 = p_types.TransferParams(pp, par, 1), p_types.TransferParams(pp2, par2, 1)
    b, b2 = r_types.TransferParams(pp, par, 1), r_types.TransferParams(pp2, par2, 1)
    assert p_net.control_gap(pn, a) == r_net.control_gap(rn, b)
    assert p_net.file_start_dead_time(pn, a) == r_net.file_start_dead_time(rn, b)
    assert p_net.channel_open_cost(pn, a) == r_net.channel_open_cost(rn, b)
    assert p_net.channel_open_cost(pn, a, a2) == r_net.channel_open_cost(rn, b, b2)
    assert p_net.predict_chunk_rate(pn, avg, a, n_ch, total) == r_net.predict_chunk_rate(
        rn, avg, b, n_ch, total
    )


@settings(max_examples=200, deadline=None)
@given(
    st.floats(0.0, 100.0),
    st.lists(st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 1e10), _RATE), max_size=16),
    st.floats(0.0, 1e12), st.floats(0.0, 1e12), st.floats(1e-3, 30.0),
)
def test_stepping_hooks_match_the_reference(to_tick, chans, prev, delta, period):
    deads = [d if i % 3 else 0.0 for i, (d, _, _) in enumerate(chans)]
    rems = [r for _, r, _ in chans]
    rates = [r for _, _, r in chans]
    assert p_ref.next_event_dt(to_tick, deads, rems, rates) == r_ref.next_event_dt(
        to_tick, deads, rems, rates
    )
    assert p_ref.tick_rate_update(prev, delta, period) == r_ref.tick_rate_update(prev, delta, period)
    assert p_ref.tick_rate_update(0.0, delta, period) == r_ref.tick_rate_update(0.0, delta, period)
    for rem in (delta, delta + 0.5):
        assert p_ref.resume_file(rem).size == r_ref.resume_file(rem).size


def test_unit_helpers_match_the_reference():
    for x in (0.0, 1.0, 2.5, 1e4):
        assert p_types.mbps(x) == r_types.mbps(x)
        assert p_types.to_gbps(x) == r_types.to_gbps(x)
    assert p_types.Chunk(p_types.ChunkType.SMALL, []).avg_file_size == 0.0


def test_dataset_generators_match_the_reference():
    assert sorted(p_files.DATASETS) == sorted(r_files.DATASETS)
    for name, gen in p_files.DATASETS.items():
        a = gen(scale=0.002, seed=5)
        b = r_files.DATASETS[name](scale=0.002, seed=5)
        assert [(f.name, f.size) for f in a] == [(f.name, f.size) for f in b]
    for total in (1e9, 50 * p_types.GB, 2e12):
        a = p_files.equal_class_dataset(total, seed=7)
        b = r_files.equal_class_dataset(total, seed=7)
        assert [(f.name, f.size) for f in a] == [(f.name, f.size) for f in b]


def test_expand_candidates_matches_the_reference():
    cands = [(0, 1, 1), p_types.TransferParams(4, 2, 8), (16, 4, 2)]
    rcands = [(0, 1, 1), r_types.TransferParams(4, 2, 8), (16, 4, 2)]
    base_p = p_scen.smoke_matrix()[:5]
    base_r = r_scen.smoke_matrix()[:5]
    a = p_scen.expand_candidates(base_p, cands)
    b = r_scen.expand_candidates(base_r, rcands)
    assert [s.name for s in a] == [s.name for s in b]
    assert len(a) == 15 and all(s.algorithm == "static" for s in a)
    a = p_scen.expand_candidates(base_p, lambda sc: cands[: 1 + sc.max_cc % 3])
    b = r_scen.expand_candidates(base_r, lambda sc: rcands[: 1 + sc.max_cc % 3])
    assert [s.name for s in a] == [s.name for s in b]
    assert [f.size for f in p_scen.build_files(a[0])] == [f.size for f in r_scen.build_files(b[0])]
    # a candidate row moves exactly its base scenario's bytes
    res = [p_scen.build_simulation(s).run() for s in (base_p[0], a[0])]
    assert res[0].total_bytes == res[1].total_bytes
    assert not math.isnan(res[1].total_time)


# --------------------------------------------------------------------------
# the scalar model against the sweep's own columns and kernels
# --------------------------------------------------------------------------


def test_scalar_model_matches_the_plan_columns():
    """Each row's chunks, Algorithm-1 parameters, channel caps, per-file
    dead times and initial channel allocation as the event simulator
    builds them equal the columns the sweep's plan computes for the row."""
    from repro_torch.core.netmodel import channel_rate_cap, file_start_dead_time
    from repro_torch.eval.fabric.plan import build_plan

    full = p_scen.full_matrix()
    scs = p_scen.smoke_matrix() + full[::9] + full[-18:]
    plan = build_plan(scs)
    for i, sc in enumerate(scs):
        sim = p_scen.build_simulation(sc)
        sched, net = sim.scheduler, sim.network
        chunks = sched.chunks
        k = len(chunks)
        assert int(plan.n_chunks[i]) == k, sc.name
        assert plan.chunk_names[i] == tuple(c.name for c in chunks)
        assert plan.sched_names[i] == sched.name
        assert plan.total_bytes[i] == sum(c.total_bytes for c in chunks)
        for j, c in enumerate(chunks):
            pp, par, cc = c.params.pipelining, c.params.parallelism, c.params.concurrency
            assert (plan.queue_bytes[i, j], plan.qlen[i, j]) == (c.total_bytes, len(c))
            assert plan.avg_fs_k[i, j] == max(c.avg_file_size, 1.0)
            assert (plan.par[i, j], plan.conc[i, j]) == (par, cc), sc.name
            assert plan.cap_k[i, j] == channel_rate_cap(net, par)
            assert plan.fsdt[i, j] == file_start_dead_time(net, c.params)
            assert pp >= 0
        opened = [0] * k
        for act in sched.initial_actions(sim._view()):
            opened[act.chunk] += act.n
        assert plan.open_n[i, :k].tolist() == opened, sc.name


@settings(max_examples=150, deadline=None)
@given(
    st.sampled_from(sorted(p_testbeds.TESTBEDS)), st.floats(0.0, 300.0), st.integers(0, 40),
    st.integers(0, 4096), st.lists(_RATE, min_size=1, max_size=20), st.floats(0.0, 5e10),
)
def test_scalar_model_matches_the_sweep_kernels(net, t, n, pp, caps, pool):
    """The event loop's scalar rate model against the fluid kernels the
    sweep runs (their plain versions): the bandwidth profile and the
    per-file dead time equal, the rate pool within one ulp, the
    water-fill (closed form) within 1e-12 of the pool."""
    import torch

    from repro_torch.eval.fabric import kernels

    spec = p_testbeds.TESTBEDS[net]
    f8 = torch.float64

    def one(x, dtype=f8):
        return torch.tensor([x], dtype=dtype)

    prof = spec.bandwidth_profile or ((0.0, 1.0),)
    pt = torch.tensor([[s for s, _ in prof]], dtype=f8)
    pm = torch.tensor([[m for _, m in prof]], dtype=f8)
    bw, nxt = kernels.bandwidth_now(one(spec.bandwidth), pt, pm, one(t))
    assert float(bw[0]) == spec.bandwidth_at(t)
    assert float(nxt[0]) == spec.next_profile_change(t)
    disk = spec.disk
    got = kernels.disk_pool(
        one(n, torch.int64), one(spec.bandwidth), one(disk.streaming_rate),
        one(disk.saturation_cc, torch.int64), one(disk.contention),
    )
    want = min(spec.bandwidth, disk.aggregate_rate(n)) if n > 0 else 0.0
    # the kernel divides the streaming rate by the contention factor, the
    # scalar model multiplies it by the factor's reciprocal (as the
    # reference's two do): one ulp apart at most
    assert abs(float(got[0]) - want) <= 2.0 ** -52 * want
    crtt = spec.control_rtt if spec.control_rtt is not None else spec.rtt
    dead = kernels.file_dead_time(
        one(crtt), one(float(pp)), one(spec.unhidden_overhead), one(disk.per_file_overhead)
    )
    assert float(dead[0]) == p_net.file_start_dead_time(spec, p_types.TransferParams(pp, 1, 1))
    alloc = kernels.waterfill(torch.tensor([caps], dtype=f8), one(pool))[0].tolist()
    for a, b in zip(alloc, p_net.waterfill(caps, pool)):
        assert abs(a - b) <= 1e-12 * max(pool, 1.0)
