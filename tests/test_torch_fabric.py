"""The port's fluid kernels, controller kernels and columnar plan against
the NumPy reference, on seeded random draws shaped like those of
``tests/test_fabric_kernels.py`` and ``tests/test_controller_kernels.py``.

Tolerances: bit-identical wherever the operation order is the same
(every kernel here but the ones noted); the timeline ring and integer
outputs are exact by construction."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.eval.fabric import controllers as ref_ctrl
from repro.eval.fabric import kernels as ref_k
from repro.eval.fabric.plan import build_plan as ref_build_plan
from repro.eval.fabric.shim import numpy_ops
from repro.eval.scenarios import default_matrix as ref_default_matrix
from repro.eval.scenarios import smoke_matrix as ref_smoke_matrix
from repro_torch.eval.fabric import controllers as ctrl
from repro_torch.eval.fabric import kernels as k
from repro_torch.eval.fabric.plan import ROW_COLUMNS, build_plan, from_reference_arrays
from repro_torch.eval.fabric.shim import TorchOps
from repro_torch.eval.scenarios import default_matrix, smoke_matrix

NP = numpy_ops()
SEEDS = [0, 1, 2]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same(out, ref):
    """Tuples of tensors vs tuples of arrays, value for value."""
    if not isinstance(ref, tuple):
        out, ref = (out,), (ref,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o = o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        np.testing.assert_array_equal(o, np.asarray(r))


def channel_state(seed, S=16, C=6, K=3, P=4):
    rng = np.random.RandomState(seed)
    chunk_of = rng.randint(-1, K, size=(S, C)).astype(np.int64)
    busy = (chunk_of >= 0) & (rng.uniform(size=(S, C)) < 0.4)
    qlen = rng.randint(0, 5, size=(S, K)).astype(np.int64)
    return dict(
        chunk_of=chunk_of,
        busy=busy,
        dead=np.where(rng.uniform(size=(S, C)) < 0.4, rng.uniform(0, 1, (S, C)), 0.0),
        rem=np.where(busy, rng.uniform(1e6, 1e9, size=(S, C)), 0.0),
        cap=np.where(chunk_of >= 0, rng.uniform(1e8, 1e9, size=(S, C)), 0.0),
        rates=rng.uniform(0, 1e9, size=(S, C)),
        qlen=qlen,
        qptr=np.minimum(rng.randint(0, 5, size=(S, K)), qlen).astype(np.int64),
        qoff=np.cumsum(np.concatenate([[0], qlen.ravel()[:-1]])).reshape(S, K),
        qsizes=np.floor(rng.uniform(1e6, 1e9, size=int(qlen.sum()) + 1)),
        qb=np.floor(rng.uniform(0, 1e10, size=(S, K))),
        fsdt=rng.uniform(0, 1, size=(S, K)),
        enabled=rng.uniform(size=S) < 0.8,
        pn=rng.randint(0, P + 1, size=(S, K)).astype(np.int64),
        ps=np.floor(rng.uniform(1e5, 1e8, size=(S, K, P))),
        tick_dt=rng.uniform(0, 10, size=S),
        dt=rng.uniform(0, 2, size=S),
        rng=rng,
    )


# ------------------------------------------------------------------ #
# fluid kernels
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("seed", SEEDS)
def test_waterfill_family_matches_numpy(seed):
    rng = np.random.RandomState(seed)
    caps = rng.uniform(0, 1e10, size=(32, 12))
    caps[rng.uniform(size=caps.shape) < 0.3] = 0.0
    pool = rng.uniform(0, 5e10, size=32)
    assert_same(k.waterfill(T(caps), T(pool)), ref_k.waterfill(NP, caps, pool))
    assert_same(k.waterfill_level(T(caps), T(pool)), ref_k.waterfill_level(NP, caps, pool))
    assert_same(k.caps_total(T(caps)), ref_k.caps_total(NP, caps))


@pytest.mark.parametrize("seed", SEEDS)
def test_disk_pool_dead_time_and_tick_ema_match_numpy(seed):
    rng = np.random.RandomState(seed)
    n_t = rng.randint(0, 64, size=20).astype(np.int64)
    bw, disk = rng.uniform(1e8, 4e9, 20), rng.uniform(1e8, 4e9, 20)
    sat = rng.randint(1, 16, size=20).astype(np.int64)
    cont = rng.uniform(0, 0.1, 20)
    assert_same(
        k.disk_pool(T(n_t), T(bw), T(disk), T(sat), T(cont)),
        ref_k.disk_pool(NP, n_t, bw, disk, sat, cont),
    )
    crtt, pp = rng.uniform(1e-4, 0.2, 20), rng.randint(0, 33, 20).astype(np.float64)
    un, pfo = rng.uniform(0, 0.06, 20), rng.uniform(0, 0.01, 20)
    assert_same(
        k.file_dead_time(T(crtt), T(pp), T(un), T(pfo)),
        ref_k.file_dead_time(NP, crtt, pp, un, pfo),
    )
    prev = np.where(rng.uniform(size=(20, 4)) < 0.3, 0.0, rng.uniform(0, 1e10, (20, 4)))
    deliv = rng.uniform(0, 1e12, (20, 4))
    at_tick = deliv * rng.uniform(0, 1, (20, 4))
    period = rng.uniform(1e-3, 60, (20, 1))
    assert_same(
        k.tick_ema(T(prev), T(deliv), T(at_tick), T(period)),
        ref_k.tick_ema(NP, prev, deliv, at_tick, period),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_horizon_and_advance_match_numpy(seed):
    s = channel_state(seed)
    busy, dead, rem, rates = s["busy"], s["dead"], s["rem"], s["rates"]
    tr = busy & (dead <= 1e-12)
    rates = np.where(tr, rates, 0.0)
    assert_same(
        k.event_horizon(T(s["tick_dt"]), T(busy), T(dead), T(tr), T(rem), T(rates)),
        ref_k.event_horizon(NP, s["tick_dt"], busy, dead, tr, rem, rates),
    )
    assert_same(
        k.advance_channels(T(s["enabled"]), T(s["dt"]), T(busy), T(dead), T(tr), T(rem), T(rates)),
        ref_k.advance_channels(NP, s["enabled"], s["dt"], busy, dead, tr, rem, rates),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stack", [False, True])
def test_feed_queues_matches_numpy(seed, stack):
    s = channel_state(seed)
    args = (
        s["enabled"], s["chunk_of"], s["busy"], s["dead"], s["rem"], s["qsizes"],
        s["qoff"], s["qlen"], s["qptr"], s["qb"], s["fsdt"],
    )
    extra = (s["ps"], s["pn"]) if stack else ()
    assert_same(
        k.feed_queues(*[T(a) for a in args + extra]),
        ref_k.feed_queues(NP, *(args + extra)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_compact_channels_and_chunk_primitives_match_numpy(seed):
    s = channel_state(seed)
    trig = s["enabled"]
    arrs = (s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"])
    assert_same(
        k.compact_channels(T(trig), *[T(a) for a in arrs]),
        ref_k.compact_channels(NP, trig, *arrs),
    )
    ch, busy, rem = s["chunk_of"], s["busy"], s["rem"]
    assert_same(
        TorchOps.count_by_chunk(T(ch), T(busy), 3), NP.count_by_chunk(ch, busy, 3)
    )
    # scatter-add accumulates in (row, channel) order, as np.add.at does
    assert_same(
        TorchOps.chunk_scatter_add(T(s["qb"]), T(ch), T(rem), T(busy & (ch >= 0))),
        NP.chunk_scatter_add(s["qb"], ch, rem, busy & (ch >= 0)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_ring_matches_numpy_over_many_pushes(seed):
    rng = np.random.RandomState(seed)
    S, Tb = 6, 8
    ref = [np.zeros((S, Tb)), np.zeros((S, Tb)), np.zeros(S, np.int64),
           np.ones(S, np.int64), np.zeros(S, np.int64), np.zeros(S), np.zeros(S)]
    out = [T(a.copy()) for a in ref]
    t = np.zeros(S)
    for _ in range(40):
        rec = rng.uniform(size=S) < 0.7
        t = t + rng.uniform(0, 1, S)
        rate = rng.uniform(0, 1e9, S)
        ref = list(ref_k.timeline_push(NP, rec, t, rate, *ref))
        out = list(k.timeline_push(T(rec), T(t), T(rate), *out))
    assert_same(tuple(out), tuple(ref))
    for s in range(S):
        rows = [a[s] for a in ref]
        assert k.timeline_samples(*[o[s] for o in out]) == ref_k.timeline_samples(*rows)


# ------------------------------------------------------------------ #
# controller kernels
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("seed", SEEDS)
def test_tuning_and_allocations_match_numpy(seed):
    rng = np.random.RandomState(seed)
    S, K = 32, 4
    avg = np.exp(rng.uniform(0, np.log(1e12), (S, K)))
    bdp = rng.uniform(0, 1e10, (S, 1))
    buf = rng.uniform(1024, 1e9, (S, 1))
    mcc = rng.randint(1, 65, (S, 1)).astype(np.float64)
    nf = rng.randint(0, 500, (S, K)).astype(np.int64)
    assert_same(
        ctrl.optimal_params(T(avg), T(bdp), T(buf), T(mcc), T(nf), 4096),
        ref_ctrl.optimal_params(NP, avg, bdp, buf, mcc, nf, 4096),
    )
    ct = rng.randint(-3, 5, (S, K)).astype(np.int64)
    assert_same(ctrl.sc_chunk_order(T(ct)), ref_ctrl.sc_chunk_order(NP, ct))
    rank = np.array([rng.permutation(K) for _ in range(S)], dtype=np.int64)
    nonempty = rng.uniform(size=(S, K)) < 0.8
    max_cc = rng.randint(1, 33, S).astype(np.int64)
    assert_same(
        ctrl.round_robin_alloc(T(rank), T(nonempty), T(max_cc)),
        ref_ctrl.round_robin_alloc(NP, rank, nonempty, max_cc),
    )
    weights = np.floor(rng.uniform(0, 5e12, (S, K))) * rng.choice([1.0, 2.0, 3.0, 6.0], (S, K))
    assert_same(
        ctrl.weighted_alloc(T(weights), T(nonempty), T(max_cc), K),
        ref_ctrl.weighted_alloc(NP, weights, nonempty, max_cc, K),
    )


def _views(rng, S, K):
    eta = np.where(rng.uniform(size=(S, K)) < 0.15, np.inf, rng.uniform(1.0, 1e4, (S, K)))
    thr = np.where(rng.uniform(size=(S, K)) < 0.3, 0.0, rng.uniform(1, 1e9, (S, K)))
    n_ch = rng.randint(0, 6, size=(S, K)).astype(np.int64)
    live = rng.uniform(size=(S, K)) < 0.8
    return eta, thr, n_ch, live


@pytest.mark.parametrize("seed", SEEDS)
def test_decision_kernels_match_numpy(seed):
    rng = np.random.RandomState(seed + 7)
    S, K = 32, 4
    eta, thr, n_ch, live = _views(rng, S, K)
    streak = rng.randint(0, 3, size=S).astype(np.int64)
    pf = rng.randint(-1, K, size=S).astype(np.int64)
    ps = rng.randint(-1, K, size=S).astype(np.int64)
    ratio, patience = np.full(S, 2.0), np.full(S, 3, np.int64)
    assert_same(
        ctrl.promc_tick(*[T(a) for a in (eta, thr, n_ch, live, streak, pf, ps, ratio, patience)]),
        ref_ctrl.promc_tick(NP, eta, thr, n_ch, live, streak, pf, ps, ratio, patience),
    )
    n_grants = rng.randint(0, 6, size=S).astype(np.int64)
    assert_same(
        ctrl.laggard_grants(T(eta), T(n_ch), T(live), T(n_grants), 6),
        ref_ctrl.laggard_grants(NP, eta, n_ch, live, n_grants, 6),
    )
    bytes_rem = np.where(rng.uniform(size=(S, K)) < 0.2, 0.0, rng.uniform(0, 1e12, (S, K)))
    pred = rng.uniform(0, 1e9, (S, K))
    done = rng.uniform(size=(S, K)) < 0.2
    assert_same(
        ctrl.chunk_eta(T(bytes_rem), T(thr), T(pred), T(done)),
        ref_ctrl.chunk_eta(NP, bytes_rem, thr, pred, done),
    )
    args = (
        rng.uniform(1, 1e10, (S, K)), rng.uniform(1e7, 1e9, (S, K)),
        rng.uniform(0, 0.2, (S, K)), n_ch, rng.randint(0, 20, S).astype(np.int64),
        rng.uniform(1e9, 4e9, S), rng.uniform(1e9, 4e9, S),
        rng.randint(1, 12, S).astype(np.int64), rng.uniform(0, 0.1, S),
    )
    assert_same(
        ctrl.predicted_chunk_rate(*[T(a) for a in args]),
        ref_ctrl.predicted_chunk_rate(NP, *args),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_transition_kernels_match_numpy(seed):
    s = channel_state(seed, S=16, C=8, K=3, P=6)
    rng = s["rng"]
    S, C, K = 16, 8, 3
    trig = s["enabled"]
    chan = (s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"])
    assert_same(
        ctrl.close_chunk(T(trig), 1, *[T(a) for a in chan]),
        ref_ctrl.close_chunk(NP, trig, 1, *chan),
    )
    setup = rng.uniform(0.05, 0.2, S)
    cap_k = rng.uniform(1e8, 1e9, (S, K))
    n_open = rng.randint(0, 3, S).astype(np.int64)
    target = rng.randint(0, K, S).astype(np.int64)
    assert_same(
        ctrl.open_ranked(*[T(a) for a in (n_open, target, chan[0], chan[2], chan[4], setup, cap_k)]),
        ref_ctrl.open_ranked(NP, n_open, target, chan[0], chan[2], chan[4], setup, cap_k),
    )
    order = np.array([rng.permutation(K) for _ in range(S)], dtype=np.int64)
    nfiles = rng.randint(0, 3, (S, K)).astype(np.int64)
    cursor = rng.randint(0, K, S).astype(np.int64)
    n_chunks = rng.randint(1, K + 1, S).astype(np.int64)
    assert_same(
        ctrl.sc_advance_cursor(T(trig), T(cursor), T(order), T(nfiles), T(n_chunks)),
        ref_ctrl.sc_advance_cursor(NP, trig, cursor, order, nfiles, n_chunks),
    )
    src = rng.randint(0, K, S).astype(np.int64)
    dst = (src + 1 + rng.randint(0, K - 1, S)) % K
    par = rng.randint(1, 4, (S, K)).astype(np.int64)
    pn = np.minimum(s["pn"], 5)  # keep a free stack slot, as the driver does
    n_moves = rng.randint(0, 5, S).astype(np.int64)
    move_args = chan + (s["qb"], s["ps"], pn, n_moves, par, cap_k, setup)
    assert_same(
        ctrl.move_channel(T(trig), T(src), T(dst), *[T(a) for a in move_args]),
        ref_ctrl.move_channel(NP, trig, src, dst, *move_args),
    )
    eta, _, n_ch, live = _views(rng, S, K)
    freed = rng.randint(0, 4, S).astype(np.int64)
    grants, first = ref_ctrl.laggard_grants(NP, eta, n_ch, live, freed, 4)
    grant_args = chan + (n_moves, par, cap_k, setup)
    assert_same(
        ctrl.apply_grants(T(trig), 0, T(grants), T(first), *[T(a) for a in grant_args]),
        ref_ctrl.apply_grants(NP, trig, 0, grants, first, *grant_args),
    )


# ------------------------------------------------------------------ #
# the columnar plan
# ------------------------------------------------------------------ #


def reference_arrays(plan):
    """A reference ScenarioPlan in the format of ``ScenarioPlan.arrays``."""
    S, K = plan.n_rows, plan.K
    chunks = np.full((S, K), "", dtype=object)
    for i, refs in enumerate(plan.chunk_refs):
        chunks[i, : len(refs)] = [r.name for r in refs]
    out = {c: getattr(plan, c) for c in ROW_COLUMNS}
    out.update(
        qsizes=plan.qsizes,
        networks=np.array([n.name for n in plan.networks], dtype=object),
        names=np.array(plan.names, dtype=object),
        schedulers=np.array([r.name for r in plan.sched_refs], dtype=object),
        chunks=chunks,
        coupled=np.array([f is not None for f in plan.fabrics], dtype=bool),
    )
    return out


@pytest.mark.parametrize(
    "port_matrix,ref_matrix",
    [(smoke_matrix, ref_smoke_matrix), (default_matrix, ref_default_matrix)],
    ids=["smoke", "default"],
)
def test_build_plan_equals_the_reference_plan(port_matrix, ref_matrix):
    ref = reference_arrays(ref_build_plan(ref_matrix()))
    port_plan = build_plan(port_matrix())
    out = port_plan.arrays()
    assert set(out) == set(ref)
    for name, r in ref.items():
        o = out[name]
        assert o.shape == r.shape and o.dtype == r.dtype, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    ref_plan = ref_build_plan(ref_matrix())
    np.testing.assert_array_equal(port_plan.cost_proxy(), ref_plan.cost_proxy())
    assert port_plan.shape_hints() == ref_plan.shape_hints()
    # the reference columns rebuild the port's plan exactly
    again = from_reference_arrays(ref).arrays()
    for name, r in ref.items():
        np.testing.assert_array_equal(again[name], r, err_msg=name)


def test_resume_file_matches_the_reference():
    from repro.eval.fabric.reference import resume_file as ref_resume_file
    from repro_torch.eval.fabric.reference import resume_file

    for remaining in (0.0, 0.25, 1.0, 12345.5, 8.0 * 2**30 - 0.5):
        a, b = resume_file(remaining), ref_resume_file(remaining)
        assert (a.name, a.size) == (b.name, b.size)


def test_testbeds_channel_caps_and_param_triple_match_the_reference():
    import dataclasses

    from repro.core import netmodel as ref_netmodel
    from repro.core import testbeds as ref_testbeds
    from repro.core.types import TransferParams as RefParams
    from repro.core.types import param_triple as ref_param_triple
    from repro_torch.core import netmodel, testbeds
    from repro_torch.core.types import TransferParams, param_triple

    for name, net in testbeds.TESTBEDS.items():
        ref = ref_testbeds.TESTBEDS[name]
        assert dataclasses.asdict(net) == dataclasses.asdict(ref), name
        for p in (1, 2, 3, 8, 64, 100):
            assert netmodel.channel_rate_cap(net, p) == ref_netmodel.channel_rate_cap(ref, p)
    assert param_triple(TransferParams(4, 2, 8)) == ref_param_triple(RefParams(4, 2, 8))
    assert param_triple([1, 2, 3]) == ref_param_triple([1, 2, 3]) == (1, 2, 3)


@pytest.mark.parametrize("network", ["ckpt-object-store", "tpu-dcn-pod-pair"])
@pytest.mark.parametrize("algorithm", ["sc", "mc", "promc"])
def test_fabric_testbeds_resolve_in_a_scenario(network, algorithm):
    """A scenario on the checkpoint store or the pod-pair network (a
    ``KeyError`` before the port had them) builds and runs, and its event
    simulation equals the reference's."""
    from repro.eval.scenarios import Scenario as RefScenario
    from repro.eval.scenarios import build_simulation as ref_build_simulation
    from repro_torch.eval.scenarios import Scenario, build_simulation

    kw = dict(network=network, dataset="mixed", algorithm=algorithm, max_cc=4)
    ours = build_simulation(Scenario(**kw)).run()
    theirs = ref_build_simulation(RefScenario(**kw)).run()
    assert ours.network == theirs.network == network
    assert (ours.n_events, ours.n_moves) == (theirs.n_events, theirs.n_moves)
    assert ours.total_bytes == theirs.total_bytes > 0
    assert ours.total_time == pytest.approx(theirs.total_time, rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_every_dataset_builds_the_reference_file_set(seed):
    from repro.eval.scenarios import DATASET_BUILDERS as REF_BUILDERS
    from repro_torch.eval.scenarios import DATASET_BUILDERS

    assert list(DATASET_BUILDERS) == list(REF_BUILDERS)
    for name, build in DATASET_BUILDERS.items():
        ours = [(f.name, f.size) for f in build(1000 + seed)]
        theirs = [(f.name, f.size) for f in REF_BUILDERS[name](1000 + seed)]
        assert ours == theirs, name
