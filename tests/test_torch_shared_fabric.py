"""The port's shared fabrics against the reference (``tests/test_shared_fabric.py``
there): the coupled water-fill, ``SharedFabric`` / ``resolve_fabric``,
``tenant_matrix``, the coupled event leg, the sweep's coupled routes on the
CPU (the split route and the coupled loop kernel's plain version), the
coupled channel bound and the runner's group-atomic chunking.

Limits: the coupled water-fill equals the reference's NumPy version bit for
bit (same sort, prefix and division order) and lies within the reference
test's rtol = atol = 1e-6 of progressive filling; the event leg and the
closed-form split route equal the reference's event loop and NumPy driver
bit for bit on tenant-smoke; the loop's plain version and the bisected split
route lie within 1e-9 relative throughput of the event leg (the uncoupled
routes sit within 3.8e-16 of theirs).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.eval.fabric import kernels as ref_kernels
from repro.eval.fabric.reference import coupled_fair_share as ref_coupled_fair_share
from repro.eval.fabric.shim import numpy_ops
from repro_torch.core import testbeds
from repro_torch.eval.fabric import kernels, transition
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan, from_reference_arrays
from repro_torch.eval.fabric.reference import coupled_fair_share
from repro_torch.eval.fabric.shared import SharedFabric, resolve_fabric
from repro_torch.eval.runner import _group_atomic_parts, run_matrix
from repro_torch.eval.scenarios import Scenario, smoke_matrix, tenant_matrix

_NP = numpy_ops()


@pytest.fixture(autouse=True)
def one_thread():
    """The coupled sweeps run thousands of small torch ops: one intra-op
    thread keeps them fast on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _fab(group, cap, tenant="", links=("bb",)):
    return SharedFabric(group=group, links=tuple(links), capacity=(float(cap),) * len(links),
                        tenant=tenant)


# ------------------------------------------------------------------ #
# the coupled water-fill
# ------------------------------------------------------------------ #


def test_waterfill_coupled_two_link_hand_example():
    # row A rides links 0 and 1 (caps 10 / 2), row B link 0 only: A is held
    # to 2 by link 1, B takes the other 8 of link 0
    demand = np.array([10.0, 10.0])
    member = np.array([[True, True], [True, False]])
    link_cap = np.array([10.0, 2.0])
    x, levels = kernels.waterfill_coupled(_t(demand), _t(member, torch.bool), _t(link_cap))
    assert x.tolist() == [2.0, 8.0] and levels.tolist() == [8.0, 2.0]
    rx, rl = ref_kernels.waterfill_coupled(_NP, demand, member, link_cap)
    assert x.tolist() == rx.tolist() and levels.tolist() == rl.tolist()


def test_waterfill_coupled_no_links_passes_demand_through():
    demand = _t([3.0, 7.0])
    x, levels = kernels.waterfill_coupled(demand, torch.zeros((0, 2), dtype=torch.bool),
                                          torch.zeros(0, dtype=torch.float64))
    assert x.tolist() == [3.0, 7.0] and levels.shape == (0,)


def test_waterfill_coupled_unsaturated_links_grant_full_demand():
    x, levels = kernels.waterfill_coupled(
        _t([1.0, 2.0, 3.0]), torch.ones((2, 3), dtype=torch.bool), _t([100.0, 50.0])
    )
    assert x.tolist() == [1.0, 2.0, 3.0] and torch.isinf(levels).all()


@pytest.mark.parametrize("seed", range(24))
def test_waterfill_coupled_matches_the_reference_and_progressive_filling(seed):
    """Random memberships of up to 12 rows and 4 links, as the reference's
    property test draws them: bit for bit the reference's NumPy version
    (which runs all 12 sweeps, so the port's stop at the fixed point
    changes nothing), within 1e-6 of progressive filling, and feasible."""
    rng = np.random.RandomState(seed)
    for _ in range(8):
        rows, links = rng.randint(1, 13), rng.randint(1, 5)
        demand = rng.uniform(0.0, 1e3, size=rows)
        demand[rng.rand(rows) < 0.2] = 0.0
        member = rng.uniform(size=(links, rows)) < 0.5
        link_cap = rng.uniform(1.0, 1e3, size=links)
        x, levels = kernels.waterfill_coupled(_t(demand), _t(member, torch.bool), _t(link_cap))
        rx, rl = ref_kernels.waterfill_coupled(_NP, demand, member, link_cap)
        assert x.tolist() == rx.tolist() and levels.tolist() == rl.tolist()
        pf = coupled_fair_share(list(demand), [list(r) for r in member], list(link_cap))
        assert pf == ref_coupled_fair_share(list(demand), [list(r) for r in member],
                                            list(link_cap))
        np.testing.assert_allclose(x.numpy(), pf, rtol=1e-6, atol=1e-6)
        assert (x.numpy() <= demand + 1e-6).all()
        assert (member @ x.numpy() <= link_cap * (1 + 1e-6) + 1e-6).all()


def test_coupled_pool_counts_the_sweeps_it_ran():
    """The hand example's levels settle in the second sweep, which the
    third confirms: three sweeps, three fixed-point tests. Unsaturated
    links settle at once."""
    fab = fs.fabric_operands(np.zeros(2, dtype=np.int64), [[True, True], [True, False]],
                             [10.0, 2.0])
    live = torch.ones(2, dtype=torch.bool)
    pools, sweeps = kernels.coupled_pool(_t([10.0, 10.0]), _t([10.0, 10.0]), live, fab)
    assert pools.tolist() == [2.0, 8.0] and sweeps == 3
    pools, sweeps = kernels.coupled_pool(_t([1.0, 1.0]), _t([1.0, 1.0]), live, fab)
    assert pools.tolist() == [1.0, 1.0] and sweeps == 1


def test_split_route_counts_each_sweep_as_a_host_sync(monkeypatch):
    """On the "none" route every host read is counted: the driver's own
    reads and each Jacobi sweep's fixed-point test."""
    from repro_torch.eval.fabric import driver as drv_mod

    ran = []
    coupled_pool = kernels.coupled_pool

    def counting(*args):
        pools, sweeps = coupled_pool(*args)
        ran.append(sweeps)
        return pools, sweeps

    drv = TorchFabricSimulation(build_plan(tenant_matrix(n_groups=2)), device="cpu",
                                fused_step="none")
    reads = []
    read = drv._read
    monkeypatch.setattr(drv, "_read", lambda t: reads.append(1) or read(t))
    monkeypatch.setattr(drv_mod.kernels, "coupled_pool", counting)
    drv.start()
    for _ in range(20):
        drv.step()
    assert len(ran) == 20 and all(1 <= n <= kernels.COUPLED_ITERS for n in ran)
    assert drv.stats.host_syncs == len(reads) + sum(ran)


def test_group_solves_equal_the_batch_wide_solve():
    """Each group solved on its own links and rows (as the coupled loop
    kernel's block solves it) equals the batch-wide solve over the whole
    (L, S) table of tenant_matrix(), bit for bit, grants and levels."""
    fab = resolve_fabric([sc.shared_fabric for sc in tenant_matrix()])
    member, link_cap = torch.from_numpy(fab.member), torch.from_numpy(fab.link_cap)
    gid = fab.group_id
    rng = np.random.RandomState(0)
    for _ in range(20):
        demand = rng.uniform(0.0, 5e9, size=gid.size)
        demand[rng.rand(gid.size) < 0.2] = 0.0
        x, levels = kernels.waterfill_coupled(_t(demand), member, link_cap)
        for g in range(fab.n_groups):
            rows = np.flatnonzero(gid == g)
            links = np.flatnonzero(fab.member[:, rows].any(axis=1))
            xg, lg = kernels.waterfill_coupled(
                _t(demand[rows]), member[links][:, rows], link_cap[links]
            )
            assert xg.tolist() == x[rows].tolist()
            assert lg.tolist() == levels[links].tolist()


def test_fabric_layout_and_the_kernel_limits():
    fabrics = [_fab("a", 5.0, f"t{i}") for i in range(3)] + [None] + [
        _fab("b", 7.0, "t0", links=("x", "y"))]
    fab = resolve_fabric(fabrics)
    lay = fs.fabric_layout(fab.group_id, fab.member, fab.link_cap)
    assert lay["rows"].tolist() == [[0, 1, 2], [4, -1, -1], [3, -1, -1]]
    assert lay["mask"].tolist() == [[7, 0, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0]]
    assert lay["cap"].tolist() == [[5.0, 0, 0, 0], [7.0, 7.0, 0, 0], [0, 0, 0, 0]]
    # a group wider than the kernel's block, or with more links, raises
    # before any launch, naming the group
    nine = resolve_fabric([_fab("wide", 5.0, f"t{i}") for i in range(9)])
    with pytest.raises(ValueError, match=r"group 0 \(row 0, 'r0'\) has 9 rows"):
        fs.fabric_layout(nine.group_id, nine.member, nine.link_cap,
                         names=[f"r{i}" for i in range(9)])
    five = resolve_fabric([_fab("many", 5.0, links=tuple("abcde"))])
    with pytest.raises(ValueError, match="has 5 links"):
        fs.fabric_layout(five.group_id, five.member, five.link_cap)
    # the loop's fabric carries the layout, or the error its wrapper raises
    ops = fs.fabric_operands(fab.group_id, fab.member, fab.link_cap)
    assert {k: v.tolist() for k, v in ops["layout"].items()} == {
        k: v.tolist() for k, v in lay.items()}
    assert ops["width"] == 3
    wide = fs.fabric_operands(nine.group_id, nine.member, nine.link_cap,
                              names=[f"r{i}" for i in range(9)])
    assert isinstance(wide["layout"], ValueError) and "'r0'" in str(wide["layout"])


# ------------------------------------------------------------------ #
# specs, matrices and the plan
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("seed,n_groups", [(0, 36), (0, 6), (3, 5)])
def test_tenant_matrix_equals_the_reference(seed, n_groups):
    from repro.eval.scenarios import tenant_matrix as ref_tenant_matrix

    ours = tenant_matrix(seed=seed, n_groups=n_groups)
    ref = ref_tenant_matrix(seed=seed, n_groups=n_groups)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.name == b.name
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.name == "shared_fabric":
                assert dataclasses.asdict(va) == dataclasses.asdict(vb)
            else:
                assert va == vb, f.name
    if (seed, n_groups) == (0, 36):
        import json
        from pathlib import Path

        assert len(ours) == 206
        # uncoupled names carry no suffix: the smoke golden still names them
        golden = json.loads((Path(__file__).parent / "golden" / "eval_smoke.json").read_text())
        assert {sc.name for sc in smoke_matrix()} <= set(golden)


def test_resolve_fabric_equals_the_reference():
    from repro.eval.fabric.shared import resolve_fabric as ref_resolve
    from repro.eval.scenarios import tenant_matrix as ref_tenant_matrix

    ours = resolve_fabric([sc.shared_fabric for sc in tenant_matrix()] + [None])
    ref = resolve_fabric_ref = ref_resolve(
        [sc.shared_fabric for sc in ref_tenant_matrix()] + [None])
    assert ours.n_groups == ref.n_groups == 36 and ours.coupled
    for name in ("group_id", "member", "link_cap"):
        a, b = getattr(ours, name), getattr(resolve_fabric_ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.member.shape == (84, 207)


_BAD_SPECS = [
    dict(group="", links=("a",), capacity=(1.0,)),
    dict(group="g|x", links=("a",), capacity=(1.0,)),
    dict(group="g", links=("a",), capacity=(1.0,), tenant="t:1"),
    dict(group="g", links=("a", "b"), capacity=(1.0,)),
    dict(group="g", links=(), capacity=()),
    dict(group="g", links=("a", "a"), capacity=(1.0, 1.0)),
    dict(group="g", links=("",), capacity=(1.0,)),
    dict(group="g", links=("a",), capacity=(0.0,)),
]


@pytest.mark.parametrize("spec", _BAD_SPECS, ids=range(len(_BAD_SPECS)))
def test_shared_fabric_validation_equals_the_reference(spec):
    from repro.eval.fabric.shared import SharedFabric as RefSharedFabric

    with pytest.raises(ValueError) as ref_err:
        RefSharedFabric(**spec)
    with pytest.raises(ValueError) as err:
        SharedFabric(**spec)
    assert str(err.value) == str(ref_err.value)


def test_resolve_fabric_conflicting_capacity_error_equals_the_reference():
    from repro.eval.fabric.shared import SharedFabric as RefSharedFabric
    from repro.eval.fabric.shared import resolve_fabric as ref_resolve

    with pytest.raises(ValueError) as ref_err:
        ref_resolve([RefSharedFabric("g", ("bb",), (1.0,)), RefSharedFabric("g", ("bb",), (2.0,))])
    with pytest.raises(ValueError) as err:
        resolve_fabric([SharedFabric("g", ("bb",), (1.0,)), SharedFabric("g", ("bb",), (2.0,))])
    assert str(err.value) == str(ref_err.value)
    assert SharedFabric("g", ("bb",), (1.0,), "t0").name_suffix == "fab:g:t0"


def test_plan_of_coupled_rows_equals_the_reference_plan():
    """The coupled plan: every column the reference's (the coupled SC
    rows' widened channel bound included), a real ``coupled`` column, and
    the fabric specs carried through ``take`` and ``from_reference_arrays``."""
    from repro.eval.fabric.plan import build_plan as ref_build_plan
    from repro.eval.scenarios import tenant_matrix as ref_tenant_matrix

    from test_torch_fabric import reference_arrays

    ref_plan = ref_build_plan(ref_tenant_matrix(n_groups=6))
    ref = reference_arrays(ref_plan)
    plan = build_plan(tenant_matrix(n_groups=6))
    out = plan.arrays()
    assert set(out) == set(ref)
    for name, r in ref.items():
        assert out[name].dtype == r.dtype, name
        np.testing.assert_array_equal(out[name], r, err_msg=name)
    assert out["coupled"].all()
    sc = plan.kind == transition.KIND_SC
    assert (plan.cap_need[sc] > np.where(plan.conc[sc] > 0, plan.conc[sc], 0).max(axis=1)).any()
    sub = plan.take([3, 1])
    assert sub.fabrics == [plan.fabrics[3], plan.fabrics[1]]
    again = from_reference_arrays({**ref, "fabrics": plan.fabrics})
    assert again.fabrics == plan.fabrics
    with pytest.raises(ValueError, match="fabrics"):
        from_reference_arrays(ref)


# ------------------------------------------------------------------ #
# the coupled event leg and the sweep's coupled routes
# ------------------------------------------------------------------ #


def _same(a, b):
    return (a.total_time, a.throughput, a.total_bytes, a.n_events, a.n_moves,
            a.per_chunk_bytes) == (b.total_time, b.throughput, b.total_bytes, b.n_events,
                                   b.n_moves, b.per_chunk_bytes)


@pytest.fixture(scope="module")
def smoke_legs():
    """tenant-smoke (29 rows in 6 groups) on the port's event leg and the
    reference's event loop and NumPy driver."""
    from repro.eval.runner import run_matrix as ref_run_matrix
    from repro.eval.scenarios import tenant_matrix as ref_tenant_matrix

    ours = tenant_matrix(n_groups=6)
    ref = ref_tenant_matrix(n_groups=6)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    event = run_matrix(ours, backend="event")
    torch.set_num_threads(n)
    return ours, event, ref_run_matrix(ref, backend="event"), ref_run_matrix(ref, backend="numpy")


def test_coupled_event_leg_equals_the_reference(smoke_legs):
    ours, event, ref_event, _ = smoke_legs
    assert len(ours) == 29
    for a, b in zip(event, ref_event):
        assert _same(a, b)


def test_closed_split_route_equals_the_reference_numpy_driver(smoke_legs):
    ours, _, _, ref_numpy = smoke_legs
    stats = SweepStats()
    out = run_matrix(ours, device="cpu", fused_step="none", waterfill_impl="closed", stats=stats)
    for a, b in zip(out, ref_numpy):
        assert _same(a, b)
    assert stats.host_transitions == 0


@pytest.mark.parametrize("route", ["rounds", "none"])
def test_coupled_routes_hold_the_event_leg(smoke_legs, route):
    """The loop kernel's plain version and the bisected split route: within
    1e-9 relative throughput of the coupled event leg, no transition left
    to the host, one host round on "rounds"."""
    ours, event, _, _ = smoke_legs
    stats = SweepStats()
    out = run_matrix(ours, device="cpu", fused_step=route, stats=stats)
    worst = max(_rel(a.throughput, e.throughput) for a, e in zip(out, event))
    assert worst <= 1e-9, worst
    assert all(a.total_bytes == e.total_bytes for a, e in zip(out, event))
    assert stats.host_transitions == 0
    if route == "rounds":
        assert stats.sweeps == 1


def test_kernel_route_refuses_coupled_plans():
    with pytest.raises(ValueError, match="no coupling"):
        TorchFabricSimulation(build_plan(tenant_matrix(n_groups=1)), device="cpu",
                              fused_step="kernel")


def _lone(cap_frac):
    base = Scenario(network="didclab-lan-glusterfs", dataset="mixed", algorithm="mc")
    bw = testbeds.TESTBEDS[base.network].bandwidth
    return base, dataclasses.replace(base, shared_fabric=_fab("solo", cap_frac * bw))


@pytest.mark.parametrize("route", ["rounds", "none"])
def test_single_tenant_on_a_generous_link_equals_the_uncoupled_row(route):
    """A lone tenant on a link that never binds offers min(pool, total),
    is granted it back, and steps exactly as uncoupled."""
    base, coupled = _lone(2.0)
    a = run_matrix([coupled], device="cpu", fused_step=route)[0]
    b = run_matrix([base], device="cpu", fused_step=route)[0]
    assert _same(a, b)


def test_single_tenant_on_a_binding_link_is_throttled_like_the_event_leg():
    base, coupled = _lone(0.2)
    ev = run_matrix([coupled], backend="event")[0]
    for route in ("rounds", "none"):
        r = run_matrix([coupled], device="cpu", fused_step=route)[0]
        assert _rel(r.throughput, ev.throughput) <= 1e-9
    assert ev.total_time > run_matrix([base], backend="event")[0].total_time


def test_fuzz_random_link_membership_difftest():
    """Random (links x tenants) tables of three tenants: both coupled
    routes against the coupled event leg under the difftest's 2% bar."""
    from repro_torch.eval.difftest import DEFAULT_RTOL

    nets = list(testbeds.TESTBEDS)[:3]
    datasets = ("mixed", "small_dominated", "des")
    rows = []
    for seed in range(3):
        rng = np.random.RandomState(1234 + seed)
        picks = [nets[rng.randint(len(nets))] for _ in range(3)]
        bws = [testbeds.TESTBEDS[n].bandwidth for n in picks]
        cap_bb = float(rng.uniform(0.3, 0.8) * sum(bws))
        sub = [t for t in range(3) if rng.rand() < 0.5]
        cap_l1 = float(rng.uniform(0.3, 0.9) * sum(bws[t] for t in sub)) if len(sub) >= 2 else None
        for t in range(3):
            links, caps = ["bb"], [cap_bb]
            if cap_l1 is not None and t in sub:
                links.append("l1")
                caps.append(cap_l1)
            fab = SharedFabric(group=f"fz{seed}", links=tuple(links), capacity=tuple(caps),
                               tenant=f"t{t}")
            rows.append(Scenario(network=picks[t], dataset=datasets[rng.randint(3)],
                                 algorithm=("sc", "mc", "promc")[t % 3], seed=seed,
                                 shared_fabric=fab))
    ev = run_matrix(rows, backend="event")
    for route in ("rounds", "none"):
        out = run_matrix(rows, device="cpu", fused_step=route)
        for sc, e, r in zip(rows, ev, out):
            assert _rel(r.throughput, e.throughput) <= DEFAULT_RTOL, (route, sc.name)


# ------------------------------------------------------------------ #
# the coupled loop's plain version: groups of one, stops
# ------------------------------------------------------------------ #


def _loop_state(scenarios, sweeps):
    drv = TorchFabricSimulation(build_plan(scenarios), device="cpu", fused_step="none")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    return drv


def test_coupled_loop_on_uncoupled_rows_equals_the_loop():
    """Rows outside every group run as groups of one: the uncoupled loop's
    results, bit for bit; their level memory reuses at least the levels
    the uncoupled loop's last-input cache reuses."""
    drv = _loop_state(smoke_matrix()[:12], 5)
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    S = s["act"].shape[0]
    solo = fs.fabric_operands(np.full(S, -1), np.zeros((0, S), dtype=bool), np.zeros(0))
    for cap in (3, 200):
        want = fs.fused_rounds_plain(s, cap)
        got = fs.fused_rounds_coupled_plain(s, solo, cap)
        for k, v in want.items():
            if k == "reuses":
                assert bool((got[k] >= v).all())
                continue
            assert torch.equal(v, got[k]) or (v.is_floating_point() and torch.equal(
                torch.nan_to_num(v, nan=-1.0), torch.nan_to_num(got[k], nan=-1.0))), k


def test_coupled_loop_stops_its_group_with_a_member():
    """A member past max_time stops its group before the step (the others
    STOP_GROUP, no step taken); the other groups run on. The group's step
    cap counts group steps."""
    drv = _loop_state(tenant_matrix(n_groups=2), 3)
    s = drv.round_operands(~drv.done)
    s = {k: v.clone() for k, v in s.items()}
    fab = drv._fab
    gid = fab["group_id"]
    s["max_time"][0] = s["t"][0] - 1.0  # row 0 (group 0) is past its limit
    out = fs.fused_rounds_coupled_plain(s, fab, 50)
    g0, g1 = gid == gid[0], gid != gid[0]
    assert out["stop"][0] == transition.STOP_ERROR
    assert (out["stop"][g0][1:] == transition.STOP_GROUP).all()
    assert (out["steps"][g0] == 0).all()
    assert (out["steps"][g1] == 50).all() and (out["stop"][g1] == transition.STOP_CAP).all()


# ------------------------------------------------------------------ #
# the coupled channel bound and the runner's chunking
# ------------------------------------------------------------------ #


def test_coupled_sc_capacity_bound_worst_case():
    """A coupled SC row can start every wave at once (group-horizon ties),
    so its bound is the concurrency sum, above the uncoupled one-wave
    bound, equal to the reference plan's; a hard-throttled coupled run
    never holds more open channels."""
    from repro.eval.fabric.plan import build_plan as ref_build_plan
    from repro.eval.scenarios import Scenario as RefScenario
    from repro.eval.fabric.shared import SharedFabric as RefSharedFabric

    specs = [("stampede-comet", "small_dominated", "sc"), ("didclab-lan-glusterfs", "mixed", "mc")]
    bw = sum(testbeds.TESTBEDS[n].bandwidth for n, _, _ in specs)
    rows = [Scenario(network=n, dataset=d, algorithm=a, shared_fabric=_fab("wc", 0.2 * bw, f"t{i}"))
            for i, (n, d, a) in enumerate(specs)]
    ref_rows = [RefScenario(network=n, dataset=d, algorithm=a, shared_fabric=RefSharedFabric(
        "wc", ("bb",), (0.2 * bw,), f"t{i}")) for i, (n, d, a) in enumerate(specs)]
    plan = build_plan(rows)
    uncoupled = build_plan([dataclasses.replace(r, shared_fabric=None) for r in rows])
    assert plan.cap_need.tolist() == ref_build_plan(ref_rows).cap_need.tolist()
    assert plan.cap_need[0] > uncoupled.cap_need[0]
    assert plan.cap_need[0] == np.where(plan.conc[0] > 0, plan.conc[0], 0).sum()
    drv = TorchFabricSimulation(plan, device="cpu", fused_step="none")
    drv.start()
    peak = 0
    while drv.step():
        peak = max(peak, int((drv.chunk_of != -1).sum(dim=1).max()))
    assert 0 < peak <= int(plan.cap_need.max())


def test_group_atomic_parts_never_split_groups():
    fabs = [None, _fab("g1", 10.0, "t0"), _fab("g1", 10.0, "t1"), None,
            _fab("g2", 5.0, "t0"), _fab("g2", 5.0, "t1"), _fab("g2", 5.0, "t2"), None]
    order = [7, 5, 3, 1, 6, 0, 4, 2]
    uncoupled, parts = _group_atomic_parts(order, fabs, size=3)
    assert uncoupled == [7, 3, 0]
    assert parts == [[5, 6, 4], [1, 2]]
    # a group larger than the part size stays whole
    _, parts2 = _group_atomic_parts(order, fabs, size=2)
    assert parts2 == [[5, 6, 4], [1, 2]]
    # the matrix runner keeps every group in one driver
    seen = []
    import repro_torch.eval.runner as runner

    class Spy:  # records each driver's rows instead of running them
        def __init__(self, plan, **kw):
            seen.append([f.group for f in plan.fabrics])
            self.n, self.stats = plan.n_rows, SweepStats()

        def run(self):
            return [None] * self.n

    orig = runner.TorchFabricSimulation
    runner.TorchFabricSimulation = Spy
    try:
        run_matrix(tenant_matrix(n_groups=3), device="cpu", chunk_size=8)
    finally:
        runner.TorchFabricSimulation = orig
    groups = [g for part in seen for g in set(part)]
    assert len(groups) == len(set(groups)) == 3
