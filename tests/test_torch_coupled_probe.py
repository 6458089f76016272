"""The coupled loop kernel's probe build and its reused solves, on the CPU.

The probe build (``fused_step.fused_rounds_coupled_probe``, entry
``fused_rounds_coupled_probe_f64``) splits the coupled loop's group step
by phase on the card only: here it refuses CPU tensors and a cap below one
step, and its phase names are the kernel's ``enum CoupledPhase``.

The coupled loop kernel takes a fabric group's last link grants again,
without the Jacobi solve, on a group step where every member's demand is
bit for bit the last solve's (the solve is a function of the demands
alone). The plain loop counts these steps (``counts["solve_reuses"]`` of
``fused_rounds_coupled_plain``, which the card's phase 3 holds the kernel's
count to). Here:

* the count equals a recount from the demands each plain step offers,
  group by group, and each such step's grants equal the last solve's;
* counting changes no result;
* the count is (G,) in the kernel's block order, 0 for a row outside every
  group;
* a row keeps ``COUPLED_LEVEL_SLOTS`` level inputs (the kernel's
  ``kLevelSlots``); a row outside every group steps as the uncoupled loop
  and reuses at least the levels that loop reuses.
"""
from __future__ import annotations

import dataclasses
import re

import pytest
import torch

from repro_torch.eval.fabric.driver import TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.scenarios import smoke_matrix, tenant_matrix


@pytest.fixture(autouse=True)
def _one_thread():
    """The coupled steps run thousands of tiny torch ops: one intra-op
    thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(scenarios, sweeps):
    """The loop operands (cloned) and fabric of a CPU driver ``sweeps``
    split sweeps into its run."""
    drv = TorchFabricSimulation(build_plan(scenarios), device="cpu", fused_step="none")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    return {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}, drv._fab


def _same(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def test_coupled_probe_runs_on_the_card_only():
    s, fab = _state(tenant_matrix(n_groups=2), 1)
    with pytest.raises(ValueError, match="card"):
        fs.fused_rounds_coupled_probe(s, fab)
    with pytest.raises(ValueError, match="max_steps"):
        fs.fused_rounds_coupled_probe(s, fab, 0)


def test_coupled_probe_phases_name_the_kernel_enum():
    """COUPLED_PROBE_PHASES are the kernel's ``enum CoupledPhase`` members
    in order, ``kCpAfterStep`` as ``after_step``, up to ``kCpPhases``."""
    body = re.search(r"enum CoupledPhase \{([^}]*)\}", fs.SOURCE.read_text()).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kCpPhases"
    assert all(n.startswith("kCp") for n in names)
    snake = tuple(re.sub(r"(?<!^)(?=[A-Z])", "_", n[3:]).lower() for n in names[:-1])
    assert snake == fs.COUPLED_PROBE_PHASES
    assert {"wait1", "wait2", "solve", "level"} <= set(snake)


def test_level_memory_size_is_the_kernels():
    """The plain count keeps as many inputs a row as the kernel's level
    memory has slots (``kLevelSlots``)."""
    slots = re.search(r"constexpr int kLevelSlots = (\d+);", fs.SOURCE.read_text()).group(1)
    assert fs.COUPLED_LEVEL_SLOTS == int(slots)


class _Demands:
    """Records what each plain coupled step offers and gets: the demands of
    the stepping rows of a group (0 elsewhere) and the pools
    ``coupled_pool`` returns (a group row's grant)."""

    def __init__(self, monkeypatch):
        self.steps = []
        real = fs.coupled_pool

        def rec(pool, total, live, fab):
            out = real(pool, total, live, fab)
            demand = torch.where(live & (fab["group_id"] >= 0), torch.minimum(pool, total), 0.0)
            self.steps.append((live.clone(), demand.clone(), out[0].clone()))
            return out

        monkeypatch.setattr(fs, "coupled_pool", rec)

    def recount(self, fab):
        """Each group's steps (a member stepping) whose members' demands are
        bit for bit its last step's, counted in Python; asserts each such
        step's grants are the last step's."""
        gid = fab["group_id"]
        count = [0] * fab["n_groups"]
        last = [None] * fab["n_groups"]
        for live, demand, pools in self.steps:
            for g in range(fab["n_groups"]):
                rows = gid == g
                if not bool(live[rows].any()):
                    continue
                key = demand[rows].numpy().tobytes()
                if last[g] is not None and last[g][0] == key:
                    count[g] += 1
                    assert torch.equal(pools[rows], last[g][1]), g  # the same grants
                last[g] = (key, pools[rows].clone())
        return torch.tensor(count, dtype=torch.int64)


@pytest.mark.parametrize("cap", [16, 2048])
def test_solve_reuses_equal_a_recount_of_repeated_demands(cap, monkeypatch):
    s, fab = _state(tenant_matrix(n_groups=6), 5)
    rec = _Demands(monkeypatch)
    counts = {}
    out = fs.fused_rounds_coupled_plain(s, fab, cap, counts=counts)
    reused = counts["solve_reuses"]
    assert reused.shape == (fab["layout"]["rows"].shape[0],)
    assert torch.equal(reused[: fab["n_groups"]], rec.recount(fab))
    assert int(reused.sum()) > 0
    group_steps = sum(int(out["steps"][r[r >= 0]].max()) for r in fab["layout"]["rows"])
    assert int(reused.sum()) < group_steps


def test_counting_solves_changes_no_result(monkeypatch):
    s, fab = _state(tenant_matrix(n_groups=6), 5)
    counts = {}
    got = fs.fused_rounds_coupled_plain(s, fab, 256, counts=counts)
    monkeypatch.setattr(fs, "_solve_reuse", lambda *a, **k: None)
    want = fs.fused_rounds_coupled_plain(s, fab, 256)
    assert set(got) == set(want)
    for name, v in want.items():
        assert _same(got[name], v), name
    assert int(counts["solve_reuses"].sum()) > 0


def test_solve_reuses_are_zero_outside_every_group():
    """A batch of two fabric groups and two rows on no shared link: four
    blocks in the layout's order, the lone rows' counts 0; the lone rows'
    results are the uncoupled loop's, their level reuses at least its (the
    level memory keeps the last input too)."""
    tenants = tenant_matrix(n_groups=2)
    lone = [dataclasses.replace(sc, shared_fabric=None) for sc in smoke_matrix()[:2]]
    s, fab = _state(tenants + lone, 3)
    counts = {}
    got = fs.fused_rounds_coupled_plain(s, fab, 64, counts=counts)
    reused = counts["solve_reuses"]
    n = fab["n_groups"]
    assert reused.shape == (n + 2,) and n == 2
    assert torch.equal(reused[n:], torch.zeros(2, dtype=torch.int64))
    assert int(reused[:n].sum()) > 0
    alone = fab["group_id"] < 0
    want = fs.fused_rounds_plain(s, 64)
    for name, v in want.items():
        if name != "reuses":
            assert _same(got[name][alone], v[alone]), name
    assert bool((got["reuses"][alone] >= want["reuses"][alone]).all())


@pytest.mark.parametrize("slots", [1, fs.COUPLED_LEVEL_SLOTS])
def test_level_memory_keeps_the_last_distinct_inputs(slots):
    """``_level_reuse`` with ``slots`` inputs a row: a row cycling over
    ``slots`` distinct inputs reuses every step after the first round; one
    cycling over ``slots + 1`` never does (the least recently used input is
    the one that comes back next); a row that does not step counts none."""
    for n, want in ((slots, 2 * slots), (slots + 1, 0)):
        cache = {}
        act = torch.tensor([True, False])
        for _ in range(3):
            for v in range(n):
                caps = torch.tensor([[1.0 + v, 2.0], [1.0 + v, 2.0]], dtype=torch.float64)
                fs._level_reuse(cache, act, caps, torch.full((2,), 1e9, dtype=torch.float64),
                                slots)
        assert cache["reuses"].tolist() == [want, 0], n
