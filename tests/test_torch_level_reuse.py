"""The loop kernels' water-level reuse, counted by the plain loop on the CPU.

The loop kernels (``fused_rounds_f64``, ``fused_rounds_coupled_f64``) keep a
row's last water level and take it again, without the descent, on a step
whose transferring caps and ``pool_eff`` are bit for bit the last step's in
the same launch (the level is a function of those alone); a row in the
coupled kernel (of a fabric group or alone) keeps the levels of its last
``fused_step.COUPLED_LEVEL_SLOTS`` distinct inputs (its level memory, least
recently used out first). The plain loops count the same reuses by the same
rule (``fused_step._level_reuse``) and return them as ``reuses``; the card's
phase 3 holds the kernels' counts to them. Here:

* counting changes nothing: the plain loop with its counter gives every
  state, step and stop that the loop without it gives;
* on a tick-only row (the full grid's longest, lossy-transatlantic /
  uniform_huge / untuned: one channel on a huge file, a tick every 5 s)
  at least 90% of the steps reuse the level, and the count equals a
  recount from the plain step's own water-level inputs, each reused step's
  level equal to the last step's;
* the same recount holds on live states with completions, grants, ProMC
  moves and resume pushes, and on the coupled loop (its groups, and rows
  outside every group);
* the driver adds each launch's reuses into ``SweepStats.level_reuses`` on
  the ``"rounds"`` route (0 elsewhere);
* the plain per-chunk sum the kernels must equal adds a chunk's columns in
  column order where chunks interleave.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.eval.fabric import driver
from repro_torch.eval.fabric import transition as tr
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.kernels.waterfill_bisect import lane_sum
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.fabric.shim import TorchOps
from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import full_matrix, smoke_matrix, tenant_matrix

#: the full grid's longest rows
TICK_ROW = "lossy-transatlantic|uniform_huge|untuned|cc8|k4|s0"
#: its steps cut to a few hundred
TICK_STEPS = 300


def _state(scenarios, sweeps, route="kernel"):
    """The loop operands (cloned) of a CPU driver ``sweeps`` sweeps into its
    run, and the driver."""
    drv = TorchFabricSimulation(build_plan(scenarios), device="cpu", fused_step=route)
    drv.start()
    for _ in range(sweeps):
        drv.step()
    return {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}, drv


def _same(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _loop_without_counter(s, max_steps):
    """The plain loop as it ran before the counter: ``fused_rounds_plain``'s
    loop with no water-level cache."""
    st = dict(s)
    steps = torch.zeros_like(st["n_events"])
    stop = torch.full_like(steps, tr.STOP_NONE)
    run = st["act"]
    while True:
        err, stop = fs._stop_errors(st, run, stop)
        run = run & ~err
        if not bool(run.any()):
            break
        guard, custom = fs._plain_step(st, run)
        steps = steps + run.to(torch.int64)
        stop = torch.where(guard, tr.STOP_GUARD, stop)
        stop = torch.where(custom, tr.STOP_CUSTOM, stop)
        go = run & ~guard & ~custom
        capped = go & ~st["done"] & (steps >= max_steps)
        stop = torch.where(go & st["done"], tr.STOP_DONE, stop)
        stop = torch.where(capped, tr.STOP_CAP, stop)
        run = go & ~st["done"] & ~capped
    return {**{k: st[k] for k in fs.ROUND_STATE}, "steps": steps, "stop": stop}


class _Recorder:
    """Records each plain step's water-level inputs: the stepping rows, the
    transferring caps, the pool and the level (``bisect_level``'s)."""

    def __init__(self, monkeypatch):
        self.steps = []
        advance, level = fs._advance_plain, fs.bisect_level

        def advance_rec(act, *args, **kw):
            self.steps.append({"act": act.clone()})
            return advance(act, *args, **kw)

        def level_rec(caps, pool):
            out = level(caps, pool)
            self.steps[-1].update(caps=caps.clone(), pool=pool.clone(), level=out.clone())
            return out

        monkeypatch.setattr(fs, "_advance_plain", advance_rec)
        monkeypatch.setattr(fs, "bisect_level", level_rec)

    def recount(self, slots=1):
        """Each row's steps whose caps and pool_eff are bit for bit those of
        one of the last ``slots`` distinct inputs of its steps (1, its last
        step's, by default), counted row by row in Python with a list in
        least recently used order; asserts each such step's level is the
        one that input gave."""
        S = self.steps[0]["act"].shape[0]
        count = [0] * S
        kept = [[] for _ in range(S)]  # (key, level), least recently used first
        for rec in self.steps:
            pool_eff = torch.clamp(torch.minimum(rec["pool"], lane_sum(rec["caps"])), min=0.0)
            for r in range(S):
                if not bool(rec["act"][r]):
                    continue
                key = (rec["caps"][r].numpy().tobytes(), pool_eff[r].numpy().tobytes())
                hit = [i for i, (k, _) in enumerate(kept[r]) if k == key]
                if hit:
                    count[r] += 1
                    _, level = kept[r].pop(hit[0])
                    assert bool(rec["level"][r] == level), r  # the same level
                elif len(kept[r]) == slots:
                    kept[r].pop(0)
                kept[r].append((key, rec["level"][r].clone()))
        return torch.tensor(count, dtype=torch.int64)


def _tick_row_state():
    sc = next(s for s in full_matrix() if s.name == TICK_ROW)
    return _state([sc], 2)[0]


@pytest.mark.parametrize("case", ["smoke", "tick_row", "resume"])
def test_counter_leaves_the_plain_loop_unchanged(case):
    if case == "tick_row":
        s, cap = _tick_row_state(), 64
    else:
        s, cap = _state(smoke_matrix(), 5)[0], 64
    if case == "resume":  # resume files and ProMC moves off busy channels
        pr = (s["kind"] == tr.KIND_PROMC) & s["act"]
        live = pr.unsqueeze(-1) & ~s["chunk_done"]
        size = torch.ceil(s["avg_fs_k"])
        s["prepend_sizes"][..., :2] = size.unsqueeze(-1)
        s["prepend_n"][live] = 2
        s["queue_bytes"] += torch.where(live, 2 * size, 0.0)
        s["promc_patience"][pr] = 1
        s["promc_ratio"][pr] = 1.0
    got = fs.fused_rounds_plain(s, cap)
    want = _loop_without_counter(s, cap)
    assert set(got) == set(want) | {"reuses"}
    for name, v in want.items():
        assert _same(got[name], v), name
    assert int(got["reuses"].sum()) > 0


def test_tick_only_row_reuses_most_levels(monkeypatch):
    s = _tick_row_state()
    rec = _Recorder(monkeypatch)
    out = fs.fused_rounds_plain(s, TICK_STEPS)
    steps, reuses = int(out["steps"][0]), int(out["reuses"][0])
    assert steps == TICK_STEPS and int(out["stop"][0]) == tr.STOP_CAP
    assert reuses >= 0.9 * steps, (reuses, steps)
    assert torch.equal(out["reuses"], rec.recount())


@pytest.mark.parametrize("case", ["smoke", "resume"])
def test_reuse_count_equals_a_recount_with_completions_and_moves(case, monkeypatch):
    s = _state(smoke_matrix(), 5)[0]
    if case == "resume":
        pr = (s["kind"] == tr.KIND_PROMC) & s["act"]
        s["promc_patience"][pr] = 1
        s["promc_ratio"][pr] = 1.0
    rec = _Recorder(monkeypatch)
    out = fs.fused_rounds_plain(s, 2048)
    assert bool((out["stop"][s["act"]] == tr.STOP_DONE).all())
    moved = out["n_moves"] > s["n_moves"]
    done = out["chunk_done"] & ~s["chunk_done"]
    assert bool(moved.any()) and bool(done.any())  # grants / moves and completions
    assert torch.equal(out["reuses"], rec.recount())
    assert 0 < int(out["reuses"].sum()) < int(out["steps"].sum())


def test_coupled_loop_counts_the_same_reuses(monkeypatch):
    from repro_torch.eval.fabric.driver import TorchFabricSimulation as Sim

    drv = Sim(build_plan(tenant_matrix(n_groups=2)), device="cpu", fused_step="none")
    drv.start()
    for _ in range(3):
        drv.step()
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    rec = _Recorder(monkeypatch)
    out = fs.fused_rounds_coupled_plain(s, drv._fab, 64)
    assert torch.equal(out["reuses"], rec.recount(fs.COUPLED_LEVEL_SLOTS))
    assert int(out["reuses"].sum()) > int(rec.recount().sum()) > 0  # the memory serves more


def test_coupled_loop_counts_the_reuses_of_rows_alone(monkeypatch):
    """Rows outside every group (groups of one) keep the coupled kernel's
    level memory too: the count is the recount with its slots."""
    s = _state(smoke_matrix()[:12], 5)[0]
    S = s["act"].shape[0]
    solo = fs.fabric_operands(np.full(S, -1), np.zeros((0, S), dtype=bool), np.zeros(0))
    rec = _Recorder(monkeypatch)
    out = fs.fused_rounds_coupled_plain(s, solo, 200)
    assert torch.equal(out["reuses"], rec.recount(fs.COUPLED_LEVEL_SLOTS))
    assert int(out["reuses"].sum()) > 0


def test_wrappers_expose_the_reuses():
    s = _state(smoke_matrix(), 5)[0]
    want = fs.fused_rounds_plain(s, 32)
    fs.fused_rounds(s, 32)
    assert fs.fused_rounds.reuses is s["reuses"]
    assert torch.equal(s["reuses"], want["reuses"])


@pytest.mark.parametrize("route", ["rounds", "kernel", "none"])
def test_driver_adds_the_reuses_into_sweep_stats(route, monkeypatch):
    scs = smoke_matrix()[:12]
    seen = []
    real = driver.fused_rounds

    def counted(s, max_steps=fs.ROUND_CAP):
        out = real(s, max_steps)
        seen.append(int(s["reuses"][s["act"]].sum()))
        return out

    monkeypatch.setattr(driver, "fused_rounds", counted)
    monkeypatch.setattr(driver, "ROUND_CAP", 16)  # several launches a row
    stats = SweepStats()
    run_matrix(scs, device="cpu", fused_step=route, stats=stats)
    assert stats.level_reuses == sum(seen)
    assert (stats.level_reuses > 0) == (route == "rounds")
    assert stats.counters()["level_reuses"] == stats.level_reuses


def test_probe_runs_on_the_card_only():
    s = _state(smoke_matrix()[:2], 1)[0]
    assert fs.PROBE_PHASES[3] == "level" and len(fs.PROBE_PHASES) == 9
    with pytest.raises(ValueError, match="card"):
        fs.fused_rounds_probe(s)
    with pytest.raises(ValueError, match="max_steps"):
        fs.fused_rounds_probe(s, 0)


@pytest.mark.parametrize("order", ["interleaved", "blocked"])
def test_chunk_sum_keeps_column_order(order):
    """The loop's per-chunk sum of moved bytes (the plain version's scatter,
    which the kernels' masked walk must equal bit for bit) adds a chunk's
    columns to its total one at a time in column order, whether the other
    chunk's columns lie between them or not: chunk 0's values give another
    sum in any other order."""
    own = {0: [1.0, 1e16, -1e16, 0.5], 1: [2.0, 3.0, 4.0, 5.0]}
    if order == "interleaved":
        chunks = [0, 1] * 4
        vals = [own[c][i] for i in range(4) for c in (0, 1)]
    else:
        chunks = [0] * 4 + [1] * 4
        vals = own[0] + own[1]
    moved = torch.tensor([vals], dtype=torch.float64)
    got = TorchOps.chunk_scatter_add(torch.zeros(1, 2, dtype=torch.float64),
                                     torch.tensor([chunks]), moved, moved != 0.0)
    folds = {}
    for c, x in zip(chunks, vals):  # a left fold in column order
        folds[c] = folds.get(c, 0.0) + x
    assert got[0].tolist() == [folds[0], folds[1]] == [0.5, 14.0]
    backwards = 0.0
    for x in reversed(own[0]):
        backwards += x
    assert backwards != folds[0]
