"""The fused-rounds loop and the sweep driver's ``"rounds"`` route on the
CPU.

* ``fused_rounds_plain`` (the plain version of the loop kernel: every
  row's steps and transitions until it is done, errs, meets a capacity
  guard or reaches the step cap) against a loop written out here row by
  row: each row alone, one step at a time in Python control flow (the
  profile lookup and the ``delivered`` scatter in Python floats, the
  physics of ``_advance_plain``, the feed with the resume stack, the
  timeline push, the guards, and ``transition.post_transition`` with the
  row's own hints: its completed chunks, whether it ticks, and C as the
  grant bound), up to the row's stop. On live driver states pushed to each
  stop (done, cap, max_time, stranded, either guard) and to each thing a
  row now does inside the loop (a completion, a tick, a ProMC tick, a
  profile step, a step that ends with no busy channel, timeline samples
  and ring halvings, resume pushes). Bit-identical: both run the same
  float64 operations in the same order.
* The ``"rounds"`` route of ``TorchFabricSimulation`` against the one-step
  ``"kernel"`` route, whose sweeps the reference's NumPy driver and the
  goldens hold (``tests/test_torch_runner.py``): bit-identical results,
  and fewer host rounds for the same row steps.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch.eval.fabric import driver, kernels
from repro_torch.eval.fabric import transition as tr
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import default_matrix, full_matrix, smoke_matrix

SEEDS = [0, 1]
#: steps a row may take in the loop tests (the "cap" case uses fewer)
MAX_STEPS = 64
EPS = 1e-12
_TIMELINE = ("tl_t", "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate")


def _scenarios():
    """The smoke matrix plus three full-grid rows on the time-varying
    "steppy-backbone" testbed (a bandwidth profile with steps at 12, 45
    and 120 s)."""
    steppy = [s for s in full_matrix() if s.name.startswith("steppy-backbone|")]
    return smoke_matrix() + steppy[:3]


def _live_state(seed):
    """A driver part-way through its run on the one-step route (5 + 20 *
    seed sweeps in), and the loop's operands on it, cloned."""
    drv = TorchFabricSimulation(build_plan(_scenarios()), device="cpu", fused_step="kernel")
    drv.start()
    for _ in range(5 + 20 * seed):
        drv.step()
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    return drv, s


def _same(a, b):
    """Equal tensors, NaN matching NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _reference_row(s, r, max_steps):
    """Row ``r`` of ``s`` alone, step by step to its stop. Returns its state
    (tensors shaped like ``s``'s row ``r``), its steps, its stop code and
    what it did on the way."""
    row = {k: (v if k == "qsizes" else v[r: r + 1].clone()) for k, v in s.items()}
    seen, steps = set(), 0
    if not bool(row["act"]):
        return row, steps, tr.STOP_NONE, seen
    one = torch.ones(1, dtype=torch.bool)
    f64 = lambda x: torch.tensor([x], dtype=torch.float64)  # noqa: E731
    K = row["qptr"].shape[1]
    kind = int(row["kind"])
    prof_t, prof_mult = row["prof_t"][0].tolist(), row["prof_mult"][0].tolist()
    bw0, last_at = float(row["bw"]), None
    while True:
        t = float(row["t"])
        if t > float(row["max_time"]):
            seen.add("max_time")
            return row, steps, tr.STOP_ERROR, seen
        if bool(tr.stranded(row, one)):
            seen.add("stranded")
            return row, steps, tr.STOP_ERROR, seen
        if len(prof_t) == 1:
            bw, next_prof = bw0, math.inf
        else:
            at = sum(p <= t for p in prof_t) - 1
            bw = bw0 * (prof_mult[max(at, 0)] if at >= 0 else 1.0)
            next_prof = min([p for p in prof_t if p > t], default=math.inf)
            if last_at is not None and at != last_at:
                seen.add("profile")
            last_at = at
        chunk_of = row["chunk_of"][0].tolist()
        dt, rs, fin, row["busy"], row["dead"], row["rem"], moved = fs._advance_plain(
            one, row["busy"], row["dead"], row["rem"], row["cap"],
            f64(min(float(row["next_tick"]) - t, next_prof - t)), f64(bw),
            row["disk_rate"], row["sat_cc"], row["contention"],
        )
        tr.feed(row, one)
        if bool(row["record_timeline"]):
            stride = int(row["tl_stride"])
            row.update(zip(_TIMELINE, kernels.timeline_push(
                one, f64(t), rs, *(row[k] for k in _TIMELINE)
            )))
            seen.add("timeline")
            if int(row["tl_stride"]) > stride:
                seen.add("halving")
        row["t"] = f64(t + float(dt))
        row["n_events"] = row["n_events"] + 1
        row["fin_any"] = fin
        steps += 1
        delivered = row["delivered"][0].tolist()
        for c, m in enumerate(moved[0].tolist()):
            if m != 0.0:
                delivered[chunk_of[c]] += m
        row["delivered"] = torch.tensor([delivered], dtype=torch.float64)
        if not bool(row["busy"].any()):
            seen.add("no_busy")
        completed, tick_hit = tr.completions(row, one)
        comp_ks = [k for k in range(K) if completed[0, k]]
        if bool(tr.stack_full(row, tick_hit)):
            seen.add("stack_guard")
            return row, steps, tr.STOP_GUARD, seen
        if comp_ks and bool(tr.sc_short(row, completed)):
            seen.add("sc_guard")
            return row, steps, tr.STOP_GUARD, seen
        if comp_ks:
            seen.add("completion")
        if bool(tick_hit):
            seen.add("promc_tick" if kind == tr.KIND_PROMC else "tick")
        sizes = row["prepend_sizes"].clone()
        tr.post_transition(
            row, one, completed, tick_hit,
            ks_sc=comp_ks if kind == tr.KIND_SC else [],
            ks_mc=comp_ks if kind in (tr.KIND_MC, tr.KIND_PROMC) else [],
            grant_iters=row["busy"].shape[1], tick=bool(tick_hit),
            promc=bool(tick_hit) and kind == tr.KIND_PROMC,
        )
        if not torch.equal(row["prepend_sizes"], sizes):
            seen.add("resume")
        if bool(row["done"]):
            seen.add("done")
            return row, steps, tr.STOP_DONE, seen
        if steps >= max_steps:
            seen.add("cap")
            return row, steps, tr.STOP_CAP, seen


def _push(reason, s, seed):
    """Mutate the live operands ``s`` so that some row meets ``reason``;
    returns the step cap to run with."""
    r = 2 + 5 * seed
    kind, act = s["kind"], s["act"]
    if reason == "no_busy":  # an idle row whose queues ran dry
        s["busy"][r] = False
        s["qptr"][r] = s["qlen"][r]
    elif reason == "stranded":  # a row whose channels were all closed
        for name, empty in (("chunk_of", -1), ("busy", False), ("dead", 0.0), ("rem", 0.0),
                            ("cap", 0.0)):
            s[name][r] = empty
    elif reason == "max_time":
        s["max_time"].copy_(s["t"] + 0.5 + seed)
    elif reason == "timeline":  # recording rows in a ring of 8 samples
        S = act.shape[0]
        s["record_timeline"][seed::2] = True
        for name, shape, fill in (("tl_t", (S, 8), 0.0), ("tl_rate", (S, 8), 0.0),
                                  ("tl_len", (S,), 0), ("tl_stride", (S,), 1),
                                  ("tl_seen", (S,), 0), ("tl_last_t", (S,), 0.0),
                                  ("tl_last_rate", (S,), 0.0)):
            s[name] = torch.full(shape, fill, dtype=s[name].dtype)
    elif reason == "profile":  # the steppy rows' profile steps just ahead
        s["prof_t"][-3:, 1:4] = s["t"][-3:, None] + torch.tensor([0.25, 0.5, 1.0]) * (1 + seed)
    elif reason == "sc_guard":  # SC waves wider than the channel axis
        s["conc"][kind == tr.KIND_SC] = s["busy"].shape[1] + 1
    elif reason == "stack_guard":  # ProMC rows ticking with a full stack
        pr = (kind == tr.KIND_PROMC) & act
        s["prepend_sizes"] = torch.full(s["prepend_sizes"].shape[:2] + (1,), 4.0e6,
                                        dtype=torch.float64)
        s["prepend_n"][pr.unsqueeze(-1) & ~s["chunk_done"]] = 1000
        s["next_tick"][pr] = s["t"][pr]
    elif reason == "resume":  # resume files on the ProMC rows, patience 1
        pr = (kind == tr.KIND_PROMC) & act
        live = pr.unsqueeze(-1) & ~s["chunk_done"]
        size = torch.ceil(s["avg_fs_k"])
        s["prepend_sizes"][..., :2] = size.unsqueeze(-1)
        s["prepend_n"][live] = 2
        s["queue_bytes"] += torch.where(live, 2 * size, 0.0)
        s["promc_patience"][pr] = 1
        s["promc_ratio"][pr] = 1.0
        s["next_tick"][pr] = s["t"][pr]
    return 3 + seed if reason == "cap" else MAX_STEPS


REASONS = ["completion", "promc_tick", "tick", "profile", "no_busy", "max_time",
           "timeline", "cap", "done", "stranded", "sc_guard", "stack_guard", "resume"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("reason", REASONS)
def test_rounds_plain_equals_a_row_by_row_loop(reason, seed):
    _, s = _live_state(seed)
    max_steps = _push(reason, s, seed)
    before = {k: v.clone() for k, v in s.items()}
    got = fs.fused_rounds_plain(s, max_steps)
    assert all(_same(s[k], before[k]) for k in s)  # s is left as it was
    assert set(got) == set(fs.ROUND_STATE) | set(fs.ROUND_OUTPUTS)
    seen = set()
    for r in range(s["act"].shape[0]):
        row, steps, stop, row_seen = _reference_row(s, r, max_steps)
        for name in fs.ROUND_STATE:
            assert _same(got[name][r: r + 1], row[name]), (reason, r, name)
        assert got["steps"][r].item() == steps, (reason, r)
        assert got["stop"][r].item() == stop, (reason, r)
        seen |= row_seen
    assert int(got["steps"].sum()) > int(s["act"].sum())  # the loop went past one step
    assert reason in seen
    if reason == "timeline":
        assert "halving" in seen


def test_rounds_wrapper_runs_the_plain_version_on_cpu_tensors_in_place():
    _, s = _live_state(0)
    want = fs.fused_rounds_plain(s, MAX_STEPS)
    before = fs.fused_rounds.launches
    steps = fs.fused_rounds(s, MAX_STEPS)
    assert fs.fused_rounds.launches == before  # no kernel on the CPU
    assert steps is s["steps"]
    for name, v in want.items():
        assert _same(s[name], v), name
    with pytest.raises(ValueError, match="max_steps"):
        fs.fused_rounds(s, 0)


def _identical(a, b):
    for x, y in zip(a, b):
        assert x.total_time == y.total_time and x.n_events == y.n_events
        assert x.n_moves == y.n_moves and x.total_bytes == y.total_bytes
        assert x.per_chunk_bytes == y.per_chunk_bytes
        assert x.per_chunk_time == y.per_chunk_time
        assert x.timeline == y.timeline


def _compacting_subset():
    """The default-grid subset of
    ``test_compacting_batch_with_timelines_matches_the_reference``: every
    third row, half of them recording timelines."""
    return [
        dataclasses.replace(default_matrix()[i], record_timeline=i % 2 == 0)
        for i in range(0, 276, 3)
    ]


@pytest.mark.parametrize("matrix", ["smoke", "compacting", "steppy"])
@pytest.mark.parametrize("round_cap", [fs.ROUND_CAP, 5])
def test_rounds_route_is_bit_identical_to_the_one_step_route(matrix, round_cap, monkeypatch):
    scs = {
        "smoke": smoke_matrix,
        "compacting": _compacting_subset,
        "steppy": lambda: _scenarios()[-3:] + smoke_matrix()[:6],
    }[matrix]()
    monkeypatch.setattr(driver, "ROUND_CAP", round_cap)
    out, drivers = {}, {}
    for route in ("kernel", "rounds"):
        drv = drivers[route] = TorchFabricSimulation(
            build_plan(scs), device="cpu", fused_step=route
        )
        out[route] = drv.run()
    _identical(out["rounds"], out["kernel"])
    k, r = drivers["kernel"].stats, drivers["rounds"].stats
    assert r.steps == k.steps == sum(x.n_events for x in out["kernel"])
    assert r.fused == r.sweeps < k.sweeps and r.host_transitions == 0
    if matrix == "compacting" and round_cap == 5:
        assert drivers["rounds"].S < len(scs)  # rows retired by compaction
    if matrix == "compacting":
        assert sum(len(x.timeline) > 0 for x in out["rounds"]) == len(scs[::2])


def test_rounds_route_takes_fewer_host_rounds_for_the_same_steps():
    """The default grid: the same row steps (and results) in one host round
    (no row needs 2,048 steps) against the one-step route's 213 sweeps."""
    scs = default_matrix()
    stats = {route: SweepStats() for route in ("kernel", "rounds")}
    out = {route: run_matrix(scs, device="cpu", fused_step=route, stats=st)
           for route, st in stats.items()}
    _identical(out["rounds"], out["kernel"])
    k, r = stats["kernel"], stats["rounds"]
    assert r.steps == k.steps == sum(x.n_events for x in out["kernel"])
    assert k.sweeps == 213 and r.sweeps == 1
    assert r.host_syncs < k.host_syncs and r.host_transitions == 0
