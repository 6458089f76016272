"""The fused-rounds loop and the sweep driver's ``"rounds"`` route on the
CPU.

* ``fused_rounds_plain`` (the plain version of the loop kernel) against a
  loop written out here row by row: each row alone, one
  ``fused_step_plain`` a step, and the driver's bookkeeping in Python
  floats (the profile lookup, the clock, the event count, the
  ``delivered`` scatter in column order, the tick EMA) up to the stop
  test. On live driver states pushed to each stop reason. Bit-identical:
  both run the same float64 operations in the same order.
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

from repro_torch.eval.fabric import driver
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import default_matrix, full_matrix, smoke_matrix

SEEDS = [0, 1]
#: steps a row may take in the loop tests (rows meet their stop reasons
#: well within it; the "cap" case uses fewer)
MAX_STEPS = 64
EPS = 1e-12


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


def _reference_row(s, r, max_steps):
    """Row ``r`` of ``s`` alone, step by step to its stop. Returns its state
    and outputs (tensors shaped like ``s``'s row ``r``), the stop reasons
    of its last step, the ticks it took in the loop and the profile steps
    it crossed."""
    row = {k: (v if k == "qsizes" else v[r: r + 1].clone()) for k, v in s.items()}
    t = float(row["t"])
    out = {"steps": 0, "rate_sum": 0.0, "t0": t}
    if not bool(row["act"]):
        return row, out, set(), 0, 0
    f64 = lambda x: torch.tensor([x], dtype=torch.float64)  # noqa: E731
    chunk_of = row["chunk_of"][0].tolist()
    C, K = row["busy"].shape[1], row["qptr"].shape[1]
    prof_t, prof_mult = row["prof_t"][0].tolist(), row["prof_mult"][0].tolist()
    bw0, period = float(row["bw"]), float(row["tick_period"])
    next_tick, n_events = float(row["next_tick"]), int(row["n_events"])
    delivered = row["delivered"][0].tolist()
    dat, rate = row["delivered_at_tick"][0].tolist(), row["rate_est"][0].tolist()
    busy, dead, rem = row["busy"], row["dead"], row["rem"]
    qptr, qb = row["qptr"], row["queue_bytes"]
    steps, ticks, crossed, last_at = 0, 0, 0, None
    while True:
        if len(prof_t) == 1:
            bw, next_prof = bw0, math.inf
        else:
            at = sum(p <= t for p in prof_t) - 1
            bw = bw0 * (prof_mult[max(at, 0)] if at >= 0 else 1.0)
            next_prof = min([p for p in prof_t if p > t], default=math.inf)
            crossed += last_at is not None and at != last_at
            last_at = at
        dt, rs, fin, busy, dead, rem, moved, qptr, qb = fs.fused_step_plain(
            row["act"], busy, dead, rem, row["cap"], row["chunk_of"],
            f64(min(next_tick - t, next_prof - t)), f64(bw), row["disk_rate"],
            row["sat_cc"], row["contention"], row["qoff"], row["qlen"], qptr, qb,
            row["fsdt"], row["qsizes"],
        )
        out["t0"], out["rate_sum"] = t, float(rs)
        t = t + float(dt)
        n_events += 1
        steps += 1
        for c, m in enumerate(moved[0].tolist()):
            if m != 0.0:
                delivered[chunk_of[c]] += m
        busy_k = [0] * K
        for c, b in enumerate(busy[0].tolist()):
            if b and 0 <= chunk_of[c] < K:
                busy_k[chunk_of[c]] += 1
        left = (row["qlen"][0] - qptr[0]).tolist()
        done = row["chunk_done"][0].tolist()
        tick = t >= next_tick - EPS
        reasons = {
            name for name, hit in (
                ("completion", any(not done[k] and left[k] == 0 and busy_k[k] == 0
                                   for k in range(K))),
                ("promc_tick", tick and int(row["kind"]) == fs.KIND_PROMC),
                ("no_busy", not any(busy[0].tolist())),
                ("timeline", bool(row["record_timeline"])),
                ("max_time", t > float(row["max_time"])),
                ("cap", steps >= max_steps),
            ) if hit
        }
        if reasons:
            break
        if tick:
            for k in range(K):
                inst = (delivered[k] - dat[k]) / period
                rate[k] = inst if rate[k] == 0.0 else 0.5 * rate[k] + 0.5 * inst
                dat[k] = delivered[k]
            next_tick = next_tick + period
            ticks += 1
    row.update(
        t=f64(t), n_events=torch.tensor([n_events]), fin_any=fin, next_tick=f64(next_tick),
        busy=busy, dead=dead, rem=rem, qptr=qptr, queue_bytes=qb,
        delivered=torch.tensor([delivered], dtype=torch.float64),
        delivered_at_tick=torch.tensor([dat], dtype=torch.float64),
        rate_est=torch.tensor([rate], dtype=torch.float64),
    )
    out["steps"] = steps
    return row, out, reasons, ticks, crossed


def _push(reason, s, seed):
    """Mutate the live operands ``s`` so that some row meets ``reason``;
    returns the step cap to run with."""
    r = 2 + 5 * seed
    if reason == "no_busy":  # an idle row whose queues ran dry
        s["busy"][r] = False
        s["qptr"][r] = s["qlen"][r]
    elif reason == "max_time":
        s["max_time"].copy_(s["t"] + 0.5 + seed)
    elif reason == "timeline":
        s["record_timeline"][seed::2] = True
    elif reason == "profile":  # the steppy rows' profile steps just ahead
        s["prof_t"][-3:, 1:4] = s["t"][-3:, None] + torch.tensor([0.25, 0.5, 1.0]) * (1 + seed)
    return 3 + seed if reason == "cap" else MAX_STEPS


REASONS = ["completion", "promc_tick", "tick", "profile", "no_busy", "max_time",
           "timeline", "cap"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("reason", REASONS)
def test_rounds_plain_equals_a_row_by_row_loop(reason, seed):
    _, s = _live_state(seed)
    max_steps = _push(reason, s, seed)
    before = {k: v.clone() for k, v in s.items()}
    got = fs.fused_rounds_plain(s, max_steps)
    assert all(torch.equal(s[k], before[k]) for k in s)  # s is left as it was
    assert set(got) == set(fs.ROUND_STATE) | set(fs.ROUND_OUTPUTS)
    seen, ticks, crossed = set(), 0, 0
    for r in range(s["act"].shape[0]):
        row, out, reasons, n_ticks, n_crossed = _reference_row(s, r, max_steps)
        for name in fs.ROUND_STATE:
            assert torch.equal(got[name][r: r + 1], row[name]), (reason, r, name)
        for name, v in out.items():
            assert got[name][r].item() == v, (reason, r, name)
        seen |= reasons
        ticks += n_ticks
        crossed += n_crossed
    assert int(got["steps"].sum()) > int(s["act"].sum())  # the loop went past one step
    if reason == "tick":
        assert ticks > 0  # a non-ProMC row refreshed its rate estimates in the loop
    elif reason == "profile":
        assert crossed > 0  # a row stepped past a bandwidth-profile step in the loop
    else:
        assert reason in seen


def test_rounds_wrapper_runs_the_plain_version_on_cpu_tensors_in_place():
    _, s = _live_state(0)
    want = fs.fused_rounds_plain(s, MAX_STEPS)
    before = fs.fused_rounds.launches
    steps = fs.fused_rounds(s, MAX_STEPS)
    assert fs.fused_rounds.launches == before  # no kernel on the CPU
    assert steps is s["steps"]
    for name, v in want.items():
        assert torch.equal(s[name], v), name
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
    assert r.fused == r.sweeps < k.sweeps
    if matrix == "compacting":
        assert drivers["rounds"].S < len(scs)  # rows retired by compaction
        assert sum(len(x.timeline) > 0 for x in out["rounds"]) == len(scs[::2])


def test_rounds_route_takes_fewer_host_rounds_for_the_same_steps():
    """The default grid: the same row steps (and results) in about half the
    host rounds of the one-step route's 213 sweeps."""
    scs = default_matrix()
    stats = {route: SweepStats() for route in ("kernel", "rounds")}
    out = {route: run_matrix(scs, device="cpu", fused_step=route, stats=st)
           for route, st in stats.items()}
    _identical(out["rounds"], out["kernel"])
    k, r = stats["kernel"], stats["rounds"]
    assert r.steps == k.steps == sum(x.n_events for x in out["kernel"])
    assert k.sweeps == 213 and r.sweeps < k.sweeps
    assert r.host_syncs < k.host_syncs
