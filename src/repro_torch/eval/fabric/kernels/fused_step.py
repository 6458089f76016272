"""Fused resume-free sweep steps: the CUDA kernels of ``csrc/fused_step.cu``
and their plain PyTorch versions.

Port of the Pallas kernel ``_fused_kernel``
(``src/repro/eval/fabric/kernels/fused_step_pallas.py``): per scenario
row, ``disk_pool`` -> bisected water-fill -> ``event_horizon`` ->
``advance_channels`` -> the pure-FIFO branch of ``feed_queues``. The
driver routes a sweep here only while no resume file exists anywhere in
the batch. Two entry points:

* :func:`fused_step`, the Pallas kernel's counterpart: one step of every
  active row a launch. Operands, in order: ``act`` (S,) bool; ``busy``
  (S, C) bool; ``dead``, ``rem``, ``cap`` (S, C) float64; ``chunk_of``
  (S, C) int64; ``tick_dt``, ``bw``, ``disk_rate`` (S,) float64;
  ``sat_cc`` (S,) int64; ``contention`` (S,) float64; ``qoff``, ``qlen``,
  ``qptr`` (S, K) int64; ``queue_bytes``, ``fsdt`` (S, K) float64;
  ``qsizes`` (Q,) float64. Returns ``(dt, rate_sum, fin_any, busy, dead,
  rem, moved, qptr, queue_bytes)``; inactive rows pass through with
  ``dt = 0``.
* :func:`fused_rounds`, the reference's device loop (``jax_backend``'s
  phase A inside a ``lax.while_loop``) for the card: each active row takes
  steps until the host has something to decide, up to ``max_steps``
  (:data:`ROUND_CAP`, the reference's), updating the driver's state
  tensors in place. A step is :func:`fused_step`'s plus the profile
  lookup, the clock, the event count and the ``delivered`` scatter; a row
  stops after the step with a chunk completion, a ProMC tick, no busy
  channel, a timeline sample, ``t > max_time`` or the cap, and leaves
  that step's transition half (the driver's ``_post``) to the host. A row
  that goes on past a tick applies the tick's bookkeeping (``tick_ema``,
  ``delivered_at_tick``, ``next_tick``) itself.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _cuda_build as _build
from ..shim import TorchOps
from . import (
    advance_channels, bandwidth_now, disk_pool, event_horizon, feed_queues,
    tick_ema,
)
from .waterfill_bisect import bisect_level

_EPS = 1e-12

#: the kernels' CUDA source
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_step.cu"

#: steps a row may take in one :func:`fused_rounds` launch (the
#: reference's ``_ROUND_CAP``)
ROUND_CAP = 2048

#: the driver's kind code of ProMC rows, whose ticks the host decides
KIND_PROMC = 4

#: :func:`fused_rounds`' operands by name: (dtype, axes) in the kernel's
#: pointer order. The first group is read, the second updated in place,
#: the third written.
ROUND_INPUTS = {
    "act": (torch.bool, "S"), "tick_period": (torch.float64, "S"),
    "max_time": (torch.float64, "S"), "record_timeline": (torch.bool, "S"),
    "kind": (torch.int64, "S"), "cap": (torch.float64, "SC"),
    "chunk_of": (torch.int64, "SC"), "bw": (torch.float64, "S"),
    "disk_rate": (torch.float64, "S"), "sat_cc": (torch.int64, "S"),
    "contention": (torch.float64, "S"), "prof_t": (torch.float64, "SB"),
    "prof_mult": (torch.float64, "SB"), "qoff": (torch.int64, "SK"),
    "qlen": (torch.int64, "SK"), "fsdt": (torch.float64, "SK"),
    "chunk_done": (torch.bool, "SK"), "qsizes": (torch.float64, "Q"),
}
ROUND_STATE = {
    "t": (torch.float64, "S"), "n_events": (torch.int64, "S"),
    "fin_any": (torch.bool, "S"), "next_tick": (torch.float64, "S"),
    "busy": (torch.bool, "SC"), "dead": (torch.float64, "SC"),
    "rem": (torch.float64, "SC"), "qptr": (torch.int64, "SK"),
    "queue_bytes": (torch.float64, "SK"), "delivered": (torch.float64, "SK"),
    "delivered_at_tick": (torch.float64, "SK"), "rate_est": (torch.float64, "SK"),
}
#: per row: the steps taken, and the last step's rate sum and start time
#: (a timeline sample)
ROUND_OUTPUTS = {
    "steps": (torch.int64, "S"), "rate_sum": (torch.float64, "S"),
    "t0": (torch.float64, "S"),
}
ROUND_OPERANDS = {**ROUND_INPUTS, **ROUND_STATE, **ROUND_OUTPUTS}

#: argument types of the kernels' C entry points
_ARGTYPES = {
    "fused_step_f64": [ctypes.c_void_p] * 26 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p],
    "fused_rounds_f64": [ctypes.c_void_p] + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A C entry point of the kernels' library, built and loaded at first
    use."""
    fn = getattr(_build.load(SOURCE), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def fused_step_plain(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """Plain PyTorch version of the one-step kernel, composed of the fluid
    kernels."""
    transferring = busy & (dead <= _EPS)
    pool = disk_pool(transferring.sum(dim=-1), bw, disk_rate, sat_cc, contention)
    caps = torch.where(transferring, cap, 0.0)
    level = bisect_level(caps, pool)
    rates = torch.where(
        act.unsqueeze(-1), torch.minimum(caps, level.unsqueeze(-1)), 0.0
    )
    dt = event_horizon(tick_dt, busy, dead, transferring, rem, rates)
    dt = torch.where(act, dt, 0.0)
    busy2, dead2, rem2, moved, finished = advance_channels(
        act, dt, busy, dead, transferring, rem, rates
    )
    busy3, dead3, rem3, qptr2, qb2, _ = feed_queues(
        act, chunk_of, busy2, dead2, rem2, qsizes, qoff, qlen, qptr,
        queue_bytes, fsdt,
    )
    return (
        dt, rates.sum(dim=-1), finished.any(dim=-1), busy3, dead3, rem3,
        moved, qptr2, qb2,
    )


def fused_step(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """One fused sweep step. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (C and K up to
    1024; no launch for zero rows)."""
    args = (
        act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
        contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
    )
    if busy.dim() != 2 or qptr.dim() != 2:
        raise ValueError("busy must be (S, C) and qptr (S, K)")
    if busy.device.type == "cpu":
        return fused_step_plain(*args)
    if busy.device.type != "cuda":
        raise ValueError(f"unsupported device {busy.device}")
    S, C = busy.shape
    K = qptr.shape[1]
    Q = qsizes.shape[0]
    if C > 1024 or K > 1024 or Q == 0:
        raise ValueError(f"the fused-step kernel takes C, K <= 1024 and Q > 0, got {C}, {K}, {Q}")
    dev = busy.device
    b, f8, i8 = torch.bool, torch.float64, torch.int64
    specs = (
        ("act", b, (S,)), ("busy", b, (S, C)), ("dead", f8, (S, C)),
        ("rem", f8, (S, C)), ("cap", f8, (S, C)), ("chunk_of", i8, (S, C)),
        ("tick_dt", f8, (S,)), ("bw", f8, (S,)), ("disk_rate", f8, (S,)),
        ("sat_cc", i8, (S,)), ("contention", f8, (S,)),
        ("qoff", i8, (S, K)), ("qlen", i8, (S, K)), ("qptr", i8, (S, K)),
        ("queue_bytes", f8, (S, K)), ("fsdt", f8, (S, K)),
        ("qsizes", f8, (Q,)),
    )
    ptrs = [
        _build.check(t, name, dtype, shape, dev)
        for t, (name, dtype, shape) in zip(args, specs)
    ]
    outs = (
        torch.empty((S,), dtype=f8, device=dev),
        torch.empty((S,), dtype=f8, device=dev),
        torch.empty((S,), dtype=b, device=dev),
        torch.empty((S, C), dtype=b, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, K), dtype=i8, device=dev),
        torch.empty((S, K), dtype=f8, device=dev),
    )
    if S == 0:
        return outs
    fn = _entry("fused_step_f64")
    with torch.cuda.device(dev):
        err = fn(
            *ptrs, *(o.data_ptr() for o in outs), S, C, K, Q,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused-step kernel launch failed: cudaError {err}")
    fused_step.launches += 1
    return outs


#: launches of the one-step CUDA kernel in this process
fused_step.launches = 0


def fused_rounds_plain(s, max_steps: int = ROUND_CAP):
    """Plain PyTorch version of the loop kernel on the operands ``s`` (a
    mapping of :data:`ROUND_OPERANDS` names to tensors; the outputs may be
    absent): every iteration is :func:`fused_step_plain` on the rows still
    running, then the driver's own bookkeeping (clock, event count,
    ``delivered`` scatter, tick EMA) and the stop test, masked per row.
    Returns new tensors for every name of :data:`ROUND_STATE` and
    :data:`ROUND_OUTPUTS`; ``s`` is left as it was."""
    act = s["act"]
    t, n_events, fin_any, next_tick = s["t"], s["n_events"], s["fin_any"], s["next_tick"]
    busy, dead, rem = s["busy"], s["dead"], s["rem"]
    qptr, qb = s["qptr"], s["queue_bytes"]
    delivered, dat, rate_est = s["delivered"], s["delivered_at_tick"], s["rate_est"]
    chunk_of, period = s["chunk_of"], s["tick_period"]
    promc = s["kind"] == KIND_PROMC
    K = qptr.shape[-1]
    steps = torch.zeros_like(n_events)
    rate_sum = torch.zeros_like(t)
    t0 = t
    run = act
    while bool(run.any()):
        eff_bw, next_prof = bandwidth_now(s["bw"], s["prof_t"], s["prof_mult"], t)
        dt, rs, fin, busy, dead, rem, moved, qptr, qb = fused_step_plain(
            run, busy, dead, rem, s["cap"], chunk_of,
            torch.minimum(next_tick - t, next_prof - t), eff_bw, s["disk_rate"],
            s["sat_cc"], s["contention"], s["qoff"], s["qlen"], qptr, qb,
            s["fsdt"], s["qsizes"],
        )
        t0 = torch.where(run, t, t0)
        rate_sum = torch.where(run, rs, rate_sum)
        t = t + dt  # dt is 0 on rows that do not run
        n_events = n_events + run.to(torch.int64)
        steps = steps + run.to(torch.int64)
        fin_any = torch.where(run, fin, fin_any)
        delivered = TorchOps.chunk_scatter_add(delivered, chunk_of, moved, moved != 0.0)
        # the stop test: what the host's _post would decide
        busy_per_chunk = TorchOps.count_by_chunk(chunk_of, busy, K)
        completes = (
            ~s["chunk_done"] & (s["qlen"] - qptr == 0) & (busy_per_chunk == 0)
        ).any(dim=-1)
        tick = t >= next_tick - _EPS
        stop = run & (
            completes | (tick & promc) | ~busy.any(dim=-1) | s["record_timeline"]
            | (t > s["max_time"]) | (steps >= max_steps)
        )
        # rows that go on take the tick's bookkeeping of _post here
        ticked = run & ~stop & tick
        rows = ticked.unsqueeze(-1)
        ema = tick_ema(rate_est, delivered, dat, period.unsqueeze(-1))
        rate_est = torch.where(rows, ema, rate_est)
        dat = torch.where(rows, delivered, dat)
        next_tick = next_tick + torch.where(ticked, period, 0.0)
        run = run & ~stop
    return {
        "t": t, "n_events": n_events, "fin_any": fin_any, "next_tick": next_tick,
        "busy": busy, "dead": dead, "rem": rem, "qptr": qptr, "queue_bytes": qb,
        "delivered": delivered, "delivered_at_tick": dat, "rate_est": rate_est,
        "steps": steps, "rate_sum": rate_sum, "t0": t0,
    }


def fused_rounds(s, max_steps: int = ROUND_CAP):
    """Every active row of ``s`` (a mapping of :data:`ROUND_OPERANDS` names
    to tensors) takes steps until the host has a decision or ``max_steps``;
    the state and output tensors are updated in place. Returns
    ``s["steps"]``. CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream (C and K up to 1024; no launch for
    zero rows)."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be at least 1, got {max_steps}")
    busy = s["busy"]
    if busy.dim() != 2 or s["qptr"].dim() != 2 or s["prof_t"].dim() != 2:
        raise ValueError("busy must be (S, C), qptr (S, K) and prof_t (S, B)")
    if busy.device.type == "cpu":
        for name, new in fused_rounds_plain(s, max_steps).items():
            s[name].copy_(new)
        return s["steps"]
    if busy.device.type != "cuda":
        raise ValueError(f"unsupported device {busy.device}")
    S, C = busy.shape
    dims = {"S": S, "C": C, "K": s["qptr"].shape[1], "B": s["prof_t"].shape[1],
            "Q": s["qsizes"].shape[0]}
    if C > 1024 or dims["K"] > 1024 or dims["Q"] == 0:
        raise ValueError(
            f"the fused-rounds kernel takes C, K <= 1024 and Q > 0, got {C}, "
            f"{dims['K']}, {dims['Q']}"
        )
    dev = busy.device
    ptrs = (ctypes.c_void_p * len(ROUND_OPERANDS))(*(
        _build.check(s[name], name, dtype, tuple(dims[a] for a in axes), dev)
        for name, (dtype, axes) in ROUND_OPERANDS.items()
    ))
    if S == 0:
        return s["steps"]
    fn = _entry("fused_rounds_f64")
    with torch.cuda.device(dev):
        err = fn(
            ptrs, S, C, dims["K"], dims["B"], dims["Q"], max_steps,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused-rounds kernel launch failed: cudaError {err}")
    fused_rounds.launches += 1
    return s["steps"]


#: launches of the loop kernel in this process
fused_rounds.launches = 0
