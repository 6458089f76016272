"""Fused sweep steps: the CUDA kernels of ``csrc/fused_step.cu`` and their
plain PyTorch versions.

Port of the Pallas kernel ``_fused_kernel``
(``src/repro/eval/fabric/kernels/fused_step_pallas.py``): per scenario
row, ``disk_pool`` -> bisected water-fill -> ``event_horizon`` ->
``advance_channels`` -> the pure-FIFO branch of ``feed_queues``, and of
the reference's device loop around it (``jax_backend``'s four phases in a
``lax.while_loop``). Two entry points:

* :func:`fused_step`, the Pallas kernel's counterpart: one step of every
  active row a launch, for sweeps with no resume file in the batch.
  Operands, in order: ``act`` (S,) bool; ``busy`` (S, C) bool; ``dead``,
  ``rem``, ``cap`` (S, C) float64; ``chunk_of`` (S, C) int64; ``tick_dt``,
  ``bw``, ``disk_rate`` (S,) float64; ``sat_cc`` (S,) int64;
  ``contention`` (S,) float64; ``qoff``, ``qlen``, ``qptr`` (S, K) int64;
  ``queue_bytes``, ``fsdt`` (S, K) float64; ``qsizes`` (Q,) float64.
  Returns ``(dt, rate_sum, fin_any, busy, dead, rem, moved, qptr,
  queue_bytes)``; inactive rows pass through with ``dt = 0``.
* :func:`fused_rounds`, the whole device loop for the card: each active
  row takes steps until it is done, errs, meets a capacity guard or has
  taken ``max_steps`` (:data:`ROUND_CAP`, the reference's), updating the
  driver's state tensors in place and writing each row's steps and stop
  code (``transition.STOP_*``). A step is :func:`fused_step`'s with the
  profile lookup, the resume-stack feed, the timeline push, the clock,
  the event count and the ``delivered`` scatter, then the transition of
  :func:`..transition.post_transition` (completions, handlers in chunk
  order with a re-feed after each, the tick with ProMC's move, the done
  test). A row at a guard stops before that transition, which the host
  takes.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _cuda_build as _build
from .. import transition
from ..shim import TorchOps
from . import (
    advance_channels, bandwidth_now, disk_pool, event_horizon, feed_queues,
    timeline_push,
)
from .waterfill_bisect import bisect_level

_EPS = 1e-12

#: the kernels' CUDA source
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_step.cu"

#: steps a row may take in one :func:`fused_rounds` launch (the
#: reference's ``_ROUND_CAP``)
ROUND_CAP = 2048

#: :func:`fused_rounds`' operands by name: (dtype, axes) in the kernel's
#: pointer order. The first group is read, the second updated in place,
#: the third written. Axes: S rows, C channels, K chunks, B profile steps,
#: Q file sizes, P resume-stack depth, T timeline samples.
ROUND_INPUTS = {
    "act": (torch.bool, "S"), "tick_period": (torch.float64, "S"),
    "max_time": (torch.float64, "S"), "record_timeline": (torch.bool, "S"),
    "kind": (torch.int64, "S"), "trivial_complete": (torch.bool, "S"),
    "n_chunks": (torch.int64, "S"), "bw": (torch.float64, "S"),
    "disk_rate": (torch.float64, "S"), "sat_cc": (torch.int64, "S"),
    "contention": (torch.float64, "S"), "setup_cost": (torch.float64, "S"),
    "promc_ratio": (torch.float64, "S"), "promc_patience": (torch.int64, "S"),
    "prof_t": (torch.float64, "SB"), "prof_mult": (torch.float64, "SB"),
    "qoff": (torch.int64, "SK"), "qlen": (torch.int64, "SK"),
    "fsdt": (torch.float64, "SK"), "nfiles": (torch.int64, "SK"),
    "sc_order": (torch.int64, "SK"), "conc": (torch.int64, "SK"),
    "par": (torch.int64, "SK"), "cap_k": (torch.float64, "SK"),
    "avg_fs_k": (torch.float64, "SK"), "qsizes": (torch.float64, "Q"),
}
ROUND_STATE = {
    "t": (torch.float64, "S"), "n_events": (torch.int64, "S"),
    "fin_any": (torch.bool, "S"), "next_tick": (torch.float64, "S"),
    "done": (torch.bool, "S"), "finish_t": (torch.float64, "S"),
    "sc_cursor": (torch.int64, "S"), "streak": (torch.int64, "S"),
    "pair_fast": (torch.int64, "S"), "pair_slow": (torch.int64, "S"),
    "n_moves": (torch.int64, "S"), "busy": (torch.bool, "SC"),
    "dead": (torch.float64, "SC"), "rem": (torch.float64, "SC"),
    "cap": (torch.float64, "SC"), "chunk_of": (torch.int64, "SC"),
    "qptr": (torch.int64, "SK"), "queue_bytes": (torch.float64, "SK"),
    "prepend_n": (torch.int64, "SK"), "chunk_done": (torch.bool, "SK"),
    "completed_at": (torch.float64, "SK"), "delivered": (torch.float64, "SK"),
    "delivered_at_tick": (torch.float64, "SK"), "rate_est": (torch.float64, "SK"),
    "prepend_sizes": (torch.float64, "SKP"), "tl_t": (torch.float64, "ST"),
    "tl_rate": (torch.float64, "ST"), "tl_len": (torch.int64, "S"),
    "tl_stride": (torch.int64, "S"), "tl_seen": (torch.int64, "S"),
    "tl_last_t": (torch.float64, "S"), "tl_last_rate": (torch.float64, "S"),
}
#: per row: the steps taken and the stop code (``transition.STOP_*``)
ROUND_OUTPUTS = {"steps": (torch.int64, "S"), "stop": (torch.int64, "S")}
ROUND_OPERANDS = {**ROUND_INPUTS, **ROUND_STATE, **ROUND_OUTPUTS}

#: the timeline ring's tensors, in ``kernels.timeline_push``'s order
_TIMELINE = (
    "tl_t", "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate",
)

#: argument types of the kernels' C entry points
_ARGTYPES = {
    "fused_step_f64": [ctypes.c_void_p] * 26 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p],
    "fused_rounds_f64": [ctypes.c_void_p] + [ctypes.c_longlong] * 8
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


def _advance_plain(act, busy, dead, rem, cap, tick_dt, bw, disk_rate, sat_cc, contention):
    """The physics half of a step, composed of the fluid kernels: rates,
    horizon, fluid movement. Returns ``(dt, rate_sum, fin_any, busy, dead,
    rem, moved)``."""
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
    return dt, rates.sum(dim=-1), finished.any(dim=-1), busy2, dead2, rem2, moved


def fused_step_plain(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """Plain PyTorch version of the one-step kernel, composed of the fluid
    kernels."""
    dt, rate_sum, fin, busy2, dead2, rem2, moved = _advance_plain(
        act, busy, dead, rem, cap, tick_dt, bw, disk_rate, sat_cc, contention
    )
    busy3, dead3, rem3, qptr2, qb2, _ = feed_queues(
        act, chunk_of, busy2, dead2, rem2, qsizes, qoff, qlen, qptr,
        queue_bytes, fsdt,
    )
    return dt, rate_sum, fin, busy3, dead3, rem3, moved, qptr2, qb2


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
    absent), the kernel's yardstick. Each iteration, on the rows still
    running: the error test (``t > max_time``, a stranded chunk), then a
    step (the profile lookup, the physics of :func:`fused_step_plain`, the
    feed with the resume stack, the timeline push, the clock, the event
    count, the ``delivered`` scatter), then the capacity guards and
    :func:`..transition.post_transition`, masked per row. A row stops done,
    in error, at a guard (the step's transition not taken) or at
    ``max_steps``. Host reads only skip masked-out work. Returns new
    tensors for every name of :data:`ROUND_STATE` and
    :data:`ROUND_OUTPUTS`; ``s`` is left as it was."""
    st = dict(s)  # entries are replaced, never written
    K = st["qptr"].shape[-1]
    steps = torch.zeros_like(st["n_events"])
    stop = torch.full_like(steps, transition.STOP_NONE)
    run = st["act"]
    while True:
        err = run & ((st["t"] > st["max_time"]) | transition.stranded(st, run))
        stop = torch.where(err, transition.STOP_ERROR, stop)
        run = run & ~err
        if not bool(run.any()):
            break
        t = st["t"]
        eff_bw, next_prof = bandwidth_now(st["bw"], st["prof_t"], st["prof_mult"], t)
        dt, rate_sum, fin, st["busy"], st["dead"], st["rem"], moved = _advance_plain(
            run, st["busy"], st["dead"], st["rem"], st["cap"],
            torch.minimum(st["next_tick"] - t, next_prof - t), eff_bw,
            st["disk_rate"], st["sat_cc"], st["contention"],
        )
        transition.feed(st, run)
        st.update(zip(_TIMELINE, timeline_push(
            run & st["record_timeline"], t, rate_sum, *(st[k] for k in _TIMELINE)
        )))
        st["t"] = t + dt  # dt is 0 on rows that do not run
        st["n_events"] = st["n_events"] + run.to(torch.int64)
        steps = steps + run.to(torch.int64)
        st["fin_any"] = torch.where(run, fin, st["fin_any"])
        st["delivered"] = TorchOps.chunk_scatter_add(
            st["delivered"], st["chunk_of"], moved, moved != 0.0
        )
        # a row at a capacity guard leaves the step's transition to the host
        completed, tick_hit = transition.completions(st, run)
        hint = transition.hints(
            transition.transition_flags(st, completed, tick_hit).tolist(), K
        )
        guard = transition.stack_full(st, tick_hit)
        if hint["ks_sc"]:
            guard = guard | transition.sc_short(st, completed, hint["ks_sc"])
        stop = torch.where(guard, transition.STOP_GUARD, stop)
        go = run & ~guard
        transition.post_transition(
            st, go, completed & go.unsqueeze(-1), tick_hit & go, **hint
        )
        capped = go & ~st["done"] & (steps >= max_steps)
        stop = torch.where(go & st["done"], transition.STOP_DONE, stop)
        stop = torch.where(capped, transition.STOP_CAP, stop)
        run = go & ~st["done"] & ~capped
    out = {name: st[name] for name in ROUND_STATE}
    out.update(steps=steps, stop=stop)
    return out


def fused_rounds(s, max_steps: int = ROUND_CAP):
    """Every active row of ``s`` (a mapping of :data:`ROUND_OPERANDS` names
    to tensors) takes steps until it is done, errs, meets a capacity guard
    or has taken ``max_steps``; the state and output tensors are updated
    in place. Returns ``s["steps"]``. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (C and K up to
    1024; no launch for zero rows)."""
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
            "Q": s["qsizes"].shape[0], "P": s["prepend_sizes"].shape[-1],
            "T": s["tl_t"].shape[-1]}
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
            ptrs, S, C, dims["K"], dims["B"], dims["Q"], dims["P"], dims["T"], max_steps,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused-rounds kernel launch failed: cudaError {err}")
    fused_rounds.launches += 1
    return s["steps"]


#: launches of the loop kernel in this process
fused_rounds.launches = 0
