"""Fused resume-free sweep step: the CUDA kernel ``csrc/fused_step.cu`` and
its plain PyTorch version.

Port of the Pallas kernel ``_fused_kernel``
(``src/repro/eval/fabric/kernels/fused_step_pallas.py``): per scenario
row, ``disk_pool`` -> bisected water-fill -> ``event_horizon`` ->
``advance_channels`` -> the pure-FIFO branch of ``feed_queues``, in one
launch. The driver routes a sweep here only while no resume file exists
anywhere in the batch.

Operands, in order: ``act`` (S,) bool; ``busy`` (S, C) bool; ``dead``,
``rem``, ``cap`` (S, C) float64; ``chunk_of`` (S, C) int64; ``tick_dt``,
``bw``, ``disk_rate`` (S,) float64; ``sat_cc`` (S,) int64;
``contention`` (S,) float64; ``qoff``, ``qlen``, ``qptr`` (S, K) int64;
``queue_bytes``, ``fsdt`` (S, K) float64; ``qsizes`` (Q,) float64.
Returns ``(dt, rate_sum, fin_any, busy, dead, rem, moved, qptr,
queue_bytes)``; inactive rows pass through with ``dt = 0``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _cuda_build as _build
from . import advance_channels, disk_pool, event_horizon, feed_queues
from .waterfill_bisect import bisect_level

_EPS = 1e-12

#: the kernel's CUDA source
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_step.cu"

_ARGTYPES = [ctypes.c_void_p] * 26 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load(SOURCE).fused_step_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_step_plain(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """Plain PyTorch version of the kernel, composed of the fluid kernels."""
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
    1024)."""
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
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(
            *ptrs, *(o.data_ptr() for o in outs), S, C, K, Q,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused-step kernel launch failed: cudaError {err}")
    fused_step.launches += 1
    return outs


#: launches of the CUDA kernel in this process
fused_step.launches = 0
