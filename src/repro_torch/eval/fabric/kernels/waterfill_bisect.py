"""Bisected max-min water-fill: the CUDA kernel ``csrc/waterfill.cu`` and
its plain PyTorch version.

Port of the Pallas kernel ``_waterfill_kernel``
(``src/repro/eval/fabric/kernels/waterfill_pallas.py``): per row of caps
(S, C) and pool (S,), :data:`BISECT_ITERS` halvings of the water level
from ``max(caps)``; the allocation is ``min(cap, level)``. It agrees with
the sort-based closed form :func:`repro_torch.eval.fabric.kernels.
waterfill` to ~1e-12 relative. On rows of C <= 32 the kernel runs the
halvings as a 32-way descent; :func:`waterfill_descent_plain` is its plain
mirror, equal to it bit for bit.

:func:`waterfill_bisect` launches the kernel for CUDA tensors and runs
:func:`waterfill_bisect_plain` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _cuda_build as _build

BISECT_ITERS = 80

#: the kernel's CUDA source
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "waterfill.cu"

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load(SOURCE).waterfill_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def bisect_level(caps, pool):
    """The bisected water level (S,) of ``caps`` (S, C) for ``pool`` (S,):
    the upper end of the bracket after :data:`BISECT_ITERS` halvings,
    keeping ``sum(min(caps, hi)) >= min(pool, sum(caps))``, each sum in the
    kernels' order (:func:`lane_sum`), so that the level is theirs bit for
    bit on any device."""
    lanes = _lane_layout(caps)
    pool_eff = torch.clamp(torch.minimum(pool, _lane_fold(lanes)), min=0.0)
    hi = caps.amax(dim=-1)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        low = _lane_fold(torch.minimum(lanes, mid.unsqueeze(-1))) < pool_eff
        lo = torch.where(low, mid, lo)
        hi = torch.where(low, hi, mid)
    return hi


def lane_sum(x):
    """The sum over the last axis in the kernels' order: column c sits on
    lane c % 32 of tile c // 32, each lane adds its tiles in turn, and the
    32 lanes then add in the warp butterfly's pairing (:func:`fold`). A
    plain ``sum`` takes another order on the CPU, and at a near-tie of
    ``sum < pool`` its level parts from the kernel's in the last bit."""
    return _lane_fold(_lane_layout(x))


def _lane_layout(x):
    """``x`` with zero columns up to a power of two of at most 32 columns
    (the butterfly's levels above it add only zeros), or up to whole
    32-lane tiles."""
    C = x.shape[-1]
    width = 1 << max(C - 1, 0).bit_length() if C <= 32 else 32 * -(-C // 32)
    return x if width == C else torch.nn.functional.pad(x, (0, width - C))


def _lane_fold(x):
    """:func:`lane_sum` of a tensor in :func:`_lane_layout`."""
    acc = x[..., :32]
    for lo in range(32, x.shape[-1], 32):
        acc = acc + x[..., lo:lo + 32]
    return fold(acc)


#: halvings a round of the kernel's 32-way descent (rows of C <= 32)
DESCENT_LEVELS = 5


def fold(x):
    """The sum over the last axis (of length 32) in the warp butterfly's
    pairing, ``x[i] += x[i + o]`` for o = 16, 8, 4, 2, 1, as the kernel's
    ``fold`` and ``warp_sum`` add."""
    o = x.shape[-1] // 2
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def waterfill_descent_plain(caps, pool):
    """Plain mirror of the kernel on rows of C <= 32: the water level as
    ``BISECT_ITERS / DESCENT_LEVELS`` rounds of a 32-way descent. Node
    n = 1..31 of a round (heap order: children 2n and 2n + 1) is walked to
    with the halvings ``0.5 * (lo + hi)`` the one-at-a-time chain would take,
    its sum of ``min(cap, mid)`` is taken in the butterfly's pairing
    (:func:`fold`), and the path of ``sum < pool_eff`` picks the next
    bracket. Equals the kernel bit for bit; returns ``min(caps, level)``."""
    S, C = caps.shape
    if C > 32:
        raise ValueError(f"the 32-way descent takes rows of C <= 32, got {C}")
    if C == 0:
        return torch.zeros_like(caps)
    pad = torch.nn.functional.pad(caps, (0, 32 - C))  # the warp's 32 lanes
    pool_eff = torch.clamp(torch.minimum(pool, fold(pad)), min=0.0)
    hi = torch.clamp(pad.amax(dim=-1), min=0.0)
    lo = torch.zeros_like(hi)
    node = torch.arange(1, 32)  # lanes 0..30; lane 31's node is never picked
    depth = torch.floor(torch.log2(node.double())).long()
    rows = torch.arange(S)
    for _ in range(BISECT_ITERS // DESCENT_LEVELS):
        lo_n, hi_n = lo[:, None].expand(S, 31), hi[:, None].expand(S, 31)
        for d in range(DESCENT_LEVELS - 2, -1, -1):
            m = 0.5 * (lo_n + hi_n)
            on, right = d < depth, ((node >> d) & 1).bool()
            lo_n = torch.where(on & right, m, lo_n)
            hi_n = torch.where(on & ~right, m, hi_n)
        mid = 0.5 * (lo_n + hi_n)
        low = fold(torch.minimum(pad[:, None, :], mid[:, :, None])) < pool_eff[:, None]
        n = torch.ones(S, dtype=torch.long)
        for _ in range(1, DESCENT_LEVELS):
            n = 2 * n + low[rows, n - 1].long()
        up, pick = low[rows, n - 1], n - 1
        lo = torch.where(up, mid[rows, pick], lo_n[rows, pick])
        hi = torch.where(up, hi_n[rows, pick], mid[rows, pick])
    return torch.minimum(caps, hi[:, None])


def waterfill_bisect_plain(caps, pool):
    """Plain PyTorch version of the kernel: ``min(caps, level)``."""
    if caps.shape[-1] == 0:
        return torch.zeros_like(caps)
    return torch.minimum(caps, bisect_level(caps, pool).unsqueeze(-1))


def waterfill_bisect(caps, pool):
    """Bisected water-fill of ``caps`` (S, C) float64 by ``pool`` (S,)
    float64. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream (C up to 1024)."""
    if caps.dim() != 2:
        raise ValueError(f"caps must be (S, C), got {tuple(caps.shape)}")
    S, C = caps.shape
    if caps.device.type == "cpu":
        return waterfill_bisect_plain(caps, pool)
    if caps.device.type != "cuda":
        raise ValueError(f"unsupported device {caps.device}")
    if C > 1024:
        raise ValueError(f"the water-fill kernel takes C <= 1024, got {C}")
    dev = caps.device
    f8 = torch.float64
    out = torch.empty((S, C), dtype=f8, device=dev)
    ptrs = (
        _build.check(caps, "caps", f8, (S, C), dev),
        _build.check(pool, "pool", f8, (S,), dev),
        out.data_ptr(),
    )
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(*ptrs, S, C, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"waterfill kernel launch failed: cudaError {err}")
    waterfill_bisect.launches += 1
    return out


#: launches of the CUDA kernel in this process
waterfill_bisect.launches = 0
