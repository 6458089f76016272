"""WKV-6 recurrence: the CUDA kernel ``csrc/rwkv6_scan.cu`` and its wrapper.

Port of the Pallas kernel ``_wkv_kernel`` (``src/repro/kernels/rwkv6_scan.py``)
in the kernel layout: r, k, v, w (B, H, T, D); u (H, D); s0 (B, H, D, D).
:func:`rwkv6_scan` launches the kernel for CUDA tensors and runs the plain
version :func:`repro_torch.kernels.ref.rwkv6_scan_ref` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch import _cuda_build as _build
from repro_torch.kernels.ref import rwkv6_scan_ref

#: the kernel's CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
#: head dims the kernel is built for (rwkv6-3b: 64; the smoke config: 32)
HEAD_DIMS = (16, 32, 64)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load(SOURCE).wkv6_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over r, k, v, w (B, H, T, D), u (H, D), s0 (B, H, D, D).
    Returns y (B, H, T, D) and the final state (B, H, D, D), both fp32.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream; bf16 or fp16 inputs are upcast to fp32 first, as the
    Pallas kernel upcasts on load. The kernel takes D in :data:`HEAD_DIMS`
    and T >= 1, and raises otherwise."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, D), got {tuple(r.shape)}")
    B, H, T, D = r.shape
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the WKV-6 kernel takes D in {HEAD_DIMS}, got {D}")
    if T < 1:
        raise ValueError(f"the WKV-6 kernel takes T >= 1, got {T}")
    dev = r.device
    f4 = torch.float32
    ins = [x.to(f4).contiguous() for x in (r, k, v, w, u, s0)]
    shapes = [(B, H, T, D)] * 4 + [(H, D), (B, H, D, D)]
    names = ("r", "k", "v", "w", "u", "s0")
    ptrs = [_build.check(x, n, f4, s, dev) for x, n, s in zip(ins, names, shapes)]
    y = torch.empty((B, H, T, D), dtype=f4, device=dev)
    s_out = torch.empty((B, H, D, D), dtype=f4, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(*ptrs, y.data_ptr(), s_out.data_ptr(), B, H, T, D,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err}")
    rwkv6_scan.launches += 1
    return y, s_out


#: launches of the CUDA kernel in this process
rwkv6_scan.launches = 0
