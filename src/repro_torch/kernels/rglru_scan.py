"""RG-LRU recurrence: the CUDA kernel ``csrc/rglru_scan.cu`` and its wrapper.

Port of the Pallas kernel ``_rglru_kernel`` (``src/repro/kernels/rglru_scan.py``)
in its layout: a, x (B, T, W); h0 (B, W). :func:`rglru_scan` launches the
kernel for CUDA tensors and runs the plain version
:func:`repro_torch.kernels.ref.rglru_scan_ref` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch import _cuda_build as _build
from repro_torch.kernels.ref import rglru_scan_ref

#: the kernel's CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load(SOURCE).rglru_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + x_t over a, x (B, T, W) from h0 (B, W).
    Returns h (B, T, W) and h_T (B, W), both fp32.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream; bf16 or fp16 inputs are upcast to fp32 first, as the
    Pallas kernel upcasts on load. Any T >= 1 and any W. The kernel walks
    time in the plain version's order and rounds as it does: the two agree
    bit for bit."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, T, W), got {tuple(a.shape)}")
    B, T, W = a.shape
    if a.device.type == "cpu":
        return rglru_scan_ref(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if T < 1:
        raise ValueError(f"the RG-LRU kernel takes T >= 1, got {T}")
    dev = a.device
    f4 = torch.float32
    ins = [t.to(f4).contiguous() for t in (a, x, h0)]
    shapes = [(B, T, W), (B, T, W), (B, W)]
    ptrs = [_build.check(t, n, f4, s, dev) for t, n, s in zip(ins, ("a", "x", "h0"), shapes)]
    h = torch.empty((B, T, W), dtype=f4, device=dev)
    h_fin = torch.empty((B, W), dtype=f4, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(*ptrs, h.data_ptr(), h_fin.data_ptr(), B, T, W,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return h, h_fin


#: launches of the CUDA kernel in this process
rglru_scan.launches = 0
