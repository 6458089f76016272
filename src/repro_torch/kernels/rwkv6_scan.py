"""WKV-6 recurrence: the CUDA kernel ``csrc/rwkv6_scan.cu`` and its wrapper.

Port of the Pallas kernel ``_wkv_kernel`` (``src/repro/kernels/rwkv6_scan.py``)
in the kernel layout: r, k, v, w (B, H, T, D); u (H, D); s0 (B, H, D, D).
:func:`rwkv6_scan` launches the kernel for CUDA tensors and runs the plain
version :func:`repro_torch.kernels.ref.rwkv6_scan_ref` only for CPU tensors.
The kernel reads r, k, v, w in their own strides and writes y in r's, so
the model's (B, T, H, D) products, handed over as (B, H, T, D) views, are
not copied.
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

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])


def _in_place(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is where the kernel can read it in its own strides (the
    last dim contiguous, the other strides multiples of 4 elements, 16-byte
    aligned), else a contiguous copy. Dims of size 1 take any stride."""
    strides = [s for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
    if t.stride(-1) == 1 and all(s % 4 == 0 for s in strides) and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> list:
    """The (b, h, t) element strides of a (B, H, T, D) operand, 0 where a
    dim has size 1."""
    return [0 if n == 1 else s for n, s in zip(t.shape[:3], t.stride()[:3])]


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
    Pallas kernel upcasts on load. fp32 r, k, v, w are read where they lie
    when their last dim is contiguous and their other strides are multiples
    of 4 elements (others are copied), and y is laid out as r is: (B, H, T,
    D) views of (B, T, H, D) tensors give a y of that layout, with no copy.
    The kernel takes D in :data:`HEAD_DIMS` and 1 <= T < 2^31, and raises
    otherwise."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, D), got {tuple(r.shape)}")
    B, H, T, D = r.shape
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the WKV-6 kernel takes D in {HEAD_DIMS}, got {D}")
    if not 1 <= T < 2**31:
        raise ValueError(f"the WKV-6 kernel takes 1 <= T < 2^31, got {T}")
    dev = r.device
    f4 = torch.float32
    names = ("r", "k", "v", "w", "u", "s0")
    shapes = [(B, H, T, D)] * 4 + [(H, D), (B, H, D, D)]
    for x, n, shape in zip((r, k, v, w, u, s0), names, shapes):
        if x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"{n} is {tuple(x.shape)} on {x.device}, expected {shape} on {dev}")
    seq = [_in_place(x.to(f4)) for x in (r, k, v, w)]
    # u and s0 are read as contiguous arrays: _in_place of a contiguous
    # tensor is a contiguous tensor, aligned
    rest = [_in_place(x.to(f4).contiguous()) for x in (u, s0)]
    y = torch.empty_like(seq[0])
    s_out = torch.empty((B, H, D, D), dtype=f4, device=dev)
    strides = (ctypes.c_longlong * 15)(*(x for t in (*seq, y) for x in _strides(t)))
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (*seq, *rest)), y.data_ptr(), s_out.data_ptr(),
                 B, H, T, D, strides, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err}")
    rwkv6_scan.launches += 1
    return y, s_out


#: launches of the CUDA kernel in this process
rwkv6_scan.launches = 0
