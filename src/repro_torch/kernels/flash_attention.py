"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its wrapper.

Port of the Pallas kernel ``_flash_kernel``
(``src/repro/kernels/flash_attention.py``) in its layout: q (B, H, S, D);
k, v (B, KV, T, D). :func:`flash_attention` launches the kernel for CUDA
tensors and runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch import _cuda_build as _build
from repro_torch.kernels.ref import flash_attention_ref

#: the kernel's CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: the widest head the kernel takes
MAX_HEAD_DIM = 256

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load(SOURCE).flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention of q (B, H, S, D) over k, v (B, KV, T, D),
    H % KV == 0, queries at positions 0..S-1 and keys at 0..T-1: causal and
    sliding-window masks (a key attends when it is > the query minus
    ``window``), tanh logit softcap, fp32 logits and softmax. Returns
    (B, H, S, D) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream: q, k and v all fp32 or all bf16, D <= 256, B and H
    <= 65,535; the kernel picks its own tiles and takes any S and T. A query
    that no key may attend gets zeros from the kernel (the plain version
    gives the mean of v)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, S, D), k = v (B, KV, T, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head dims up to {MAX_HEAD_DIM}, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes fp32 or bf16, got {q.dtype}")
    if B > 65535 or H > 65535:
        raise ValueError(f"the flash kernel takes B and H up to 65535, got {B}, {H}")
    dev = q.device
    ins = [t.contiguous() for t in (q, k, v)]
    shapes = [(B, H, S, D), (B, KV, T, D), (B, KV, T, D)]
    ptrs = [_build.check(t, n, q.dtype, s, dev) for t, n, s in zip(ins, "qkv", shapes)]
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(*ptrs, out.data_ptr(), B, H, KV, S, T, D, int(q.dtype == torch.bfloat16),
                 int(causal), int(window is not None), 0 if window is None else int(window),
                 float(logit_softcap), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel in this process
flash_attention.launches = 0
