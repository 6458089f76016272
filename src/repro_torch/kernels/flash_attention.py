"""Flash-attention forward: two CUDA kernels and their wrapper.

Port of the Pallas kernel ``_flash_kernel``
(``src/repro/kernels/flash_attention.py``) in its layout: q (B, H, S, D);
k, v (B, KV, T, D). :func:`flash_attention` launches a kernel for CUDA
tensors and runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref` only for CPU tensors.
Which kernel takes CUDA tensors is fixed by their dtype and head dim
(:func:`_route`):

* ``csrc/flash_attention_sm90.cu``, bf16 with D % 8 == 0: the Hopper
  kernel, products on the tensor cores (``wgmma``), tiles brought in by TMA;
* ``csrc/flash_attention.cu``, fp32, and bf16 head dims that TMA cannot
  describe: fp32 arithmetic on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch import _cuda_build as _build
from repro_torch.kernels.ref import flash_attention_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the CUDA-core kernel's source (fp32 arithmetic)
SOURCE = _CSRC / "flash_attention.cu"
#: the tensor-core kernel's source (bf16 wgmma, sm_90a)
SOURCE_SM90 = _CSRC / "flash_attention_sm90.cu"
#: the widest head either kernel takes
MAX_HEAD_DIM = 256
#: the two routes of a CUDA call
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_SM90 = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 18 + [ctypes.c_int] * 2
                  + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(route: str):
    """The C entry point of the route's kernel, built and loaded at first
    use."""
    if route == TENSOR_CORES:
        fn, argtypes = _build.load(SOURCE_SM90).flash_attention_sm90_fwd, _ARGTYPES_SM90
    else:
        fn, argtypes = _build.load(SOURCE).flash_attention_fwd, _ARGTYPES
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes CUDA inputs of ``dtype`` with head dim ``D``:
    the tensor-core kernel for bf16 with D % 8 == 0 (TMA needs 16-byte row
    strides) and D <= 256, the CUDA-core kernel for everything else."""
    if dtype == torch.bfloat16 and D % 8 == 0 and 0 < D <= MAX_HEAD_DIM:
        return TENSOR_CORES
    return CUDA_CORES


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is where TMA can describe it (last dim contiguous, the
    other strides positive multiples of 8 elements, 16-byte aligned), else
    a contiguous copy."""
    if (t.stride(-1) == 1 and all(s > 0 and s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention of q (B, H, S, D) over k, v (B, KV, T, D),
    H % KV == 0, queries at positions 0..S-1 and keys at 0..T-1: causal and
    sliding-window masks (a key attends when it is > the query minus
    ``window``), tanh logit softcap, fp32 logits and softmax. Returns
    (B, H, S, D) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch one kernel on
    the current stream, chosen by :func:`_route`; both take B <= 65,535,
    and neither gives way to the other or to the plain version. An empty
    output (B H S = 0) launches nothing. The tensor-core kernel takes bf16
    q, k and v with D % 8 == 0, D <= 256, in any strides whose last dim is
    contiguous (others are copied), S <= 8,388,480 and T >= 1 (TMA cannot
    describe an empty key axis), and computes p v as two bf16 products
    (p = hi + lo, p kept to ~2^-18 of itself). The CUDA-core kernel takes
    fp32 or bf16 with D <= 256, H <= 65,535, any T, and computes in fp32.
    A query that no key may attend gets zeros from either kernel (the plain
    version gives the mean of v)."""
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
    route = _route(q.dtype, D)
    if B > 65535 or (route == CUDA_CORES and H > 65535):
        raise ValueError(f"the flash kernel takes B and H up to 65535, got {B}, {H}")
    if route == TENSOR_CORES and (S > 65535 * 128 or T < 1):
        raise ValueError(f"the tensor-core flash kernel takes S up to {65535 * 128} and T >= 1, "
                         f"got S={S}, T={T}")
    dev = q.device
    if B * H * S == 0:
        return torch.empty((B, H, S, D), dtype=q.dtype, device=dev)
    mask = (int(causal), int(window is not None), 0 if window is None else int(window),
            float(logit_softcap))
    if route == TENSOR_CORES:
        for t, n in ((k, "k"), (v, "v")):
            if t.device != dev or t.dtype != q.dtype:
                raise ValueError(f"{n} is {t.dtype} on {t.device}, expected {q.dtype} on {dev}")
        ins = [_tma_operand(t) for t in (q, k, v)]
        out = torch.empty_like(ins[0])  # q's strides: the model layout stays as it is
        strides = [x for t in (*ins, out) for x in t.stride()[:3]]
        args = [*(t.data_ptr() for t in (*ins, out)), B, H, KV, S, T, D, *strides, *mask]
    else:
        ins = [t.contiguous() for t in (q, k, v)]
        shapes = [(B, H, S, D), (B, KV, T, D), (B, KV, T, D)]
        ptrs = [_build.check(t, n, q.dtype, s, dev) for t, n, s in zip(ins, "qkv", shapes)]
        out = torch.empty((B, H, S, D), dtype=q.dtype, device=dev)
        args = [*ptrs, out.data_ptr(), B, H, KV, S, T, D, int(q.dtype == torch.bfloat16), *mask]
    fn = _entry(route)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({route}) launch failed: cudaError {err}")
    flash_attention.launches += 1
    if route == TENSOR_CORES:
        flash_attention.tc_launches += 1
    return out


#: launches of either CUDA kernel in this process
flash_attention.launches = 0
#: launches of the tensor-core kernel in this process
flash_attention.tc_launches = 0
