"""Model-facing entry points of the kernels: they take the model layouts,
adapt them to the kernel layouts, and carry gradients.

Each entry point applies one ``torch.autograd.Function``. Its forward is
the kernel's wrapper: it launches the CUDA kernel for CUDA tensors (or
raises) and runs the plain version for CPU tensors, so serving results are
what the wrappers give. Its backward is a function of torch ops in
:mod:`repro_torch.kernels.backward`, on either device: the gradient of the
plain version, recomputed from the saved inputs; no backward kernel runs,
and the wrappers' launch counts count forward launches only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import backward as _bwd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rwkv6_scan as _wk


class FlashAttention(torch.autograd.Function):
    """:func:`repro_torch.kernels.flash_attention.flash_attention` forward,
    :func:`repro_torch.kernels.backward.flash_attention_bwd` backward, in
    the kernel layout q (B, H, S, D), k, v (B, KV, T, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, logit_softcap=logit_softcap)
        return _fa.flash_attention(q, k, v, **ctx.mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_bwd.flash_attention_bwd(q, k, v, do, **ctx.mask), None, None, None)


class RwkvScan(torch.autograd.Function):
    """:func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan` forward,
    :func:`repro_torch.kernels.backward.rwkv6_scan_bwd` backward, in the
    kernel layout r, k, v, w (B, H, T, D)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _wk.rwkv6_scan(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_last):
        return _bwd.rwkv6_scan_bwd(*ctx.saved_tensors, dy, ds_last)


class RglruScan(torch.autograd.Function):
    """:func:`repro_torch.kernels.rglru_scan.rglru_scan` forward,
    :func:`repro_torch.kernels.backward.rglru_scan_bwd` backward."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h, h_last = _rg.rglru_scan(a, x, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.x_dtype = x.dtype
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        da, dx, dh0 = _bwd.rglru_scan_bwd(*ctx.saved_tensors, dh, dh_last)
        return da, dx.to(ctx.x_dtype), dh0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Model layout: q (B, S, H, Dh); k, v (B, T, KV, Dh) -> (B, S, H, Dh)
    in q's dtype."""
    out = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal, window, logit_softcap)
    return out.transpose(1, 2)


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: r/k/v/w (B, T, H, D); u (H, D); s0 (B, H, D, D).
    Returns y (B, T, H, D) fp32 and the final state (B, H, D, D) fp32.
    The kernel reads the (B, H, T, D) views of fp32 r, k, v, w in place and
    writes y in r's layout, so no operand is copied."""
    args = [x.movedim(1, 2) for x in (r, k, v, w)]
    y, s_fin = RwkvScan.apply(*args, u, s0)
    return y.movedim(2, 1), s_fin


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout a, x (B, T, W), h0 (B, W), which is the kernel layout.
    Returns h (B, T, W) fp32 and h_T (B, W) fp32."""
    return RglruScan.apply(a, x, h0)
