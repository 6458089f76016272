"""Model-facing wrappers of the kernels: they take the model layouts and
adapt them to the kernel layouts. Each wrapper launches its CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rwkv6_scan as _wk


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Model layout: q (B, S, H, Dh); k, v (B, T, KV, Dh) -> (B, S, H, Dh)
    in q's dtype."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, logit_softcap=logit_softcap)
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
    y, s_fin = _wk.rwkv6_scan(*args, u, s0)
    return y.movedim(2, 1), s_fin


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout a, x (B, T, W), h0 (B, W), which is the kernel layout.
    Returns h (B, T, W) fp32 and h_T (B, W) fp32."""
    return _rg.rglru_scan(a, x, h0)
