"""Shared neural-net layers on torch tensors (the part of the reference's
``models/layers.py`` that the RWKV-6 path needs).

Conventions, as in the reference: activations are bf16, parameters fp32
(cast at use), norms compute in fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def cast(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return x.to(dtype)


def dense_init(shape: Sequence[int], generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """fp32 normal draws times ``scale`` (default ``1/sqrt(fan_in)``, the
    fan-in being the second-to-last axis of a matrix), on the generator's
    device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                      device=generator.device)
    return out * scale


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a zero-centred scale, fp32 inside, in ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")
