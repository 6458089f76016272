"""Shared neural-net layers on torch tensors (the part of the reference's
``models/layers.py`` that the RWKV-6, recurrentgemma and dense decoder
paths need).

Conventions, as in the reference: activations are bf16, parameters fp32
(cast at use), norms, softmax and attention logits compute in fp32;
attention tensors are (batch, seq, heads, head_dim). Elementwise work on a
bf16 tensor runs op by op in bf16, so each step rounds where the
reference's source rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


#: a window value meaning "unwindowed"; any value >= the longest sequence
#: behaves the same
GLOBAL_WINDOW = (2**31 - 1) // 2


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
        return silu(x)
    if kind == "gelu":
        return gelu_tanh(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, op by op in ``x``'s dtype, as the
    reference's ``jax.nn.silu`` computes it (``F.silu`` rounds a bf16 input
    once, at the end)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x +
    0.044715 x^3)))``, op by op in ``x``'s dtype with the constants cast to
    it first, as the reference's ``jax.nn.gelu(approximate=True)`` computes
    it (``F.gelu`` rounds a bf16 input once, at the end)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x)))))
    return x * cdf


# ------------------------------------------------------------------ #
# rotary embeddings and attention
# ------------------------------------------------------------------ #


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings, computed in fp32 and returned in ``x``'s dtype.
    x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    f4 = torch.float32
    exponents = torch.arange(half, dtype=f4, device=x.device) / half
    timescale = torch.pow(float(theta), exponents)
    pos = positions.to(f4)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[:, :, None] / timescale[None, None, :]  # (B, S, half)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(f4), x[..., half:].to(f4)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_scores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_positions: torch.Tensor, k_positions: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention with causal / sliding-window masking and an
    optional tanh logit softcap; fp32 logits and softmax, output in ``q``'s
    dtype.

    q: (B, S, H, Dh); k, v: (B, T, KV, Dh), H % KV == 0; positions (S,) /
    (T,) or (B, S) / (B, T). A key attends when its position is >= 0
    (negative positions mark unwritten rolling-cache slots), <= the query's
    (causal) and > the query's minus ``window``."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    f4 = torch.float32
    qg = q.reshape(b, s, kv, h // kv, dh).to(f4)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))  # in fp32
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(f4)) * scale
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    qp = q_positions if q_positions.dim() == 2 else q_positions[None, :]
    kp = k_positions if k_positions.dim() == 2 else k_positions[None, :]
    mask = (kp[:, None, :] >= 0).expand(max(qp.shape[0], kp.shape[0]), s, t)
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        mask = mask & (kp[:, None, :] > (qp[:, :, None] - window))
    logits = logits.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(f4))
    return out.reshape(b, s, h, dh).to(q.dtype)


def attention_chunked(
    q, k, v, q_positions, k_positions, *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """:func:`attention_scores` one query chunk at a time, so that only a
    (chunk, T) block of logits exists at once; falls back to the dense form
    when ``q_chunk`` does not divide S. q_positions must be (S,)."""
    s = q.shape[1]
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if s % q_chunk != 0:
        return attention_scores(q, k, v, q_positions, k_positions, **kw)
    outs = [
        attention_scores(q[:, i:i + q_chunk], k, v, q_positions[i:i + q_chunk],
                         k_positions, **kw)
        for i in range(0, s, q_chunk)
    ]
    return torch.cat(outs, dim=1)


def attend(q, k, v, q_positions, k_positions, *, causal: bool = True,
           window: Optional[int] = None, logit_softcap: float = 0.0,
           chunk_threshold: int = 2048) -> torch.Tensor:
    """Dense attention, or query-chunked above ``chunk_threshold`` queries
    (with (S,) query positions)."""
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if q.shape[1] > chunk_threshold and q_positions.dim() == 1:
        return attention_chunked(q, k, v, q_positions, k_positions, **kw)
    return attention_scores(q, k, v, q_positions, k_positions, **kw)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def attn_param_shapes(dims: AttnDims) -> Dict[str, Tuple[int, ...]]:
    d, h, kv, dh = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    return {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh), "wo": (h * dh, d)}


def attn_param_init(generator: torch.Generator, dims: AttnDims) -> Dict[str, torch.Tensor]:
    """``dense_init`` draws (``wo`` at 1/sqrt(H Dh), its fan-in)."""
    return {name: dense_init(shape, generator)
            for name, shape in attn_param_shapes(dims).items()}


def attn_qkv(p, x: torch.Tensor, dims: AttnDims):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh) in x's dtype; ``p`` holds
    ``wq``, ``wk``, ``wv`` as attributes."""
    b, s, _ = x.shape
    q = (x @ cast(p.wq)).reshape(b, s, dims.num_heads, dims.head_dim)
    k = (x @ cast(p.wk)).reshape(b, s, dims.num_kv_heads, dims.head_dim)
    v = (x @ cast(p.wv)).reshape(b, s, dims.num_kv_heads, dims.head_dim)
    return q, k, v


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ cast(p.wo)


# ------------------------------------------------------------------ #
# feed-forward
# ------------------------------------------------------------------ #


def ffn_param_shapes(d_model: int, d_ff: int, glu: bool) -> Dict[str, Tuple[int, ...]]:
    shapes = {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    if glu:
        shapes["w_gate"] = (d_model, d_ff)
    return shapes


def ffn_param_init(generator: torch.Generator, d_model: int, d_ff: int,
                   glu: bool) -> Dict[str, torch.Tensor]:
    return {name: dense_init(shape, generator)
            for name, shape in ffn_param_shapes(d_model, d_ff, glu).items()}


def ffn_apply(p, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    """(GLU) feed-forward in x's dtype, weights cast to bf16 at use."""
    up = x @ cast(p.w_up)
    if glu:
        h = activation(x @ cast(p.w_gate), act) * up
    else:
        h = activation(up, act)
    return h @ cast(p.w_down)
