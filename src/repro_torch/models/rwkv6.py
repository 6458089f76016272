"""RWKV-6 "Finch" block (arXiv:2404.05892) on torch tensors: attention-free
time mixing with data-dependent decay, plus the squared-ReLU channel-mix FFN.

Per head (key dim I, value dim J), with state S in R^{I x J}:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(decay_t))

The recurrence runs through :func:`repro_torch.kernels.ops.rwkv6_scan`: the
CUDA kernel on the card, its plain version on the CPU. Everything inside the
time mix and the channel mix is fp32; the blocks return the input's dtype.

State carried for decode: (wkv (B, H, I, J), shift_tm (B, D), shift_cm (B, D)).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

LORA_DIM = 64

#: parameters that start at a constant, and their value; the others are
#: ``dense_init`` draws
_CONSTANT = {"mix_base": 0.5, "decay_base": -6.0, "u": 0.5, "ln_x": 0.0, "cm_mix": 0.5}
#: low-rank factors, drawn at scale 0.01
_LOW_RANK = ("mix_a", "mix_b", "decay_a", "decay_b")


def rwkv_param_shapes(d_model: int, num_heads: int, head_dim: int,
                      d_ff: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of one block's time-mix and channel-mix parameters,
    in the reference's order and naming."""
    h = num_heads * head_dim
    return {
        # token-shift mixing coefficients for (r, k, v, g, w)
        "mix_base": (5, d_model),
        "mix_a": (d_model, LORA_DIM),
        "mix_b": (5, LORA_DIM, d_model),
        # projections
        "w_r": (d_model, h),
        "w_k": (d_model, h),
        "w_v": (d_model, h),
        "w_g": (d_model, h),
        "w_o": (h, d_model),
        # data-dependent decay (low-rank) + per-channel base + bonus u
        "decay_base": (h,),
        "decay_a": (d_model, LORA_DIM),
        "decay_b": (LORA_DIM, h),
        "u": (num_heads, head_dim),
        "ln_x": (h,),  # per-head group norm scale
        # channel mix
        "cm_mix": (d_model,),
        "cm_k": (d_model, d_ff),
        "cm_v": (d_ff, d_model),
    }


def rwkv_param_init(generator: torch.Generator, d_model: int, num_heads: int,
                    head_dim: int, d_ff: int) -> Dict[str, torch.Tensor]:
    """fp32 initial values of one block's parameters, on the generator's
    device, drawn as the reference draws them (other numbers: another
    generator)."""
    out = {}
    for name, shape in rwkv_param_shapes(d_model, num_heads, head_dim, d_ff).items():
        if name in _CONSTANT:
            out[name] = torch.full(shape, _CONSTANT[name], dtype=torch.float32,
                                   device=generator.device)
        else:
            out[name] = dense_init(shape, generator, 0.01 if name in _LOW_RANK else None)
    return out


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} with the sequence-start slot filled from carried state."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(
    p, x: torch.Tensor, num_heads: int, head_dim: int,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, D) -> (out in x's dtype, new state). ``p`` holds the
    block's parameters as attributes."""
    b, t, d = x.shape
    hd = num_heads * head_dim
    xf = x.float()
    prev_tm = None if state is None else state["shift_tm"]
    delta = _token_shift(xf, prev_tm) - xf

    # data-dependent 5-way mixing (ddlerp)
    base = xf + delta * p.mix_base[:, None, None, :]  # (5, B, T, D)
    lora = torch.matmul(torch.tanh(xf @ p.mix_a).unsqueeze(0), p.mix_b.unsqueeze(1))
    xr, xk, xv, xg, xw = base + delta.unsqueeze(0) * lora

    r = (xr @ p.w_r).reshape(b, t, num_heads, head_dim)
    k = (xk @ p.w_k).reshape(b, t, num_heads, head_dim)
    v = (xv @ p.w_v).reshape(b, t, num_heads, head_dim)
    g = F.silu(xg @ p.w_g)  # (B, T, HD)
    decay = p.decay_base + torch.tanh(xw @ p.decay_a) @ p.decay_b  # (B, T, HD)
    w = torch.exp(-torch.exp(decay)).reshape(b, t, num_heads, head_dim)

    if state is None:
        s0 = torch.zeros((b, num_heads, head_dim, head_dim), dtype=torch.float32,
                         device=x.device)
    else:
        s0 = state["wkv"]
    y, s1 = ops.rwkv6_scan(r, k, v, w, p.u, s0)

    # per-head group norm (population variance) + output gate
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(b, t, hd) * (1.0 + p.ln_x)
    out = (yn * g) @ p.w_o
    return out.to(x.dtype), {"wkv": s1, "shift_tm": xf[:, -1, :]}


def rwkv_channel_mix(
    p, x: torch.Tensor, state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix with token shift. x: (B, T, D) -> (out in
    x's dtype, new shift state)."""
    xf = x.float()
    prev = None if state is None else state["shift_cm"]
    xk = xf + (_token_shift(xf, prev) - xf) * p.cm_mix
    h = F.relu(xk @ p.cm_k)
    out = (h * h) @ p.cm_v
    return out.to(x.dtype), xf[:, -1, :]
