"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) on
torch tensors.

    r_t = sigmoid(z_t @ W_a + b_a)          recurrence gate
    i_t = sigmoid(z_t @ W_x + b_x)          input gate
    a_t = exp(-c * softplus(lam) * r_t)     c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * z_t)

where z is the input branch after a width-``conv_width`` causal temporal
conv. The recurrence runs through :func:`repro_torch.kernels.ops.rglru_scan`:
the CUDA kernel on the card, its plain sequential version on the CPU. The
block computes in fp32 and returns the input's dtype. Decode carries
(h (B, W), conv tail (B, cw-1, W)), both fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, gelu_tanh

C_FACTOR = 8.0


def rglru_param_shapes(d_model: int, width: int, conv_width: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of one block's parameters, in the reference's order."""
    return {
        "w_in": (d_model, width),
        "w_gate_br": (d_model, width),
        "conv_w": (conv_width, width),
        "conv_b": (width,),
        "w_a": (width, width),
        "w_x": (width, width),
        "gate_b": (2, width),
        "lam": (width,),
        "w_out": (width, d_model),
    }


def rglru_param_init(generator: torch.Generator, d_model: int, width: int,
                     conv_width: int) -> Dict[str, torch.Tensor]:
    """fp32 initial values on the generator's device, drawn as the
    reference draws them (other numbers: another generator). ``lam`` starts
    where a^c lies in (0.9, 0.999) at r = 1 (Griffin, section 2.4)."""
    shapes = rglru_param_shapes(d_model, width, conv_width)
    dev = generator.device
    scale = {"conv_w": 0.1, "w_a": 0.01, "w_x": 0.01}
    out = {}
    for name, shape in shapes.items():
        if name in ("conv_b", "gate_b"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif name == "lam":
            value = math.log(math.expm1(-math.log(0.97) / C_FACTOR))
            out[name] = torch.full(shape, value, dtype=torch.float32, device=dev)
        else:
            out[name] = dense_init(shape, generator, scale.get(name))
    return out


def causal_conv1d(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv. z: (B, T, W); w: (cw, W); ``tail``
    (B, cw-1, W): the previous tokens' inputs (zeros at the start). The taps
    are summed in the reference's order. Returns (out, new tail: the last
    cw-1 inputs)."""
    cw, t = w.shape[0], z.shape[1]
    if tail is None:
        tail = torch.zeros((z.shape[0], cw - 1, z.shape[2]), dtype=z.dtype, device=z.device)
    zp = torch.cat([tail, z], dim=1)  # (B, T + cw - 1, W)
    out = sum(zp[:, i:i + t, :] * w[i][None, None, :] for i in range(cw))
    return out + b, zp[:, -(cw - 1):, :] if cw > 1 else tail


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``logaddexp(x, 0)`` computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def rglru_block(p, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gate branch times the conv + RG-LRU branch. x: (B, T, D) -> (out in
    x's dtype, {"h": (B, W), "conv": (B, cw-1, W)}). ``p`` holds the block's
    parameters as attributes."""
    xf = x.float()
    gate = gelu_tanh(xf @ p.w_gate_br)

    z = xf @ p.w_in
    tail = None if state is None else state["conv"]
    z, new_tail = causal_conv1d(z, p.conv_w, p.conv_b, tail)

    r = torch.sigmoid(z @ p.w_a + p.gate_b[0])
    i = torch.sigmoid(z @ p.w_x + p.gate_b[1])
    log_a = -C_FACTOR * _softplus(p.lam) * r  # (B, T, W)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) from log a, for numerical stability
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gated_in = beta * (i * z)

    if state is None:
        h0 = torch.zeros((x.shape[0], z.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        h0 = state["h"]
    h, h_last = ops.rglru_scan(a, gated_in, h0)
    out = (h * gate) @ p.w_out
    return out.to(x.dtype), {"h": h_last, "conv": new_tail}
