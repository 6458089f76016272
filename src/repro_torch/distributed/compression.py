"""Gradient compression for the collectives between ranks (beyond-paper),
the reference's ``distributed/compression.py`` in torch ops.

Two codecs, applied per chunk class by the sync plan:
  * bf16 — each rank's gradient rounded to bf16 (half the wire bytes, no
    state; safe for bandwidth-bound buckets).
  * int8 + error feedback — per-tensor max-abs scaling with the residual
    carried into the next step (EF keeps SGD/Adam convergence; see
    Karimireddy et al. 2019). A quarter of the wire bytes.

The operations run in the reference's order (fp32 cast, ``+ ef``, the
scale ``max(max |g|, 1e-30) / 127``, round half to even, clip to +-127),
so ``q`` and ``scale`` equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def int8_encode(
    g: torch.Tensor, ef: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale fp32 0-d, new error-feedback residual fp32)."""
    gf = g.to(torch.float32)
    if ef is not None:
        gf = gf + ef.to(torch.float32)
    scale = torch.clamp_min(gf.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    residual = gf - deq
    return q, scale, residual


def int8_decode(q_sum: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode int8 payloads (or their sum, accumulated in int32)."""
    return q_sum.to(torch.float32) * scale


def bf16_roundtrip(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16).to(g.dtype)


def compression_error(g: torch.Tensor, codec: str) -> torch.Tensor:
    """Relative L2 error of one-shot compression (diagnostics)."""
    gf = g.to(torch.float32)
    if codec == "bf16":
        d = bf16_roundtrip(gf)
    elif codec == "int8":
        q, s, _ = int8_encode(gf)
        d = int8_decode(q.to(torch.int32), s)
    else:
        return torch.zeros((), dtype=torch.float32, device=gf.device)
    return torch.linalg.vector_norm(gf - d) / torch.clamp_min(torch.linalg.vector_norm(gf), 1e-30)
