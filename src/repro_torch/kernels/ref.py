"""Plain PyTorch versions of the LLM scaffold's kernels.

Each is the single plain version of its kernel: the CPU path of the
kernel's wrapper, and what ``chip_smoke.py`` and the card tests hold the
kernel to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention in one pass, the function the flash kernel
    computes.

    q: (B, H, S, D); k, v: (B, KV, T, D), H % KV == 0; query i and key j sit
    at positions i and j. A key attends when it is <= the query (causal) and
    > the query minus ``window``. Logits and softmax in fp32, masked logits
    at -1e30; returns (B, H, S, D) in q's dtype. A query that no key may
    attend gets the mean of v (a softmax over equal logits), where the
    kernel returns zeros.
    """
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    f4 = torch.float32
    qg = q.reshape(b, kv, h // kv, s, d).to(f4)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(f4))
    logits = logits / float(np.sqrt(np.float32(d)))  # an fp32 divisor
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(f4))
    return out.reshape(b, h, s, d).to(q.dtype)


def rwkv6_scan_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 recurrence, step by step.

    r, k, v, w: (B, H, T, D); u: (H, D); s0: (B, H, D, D) [key x value].
        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    T >= 1. Returns y (B, H, T, D) fp32 and S_T (B, H, D, D) fp32.
    """
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(rf.shape[2]):
        r_t, k_t, v_t, w_t = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, D, D)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, s + uf * kv))
        s = w_t[..., None] * s + kv
    return torch.stack(ys, dim=2), s


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence, step by step: h_t = a_t * h_{t-1} + x_t.

    a, x: (B, T, W); h0: (B, W); T >= 1. Inputs are upcast to fp32.
    Returns h (B, T, W) fp32 and h_T (B, W) fp32.
    """
    af, xf = a.float(), x.float()
    h = h0.float()
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + xf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_chunked_plain(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
                             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence as a scan chunked over time would compute it,
    for the tests that weigh that design against the serial walk.

    Time is cut into chunks of ``chunk`` steps (the last may be shorter).
    1. Each chunk's map h -> A h + X from its own steps: A = a_t A and
       X = a_t X + x_t from A = 1, X = 0.
    2. The carries in order: c_0 = h0, c_{j+1} = A_j c_j + X_j.
    3. Each chunk walked again from its carry, in :func:`rglru_scan_ref`'s
       order.
    Every product and sum rounds on its own, in fp32. Same shapes and
    returns as :func:`rglru_scan_ref`; the first chunk equals it bit for bit.
    """
    af, xf = a.float(), x.float()
    steps = af.shape[1]
    cuts = list(range(0, steps, chunk)) + [steps]
    maps = []
    for lo, hi in zip(cuts, cuts[1:]):
        big_a = torch.ones_like(h0, dtype=torch.float32)
        big_x = torch.zeros_like(h0, dtype=torch.float32)
        for t in range(lo, hi):
            big_a = af[:, t] * big_a
            big_x = af[:, t] * big_x + xf[:, t]
        maps.append((big_a, big_x))
    carry = [h0.float()]
    for big_a, big_x in maps[:-1]:
        carry.append(big_a * carry[-1] + big_x)
    hs = []
    for (lo, hi), h in zip(zip(cuts, cuts[1:]), carry):
        for t in range(lo, hi):
            h = af[:, t] * h + xf[:, t]
            hs.append(h)
    return torch.stack(hs, dim=1), h
