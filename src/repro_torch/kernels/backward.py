"""Gradients of the three model kernels, as functions of torch ops.

The reference has no backward kernel: it trains through its plain ``jnp``
code (``BaseLM.use_kernels=False``). These are the backward halves of the
``torch.autograd.Function``s in :mod:`repro_torch.kernels.ops`, whose
forward halves launch the CUDA kernels (their plain versions on the CPU).
Each computes the gradient of the plain version in
:mod:`repro_torch.kernels.ref`, from the saved inputs alone, so the
gradient does not depend on how the kernel rounds; none runs the plain
version under autograd. A ``None`` output gradient counts as zero.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: elements of the fp32 (rows, G, S, T) logits block the flash backward
#: recomputes at once
FLASH_BWD_BLOCK = 1 << 26
#: time steps of the WKV-6 backward's forward recompute: the states of one
#: chunk are held at a time, (B, H, D, D) fp32 each
WKV_BWD_CHUNK = 64


def _zeros_if_none(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like, dtype=torch.float32) if g is None else g.float()


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: Optional[torch.Tensor], *,
    causal: bool = True, window: Optional[int] = None, logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of
    :func:`repro_torch.kernels.ref.flash_attention_ref` at q (B, H, S, D),
    k, v (B, KV, T, D) for the output gradient ``do`` (B, H, S, D), in the
    dtypes of q, k, v.

    The fp32 logits and probabilities P are recomputed from q and k with
    the plain version's scale, softcap and masks, a block of (batch, KV
    group) rows at a time (at most :data:`FLASH_BWD_BLOCK` logits). Then
    dV = P^T dO and dP = dO V^T; dS = P (dP - rowsum(P dP)), times
    1 - tanh^2 under a softcap, zero where masked; dQ = dS K and
    dK = dS^T Q over the fp32 divisor sqrt(D). The GQA groups are summed
    into dK and dV. The rowsum is taken from P, not from the kernel's
    output, so the gradient is the plain version's whatever the kernel
    rounds."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    f4 = torch.float32
    divisor = float(np.sqrt(np.float32(d)))  # an fp32 divisor, as the plain version's
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    n = b * kv  # (batch, KV group) rows
    qn = q.reshape(n, g, s, d)
    kn, vn = k.reshape(n, t, d), v.reshape(n, t, d)
    don = (torch.zeros((n, g, s, d), dtype=f4, device=q.device) if do is None
           else do.reshape(n, g, s, d))
    dq = torch.empty((n, g, s, d), dtype=f4, device=q.device)
    dk = torch.empty((n, t, d), dtype=f4, device=q.device)
    dv = torch.empty((n, t, d), dtype=f4, device=q.device)
    rows = max(1, FLASH_BWD_BLOCK // max(1, g * s * t))  # rows of one block
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        qb, kb, vb, dob = (x[lo:hi].to(f4) for x in (qn, kn, vn, don))
        logits = torch.einsum("ngsd,ntd->ngst", qb, kb) / divisor
        if logit_softcap:
            th = torch.tanh(logits / logit_softcap)
            logits = th * logit_softcap
        p = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
        dv[lo:hi] = torch.einsum("ngst,ngsd->ntd", p, dob)
        dp = torch.einsum("ngsd,ntd->ngst", dob, vb)
        ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
        ds = ds.masked_fill(~mask, 0.0)
        if logit_softcap:
            ds = ds * (1 - th * th)
        ds = ds / divisor
        dq[lo:hi] = torch.einsum("ngst,ntd->ngsd", ds, kb)
        dk[lo:hi] = torch.einsum("ngst,ngsd->ntd", ds, qb)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.reshape(b, kv, t, d).to(k.dtype),
            dv.reshape(b, kv, t, d).to(v.dtype))


def rglru_scan_bwd(
    a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor, dh: Optional[torch.Tensor],
    dh_last: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (da, dx, dh0) of h_t = a_t h_{t-1} + x_t over a (B, T, W)
    from h0 (B, W), given the forward's h (B, T, W) and the gradients of h
    and of the final state h_T (B, W). A reverse scan in fp32:
    g_t = dh_t + a_{t+1} g_{t+1} (the final state's gradient joining at
    t = T), dx_t = g_t, da_t = g_t h_{t-1}, dh0 = a_1 g_1. da and dh0 are
    returned in the dtypes of a and h0, dx in fp32."""
    af = a.float()
    dhf = _zeros_if_none(dh, h)
    carry = _zeros_if_none(dh_last, h0)
    steps = af.shape[1]
    gs = [None] * steps
    for t in range(steps - 1, -1, -1):
        carry = dhf[:, t] + carry
        gs[t] = carry
        carry = af[:, t] * carry
    g = torch.stack(gs, dim=1)
    h_prev = torch.cat([h0.float()[:, None], h[:, :-1]], dim=1)
    return (g * h_prev).to(a.dtype), g, carry.to(h0.dtype)


def _wkv_states(k, v, w, s, keep=True):
    """The state after the last step of a chunk of k, v, w (B, H, T', D)
    from s, and (with ``keep``) the states S_{t-1} before each of its steps
    (T', B, H, D, D)."""
    states = []
    for t in range(k.shape[2]):
        if keep:
            states.append(s)
        s = w[:, :, t, :, None] * s + k[:, :, t, :, None] * v[:, :, t, None, :]
    return (torch.stack(states) if keep else None), s


def rwkv6_scan_bwd(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    s0: torch.Tensor, dy: Optional[torch.Tensor], ds_last: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dw, du, ds0) of the WKV-6 recurrence
    (:func:`repro_torch.kernels.ref.rwkv6_scan_ref`) at r, k, v, w
    (B, H, T, D), u (H, D), s0 (B, H, D, D), given the gradients of y
    (B, H, T, D) and of the final state (B, H, D, D). A reverse scan over
    the state's gradient dS, from the final state's, in fp32:

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        dk_t = u r_t (v_t . dy_t) + dS_t v_t
        dv_t = (r_t . (u k_t)) dy_t + dS_t^T k_t
        dw_t = rowsum(dS_t * S_{t-1})
        du  += r_t k_t (v_t . dy_t)
        dS_{t-1} = r_t dy_t^T + diag(w_t) dS_t

    The states S_{t-1} are recomputed forward from s0, a chunk of
    :data:`WKV_BWD_CHUNK` steps at a time, from the states kept at the
    chunks' starts. Returned in the inputs' dtypes."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :]  # (1, H, D)
    dyf = _zeros_if_none(dy, rf)
    ds = _zeros_if_none(ds_last, s0)
    steps = rf.shape[2]
    starts = list(range(0, steps, WKV_BWD_CHUNK))
    # the state at each chunk's start
    s, heads = s0.float(), []
    for lo in starts:
        heads.append(s)
        hi = min(steps, lo + WKV_BWD_CHUNK)
        _, s = _wkv_states(kf[:, :, lo:hi], vf[:, :, lo:hi], wf[:, :, lo:hi], s, keep=False)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf[0])
    for lo, s_lo in zip(reversed(starts), reversed(heads)):
        hi = min(steps, lo + WKV_BWD_CHUNK)
        prev, _ = _wkv_states(kf[:, :, lo:hi], vf[:, :, lo:hi], wf[:, :, lo:hi], s_lo)
        for t in range(hi - 1, lo - 1, -1):
            r_t, k_t, v_t, w_t, dy_t = (x[:, :, t] for x in (rf, kf, vf, wf, dyf))
            s_prev = prev[t - lo]
            vdy = torch.sum(v_t * dy_t, dim=-1, keepdim=True)  # (B, H, 1)
            dr[:, :, t] = torch.einsum("bhij,bhj->bhi", s_prev, dy_t) + uf * k_t * vdy
            dk[:, :, t] = uf * r_t * vdy + torch.einsum("bhij,bhj->bhi", ds, v_t)
            dv[:, :, t] = (torch.sum(r_t * uf * k_t, dim=-1, keepdim=True) * dy_t
                           + torch.einsum("bhij,bhi->bhj", ds, k_t))
            dw[:, :, t] = torch.sum(ds * s_prev, dim=-1)
            du = du + torch.sum(r_t * k_t * vdy, dim=0)
            ds = r_t[..., :, None] * dy_t[..., None, :] + w_t[..., :, None] * ds
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), ds.to(s0.dtype))
