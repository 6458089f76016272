"""Channel Open / Close / Move transitions as masked tensor updates.

Channel slots live on the trailing C axis, chunk tables on the trailing
K axis, and a ``trig`` (S,) mask gates which rows transition. Closes take
a chunk's channels idle-first in column order, opens take the lowest
free columns, and every close ends with
:func:`repro_torch.eval.fabric.kernels.compact_channels`, so column order
stays the event simulator's channel-list order.

``prepend_sizes`` (S, K, P) / ``prepend_n`` (S, K) hold the LIFO
resume-file stack: a busy channel closed mid-transfer re-queues its
in-flight remainder rounded up to whole bytes, consumed before the FIFO
cursor moves. Callers guarantee stack capacity.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..shim import NO_CHUNK


def _gather(table, idx):
    return torch.gather(table, -1, idx.unsqueeze(-1)).squeeze(-1)


def _close_and_pack(trig, sel, chunk_of, busy, dead, rem, cap):
    """Free the ``sel`` columns, then left-pack ``trig`` rows."""
    return kernels.compact_channels(
        trig,
        torch.where(sel, NO_CHUNK, chunk_of),
        torch.where(sel, False, busy),
        torch.where(sel, 0.0, dead),
        torch.where(sel, 0.0, rem),
        torch.where(sel, 0.0, cap),
    )


def close_chunk(trig, k, chunk_of, busy, dead, rem, cap):
    """Close every channel of chunk ``k`` (an int or an (S,) tensor) on
    ``trig`` rows, then left-pack the survivors."""
    k = torch.as_tensor(k, dtype=torch.int64, device=chunk_of.device)
    sel = trig.unsqueeze(-1) & (chunk_of == k.unsqueeze(-1))
    return _close_and_pack(trig, sel, chunk_of, busy, dead, rem, cap)


def open_ranked(n_open, target, chunk_of, dead, cap, setup_cost, cap_k):
    """Open ``n_open`` (S,) fresh channels for chunk ``target`` (S,) at the
    lowest free columns, at the full setup cost. Callers guarantee the
    free slots. Returns ``(chunk_of, dead, cap)``."""
    free = chunk_of == NO_CHUNK
    rank = torch.cumsum(free.to(torch.int64), dim=-1) - 1
    sel = free & (rank < n_open.unsqueeze(-1))
    return (
        torch.where(sel, target.unsqueeze(-1), chunk_of),
        torch.where(sel, setup_cost.unsqueeze(-1), dead),
        torch.where(sel, _gather(cap_k, target).unsqueeze(-1), cap),
    )


def sc_advance_cursor(trig, cursor, order, nfiles, n_chunks):
    """SC cursor step after a chunk completion: advance one position, then
    skip empty size classes. ``order`` (S, K) is the largest-first
    permutation, ``n_chunks`` (S,) the real chunk count."""
    K = order.shape[-1]
    cursor = torch.where(trig, cursor + 1, cursor)
    for _ in range(K):
        idx = _gather(order, torch.clamp(cursor, 0, K - 1))
        adv = trig & (cursor < n_chunks) & (_gather(nfiles, idx) == 0)
        cursor = torch.where(adv, cursor + 1, cursor)
    return cursor


def move_channel(
    trig, src, dst, chunk_of, busy, dead, rem, cap, queue_bytes,
    prepend_sizes, prepend_n, n_moves, par, cap_k, setup_cost,
):
    """Move one channel from chunk ``src`` to chunk ``dst`` (S,) on ``trig``
    rows (the ProMC tick re-allocation): the source's idle-first lowest
    column closes (a busy victim pushes its remainder on the resume
    stack), then the lowest free column opens for ``dst`` — at a quarter
    of the setup cost when the two chunks share a parallelism level."""
    C = chunk_of.shape[-1]
    K = queue_bytes.shape[-1]
    P = prepend_sizes.shape[-1]
    dev = chunk_of.device
    cols = torch.arange(C, dtype=torch.int64, device=dev)

    is_src = chunk_of == src.unsqueeze(-1)
    idle_key = torch.where(is_src & ~busy, cols, 2 * C)
    busy_key = torch.where(is_src & busy, cols, 2 * C)
    have_idle = idle_key.amin(dim=-1) < 2 * C
    chosen = torch.where(
        have_idle, idle_key.argmin(dim=-1), busy_key.argmin(dim=-1)
    )
    oh = (cols == chosen.unsqueeze(-1)) & trig.unsqueeze(-1)

    # resume push: a busy victim's in-flight remainder restarts later
    rem_c = torch.where(oh, rem, 0.0).sum(dim=-1)
    push = trig & (oh & busy).any(dim=-1) & (rem_c > 0.0)
    size = torch.ceil(rem_c)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    koh = (ks == src.unsqueeze(-1)) & push.unsqueeze(-1)
    queue_bytes = queue_bytes + torch.where(koh, size.unsqueeze(-1), 0.0)
    pn_src = _gather(prepend_n, src)
    ps_flat = prepend_sizes.reshape(prepend_sizes.shape[:-2] + (K * P,))
    slot = src * P + torch.clamp(pn_src, 0, P - 1)
    slots = torch.arange(K * P, dtype=torch.int64, device=dev)
    ps_flat = torch.where(
        (slots == slot.unsqueeze(-1)) & push.unsqueeze(-1),
        size.unsqueeze(-1),
        ps_flat,
    )
    prepend_sizes = ps_flat.reshape(prepend_sizes.shape)
    prepend_n = prepend_n + koh.to(prepend_n.dtype)

    # close the chosen column and left-pack, so the open appends at the
    # end of the channel list; then open the first free column for dst
    chunk_of, busy, dead, rem, cap = _close_and_pack(
        trig, oh, chunk_of, busy, dead, rem, cap
    )
    fcol = torch.argmax((chunk_of == NO_CHUNK).to(torch.uint8), dim=-1)
    oh2 = (cols == fcol.unsqueeze(-1)) & trig.unsqueeze(-1)
    cost = torch.where(
        _gather(par, src) == _gather(par, dst), 0.25 * setup_cost, setup_cost
    )
    chunk_of = torch.where(oh2, dst.unsqueeze(-1), chunk_of)
    dead = torch.where(oh2, cost.unsqueeze(-1), dead)
    cap = torch.where(oh2, _gather(cap_k, dst).unsqueeze(-1), cap)
    n_moves = n_moves + trig.to(n_moves.dtype)
    return (
        chunk_of, busy, dead, rem, cap, queue_bytes, prepend_sizes,
        prepend_n, n_moves,
    )


def apply_grants(
    trig, src, grants, first_rank, chunk_of, busy, dead, rem, cap,
    n_moves, par, cap_k, setup_cost,
):
    """Re-target the freed (idle) channels of completed chunk ``src`` (an
    int or an (S,) tensor) to the laggards chosen by
    :func:`..decide.laggard_grants`: the flattened grant sequence, in
    first-grant order, claims the lowest free columns in order."""
    K = grants.shape[-1]
    C = chunk_of.shape[-1]
    dev = chunk_of.device
    total = grants.sum(dim=-1)
    src = torch.as_tensor(src, dtype=torch.int64, device=dev).expand(total.shape)
    ks = torch.arange(K, dtype=torch.int64, device=dev)

    sel = trig.unsqueeze(-1) & (chunk_of == src.unsqueeze(-1))
    closed, busy, dead, rem, cap0 = _close_and_pack(
        trig, sel, chunk_of, busy, dead, rem, cap
    )

    # offsets of each destination's slice in the flattened grant sequence
    big = C * K + 1
    fr = torch.where(grants > 0, first_rank, big)
    earlier = fr.unsqueeze(-2) < fr.unsqueeze(-1)
    off = torch.where(earlier, grants.unsqueeze(-2), 0).sum(dim=-1)

    free = closed == NO_CHUNK
    frank = torch.cumsum(free.to(torch.int64), dim=-1) - 1
    assign = free & (frank < total.unsqueeze(-1)) & trig.unsqueeze(-1)
    # (S, K, C) membership of each column's sequence slot in dst d's slice
    fr_c = frank.unsqueeze(-2)
    ind = (
        (fr_c >= off.unsqueeze(-1))
        & (fr_c < (off + grants).unsqueeze(-1))
        & (grants > 0).unsqueeze(-1)
        & assign.unsqueeze(-2)
    )
    dst_col = (ks.unsqueeze(-1) * ind).sum(dim=-2)
    hit = ind.any(dim=-2)
    dst_clip = torch.clamp(dst_col, 0, K - 1)
    par_dst = torch.gather(par, -1, dst_clip)
    sc = setup_cost.unsqueeze(-1)
    cost = torch.where(
        par_dst == _gather(par, src).unsqueeze(-1), 0.25 * sc, sc
    )
    chunk_of = torch.where(hit, dst_col, closed)
    dead = torch.where(hit, cost, dead)
    cap = torch.where(hit, torch.gather(cap_k, -1, dst_clip), cap0)
    n_moves = n_moves + torch.where(trig, total, 0)
    return chunk_of, busy, dead, rem, cap, n_moves
