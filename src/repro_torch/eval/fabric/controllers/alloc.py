"""Initial channel allocations: Alg. 2 round-robin and Alg. 3
delta-weighted distribution, over the trailing chunk axis (K)."""
from __future__ import annotations

import math

import torch


def round_robin_alloc(order_rank, nonempty, max_cc):
    """Alg. 2 lines 8-12: maxCC channels round-robin over the live chunks
    in (rank, index) order. The chunk at position ``p`` receives
    ``maxCC // n_live`` plus one if ``p < maxCC % n_live``. Returns (..., K)
    int64 (0 for empty chunks)."""
    rank = order_rank.to(torch.int64)
    K = rank.shape[-1]
    key = rank * K + torch.arange(K, dtype=torch.int64, device=rank.device)
    pos = (
        (key.unsqueeze(-1) > key.unsqueeze(-2)) & nonempty.unsqueeze(-2)
    ).sum(dim=-1)
    n_live = torch.clamp(nonempty.sum(dim=-1), min=1).unsqueeze(-1)
    mc = max_cc.to(torch.int64).unsqueeze(-1).expand(pos.shape)
    alloc = mc // n_live + (pos < mc % n_live).to(torch.int64)
    return torch.where(nonempty, alloc, 0)


def weighted_alloc(weights, nonempty, max_cc, trim_iters: int):
    """Alg. 3 lines 5-12: ``floor(weight_i / total * maxCC)`` channels per
    chunk, at least one per non-empty chunk; over-allocation is trimmed
    from the largest allocations (ties toward the smallest share, then the
    lowest index, never below 1) and leftovers granted round-robin by
    descending fractional share. ``trim_iters`` >= K. Returns (..., K)
    int64 summing to ``max(maxCC, n_live)`` where any chunk is live."""
    w = torch.where(nonempty, weights.to(torch.float64), 0.0)
    total = w.sum(dim=-1, keepdim=True)
    total = torch.where(total == 0.0, 1.0, total)
    mc = max_cc.to(torch.float64).unsqueeze(-1)
    shares = w / total * mc
    floors = torch.floor(shares)
    alloc = torch.where(nonempty, torch.clamp(floors, min=1.0), 0.0).to(torch.int64)

    n_live = nonempty.sum(dim=-1)
    budget = torch.maximum(max_cc.to(torch.int64), n_live)
    K = alloc.shape[-1]
    ks = torch.arange(K, dtype=torch.int64, device=alloc.device)

    # trim: decrement the lexicographic-max (alloc, -share) holder while
    # over budget; stop at one channel
    for _ in range(trim_iters):
        over = alloc.sum(dim=-1) > budget
        a_max = torch.where(nonempty, alloc, -1).amax(dim=-1)
        m1 = nonempty & (alloc == a_max.unsqueeze(-1))
        s_min = torch.where(m1, shares, math.inf).amin(dim=-1)
        m2 = m1 & (shares == s_min.unsqueeze(-1))
        sel = torch.argmax(m2.to(torch.uint8), dim=-1, keepdim=True)
        can = over & (torch.gather(alloc, -1, sel).squeeze(-1) > 1)
        alloc = alloc - ((ks == sel) & can.unsqueeze(-1)).to(torch.int64)

    # grant: leftovers round-robin by descending fractional part (stable)
    frac = shares - floors
    ahead = (frac.unsqueeze(-2) > frac.unsqueeze(-1)) | (
        (frac.unsqueeze(-2) == frac.unsqueeze(-1))
        & (ks.unsqueeze(-2) < ks.unsqueeze(-1))
    )
    pos = (ahead & nonempty.unsqueeze(-2)).sum(dim=-1)
    deficit = torch.clamp(budget - alloc.sum(dim=-1), min=0).unsqueeze(-1)
    nl = torch.clamp(n_live, min=1).unsqueeze(-1)
    add = deficit // nl + (pos < deficit % nl).to(torch.int64)
    return torch.where(nonempty, alloc + add, 0)
