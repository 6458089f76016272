"""Decision kernels: chunk ETA views, the ProMC streak state machine and
the laggard-ETA-discounting grant loop.

Ties resolve like Python's ``min``/``max`` over index-ordered sequences
(first winner): ``argmax`` of an "equals the extremum" mask returns the
lowest index, including when the extremum is ``inf``.
"""
from __future__ import annotations

import math

import torch


def _gather(table, idx):
    """``table[..., idx]`` for per-row indices: (..., K) x (...,) -> (...,)."""
    return torch.gather(table, -1, idx.unsqueeze(-1)).squeeze(-1)


def _first(mask):
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def chunk_eta(bytes_remaining, throughput, predicted, done):
    """Estimated completion time per chunk (Sec. 3.3): remaining bytes over
    the measured rate, the model prediction before data flows; 0 for
    finished chunks, inf without any rate information."""
    rate = torch.where(throughput > 0.0, throughput, predicted)
    eta = torch.where(
        rate > 0.0,
        bytes_remaining / torch.where(rate > 0.0, rate, 1.0),
        math.inf,
    )
    return torch.where(done | (bytes_remaining <= 0.0), 0.0, eta)


def predicted_chunk_rate(
    avg_file_size, cap, dead_time, n_channels, total_open, bandwidth,
    disk_rate, saturation_cc, contention,
):
    """Closed-form steady-state throughput estimate per chunk (...,K) for
    cold ETAs; the network scalars are (...,)."""
    n = torch.clamp(n_channels, min=1)
    total = torch.clamp(total_open, min=1).unsqueeze(-1)
    over = torch.clamp(total - saturation_cc.unsqueeze(-1), min=0)
    penalty = 1.0 / (1.0 + contention.unsqueeze(-1) * over)
    agg = disk_rate.unsqueeze(-1) * penalty
    pool = torch.minimum(bandwidth.unsqueeze(-1), agg)
    rate = torch.minimum(cap, pool / total)
    t_file = dead_time + avg_file_size / torch.clamp(rate, min=1e-9)
    return n * avg_file_size / t_file


def promc_tick(eta, throughput, n_channels, live, streak, pair_fast, pair_slow, ratio, patience):
    """One ProMC periodic check (Sec. 3.4, Alg. 3) as a masked update.

    Returns ``(streak, pair_fast, pair_slow, move, src, dst)``: ``move``
    is True where a channel moves from ``src`` (fastest ETA) to ``dst``
    (slowest). Fewer than two contenders resets the streak, an unmeasured
    infinite-ETA laggard freezes it, an imbalanced pair extends or
    restarts it, and ``patience`` imbalanced periods fire the move."""
    lv = live & (n_channels > 0)
    few = lv.sum(dim=-1) < 2

    min_eta = torch.where(lv, eta, math.inf).amin(dim=-1)
    max_eta = torch.where(lv, eta, -math.inf).amax(dim=-1)
    fast = _first(lv & (eta == min_eta.unsqueeze(-1)))
    slow = _first(lv & (eta == max_eta.unsqueeze(-1)))
    eta_f = _gather(eta, fast)
    eta_s = _gather(eta, slow)
    wait_meas = ~few & ~torch.isfinite(eta_s) & (_gather(throughput, slow) == 0.0)

    imb = (eta_s >= ratio * eta_f) & (fast != slow) & (_gather(n_channels, fast) > 1)
    same = (fast == pair_fast) & (slow == pair_slow)
    streak_upd = torch.where(
        imb & same, streak + 1, torch.where(imb, 1, 0)
    )
    fire = ~few & ~wait_meas & imb & (streak_upd >= patience)

    hold = wait_meas
    reset = few | fire
    streak_out = torch.where(hold, streak, torch.where(reset, 0, streak_upd))
    pair_ok = ~hold & ~reset & imb
    pf_out = torch.where(hold, pair_fast, torch.where(pair_ok, fast, -1))
    ps_out = torch.where(hold, pair_slow, torch.where(pair_ok, slow, -1))
    return streak_out, pf_out, ps_out, fire, fast, slow


def laggard_grants(eta, owners, live, n_grants, max_iters: int):
    """Hand ``n_grants`` (...,) freed channels to the largest-ETA chunks one
    at a time, discounting a receiver's ETA by ``n/(n+1)`` as it gains
    channels (Sec. 3.3). ``max_iters`` >= the most grants of any row.

    Returns ``(grants, first_rank)``: per-chunk grant counts and the step
    of each chunk's first grant (``max_iters`` if never granted)."""
    K = eta.shape[-1]
    ks = torch.arange(K, dtype=torch.int64, device=eta.device)
    e = eta.to(torch.float64)
    grants = torch.zeros_like(owners, dtype=torch.int64)
    first = torch.full_like(grants, max_iters)
    any_live = live.any(dim=-1)
    for i in range(max_iters):
        active = (i < n_grants) & any_live
        cur = torch.where(live, e, -math.inf).amax(dim=-1)
        dst = _first(live & (e == cur.unsqueeze(-1)))
        hit = (ks == dst.unsqueeze(-1)) & active.unsqueeze(-1)
        grants = grants + hit.to(torch.int64)
        first = torch.where(hit & (first == max_iters), i, first)
        n = _gather(owners + grants, dst)
        factor = torch.where(n > 1, (n - 1.0) / torch.clamp(n, min=1), 0.5)
        e = torch.where(hit & torch.isfinite(e), e * factor.unsqueeze(-1), e)
    return grants, first
