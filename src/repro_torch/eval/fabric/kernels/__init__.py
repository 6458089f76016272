"""Fluid kernels of the batched transfer model, on torch tensors.

Every function treats the channel (C) / chunk (K) structure as the
trailing axes and broadcasts over a leading scenario axis S; every
tensor it makes names its dtype and device. The operation order of each
kernel is the NumPy reference's, so on the CPU the results agree with it
bit for bit wherever the reference does no summation (and to the last
bits where the order of a sum differs). One rule departs from the
reference: the water level's candidate is tested against its cap
exactly, where the reference allows it ``1e-9 * max(cap, 1)`` above (see
:func:`_level_of_prefix`); the two differ only where a candidate falls
in that gap.

The two CUDA kernels of the sweep live in :mod:`.waterfill_bisect` (the
bisected water level) and :mod:`.fused_step` (whole resume-free sweep
steps, one a launch or a row's steps in a loop); the functions here are
what the split sweep and the controllers run around them.
"""
from __future__ import annotations

import math

import torch

from ..shim import NO_CHUNK, TorchOps

_EPS = 1e-12
_INF = math.inf


def _ordered_prefix(caps_sorted, width: int):
    """``cumsum`` of non-negative sorted rows whose nonzero entries lie in
    the last ``width`` columns, summed in order on any device (the columns
    before hold 0, so the sums there are 0 and the first nonzero one is
    exact); a CUDA ``cumsum`` may associate the sums otherwise."""
    C = caps_sorted.shape[-1]
    acc = torch.zeros_like(caps_sorted[..., 0])
    tail = []
    for j in range(C - width, C):
        acc = acc + caps_sorted[..., j]
        tail.append(acc)
    return torch.cat([torch.zeros_like(caps_sorted[..., : C - width]),
                      torch.stack(tail, dim=-1)], dim=-1)


def _level_of_prefix(caps_sorted, prefix, pool):
    """The water level of sorted caps with their prefix sums."""
    C = caps_sorted.shape[-1]
    pool_eff = torch.clamp(torch.minimum(pool, prefix[..., -1]), min=0.0)
    # candidate level if the k smallest caps are filled outright:
    #   lam_k = (pool_eff - prefix[k-1]) / (C - k); valid when lam_k <= c_(k).
    # The test is exact: a slack above c_(k) would take a level past a cap
    # the pool does fill, and the others would then get less than the pool
    # leaves them (the sum of the grants short of ``pool_eff``)
    prev = torch.cat(
        [torch.zeros_like(prefix[..., :1]), prefix[..., :-1]], dim=-1
    )
    ks = torch.arange(C, dtype=torch.int64, device=caps_sorted.device)
    denom = (C - ks).to(caps_sorted.dtype)
    lam_k = (pool_eff.unsqueeze(-1) - prev) / denom
    valid = lam_k <= caps_sorted
    # first valid k; rows with no valid candidate take the largest cap
    k = torch.argmax(valid.to(torch.uint8), dim=-1, keepdim=True)
    no_valid = ~valid.any(dim=-1)
    lam = torch.gather(lam_k, -1, k).squeeze(-1)
    return torch.where(no_valid, caps_sorted[..., -1], lam)


def _sorted_levels(caps, pool):
    """Shared core of :func:`waterfill` / :func:`waterfill_level`: the
    sorted caps, their prefix sums and the chosen water level."""
    caps_sorted = torch.sort(caps, dim=-1).values
    prefix = torch.cumsum(caps_sorted, dim=-1)
    return prefix, _level_of_prefix(caps_sorted, prefix, pool)


def waterfill(caps, pool):
    """Max-min fair allocation of ``pool`` (...,) across entities capped at
    ``caps`` (..., C); absent/idle channels carry cap 0. Closed form: every
    entity gets ``min(cap, lam)`` for the level ``lam`` solving
    ``sum_i min(cap_i, lam) = min(pool, sum_i cap_i)``, found by sorting
    each row once."""
    if caps.shape[-1] == 0:
        return torch.zeros_like(caps)
    _, lam = _sorted_levels(caps, pool)
    return torch.minimum(caps, lam.unsqueeze(-1))


def waterfill_level(caps, pool):
    """The water level of :func:`waterfill` (...,): ``+inf`` where the pool
    does not bind (``pool >= sum(caps)``)."""
    if caps.shape[-1] == 0:
        return pool * 0.0 + _INF
    prefix, lam = _sorted_levels(caps, pool)
    return torch.where(pool >= prefix[..., -1], _INF, lam)


def caps_total(caps):
    """Per-row cap total through the same sorted prefix sum
    :func:`waterfill` uses (not ``sum``, whose order may differ in the
    last bit)."""
    if caps.shape[-1] == 0:
        return torch.zeros(caps.shape[:-1], dtype=caps.dtype, device=caps.device)
    return torch.cumsum(torch.sort(caps, dim=-1).values, dim=-1)[..., -1]


#: Jacobi sweeps of :func:`waterfill_coupled`. A sweep carries a link's
#: constraint one link-sharing hop, so this bounds the fabric diameter that
#: is resolved exactly (tenant groups have 1-4 links); every leg (event,
#: split, loop) runs the same count, so their grants agree bit for bit
COUPLED_ITERS = 12


def _coupled_levels(demand, member, link_cap, width: int):
    """The Jacobi sweeps of :func:`waterfill_coupled` on a non-empty
    ``member`` (L, R) bool table: the (L,) final levels and the sweeps
    run."""
    L, R = member.shape
    width = min(max(width, 1), R)
    levels = torch.full((L,), _INF, dtype=demand.dtype, device=demand.device)
    if R == 0:  # links without rows never saturate
        return levels, 1
    ar = torch.arange(L, device=demand.device)
    # (L, L') exclusion mask: link l sees every link but itself
    off_diag = ar[:, None] != ar[None, :]
    for sweep in range(1, COUPLED_ITERS + 1):
        lvl_mat = torch.where(member, levels[:, None], _INF)  # (L, R)
        # the lowest level among the row's other links: (L, L', R) -> (L, R)
        excl = torch.where(off_diag[:, :, None], lvl_mat[None, :, :], _INF).amin(dim=1)
        caps = torch.where(member, torch.minimum(demand[None, :], excl), 0.0)
        # a link's caps are nonzero on its members only: its prefix sums the
        # sorted tail in order, as the CPU's cumsum and the loop kernel do
        caps_sorted = torch.sort(caps, dim=-1).values
        prefix = _ordered_prefix(caps_sorted, width)
        lam = _level_of_prefix(caps_sorted, prefix, link_cap)
        prev, levels = levels, torch.where(link_cap >= prefix[..., -1], _INF, lam)
        if torch.equal(levels, prev):  # the fixed point: later sweeps repeat it
            break
    return levels, sweep


def _grant(demand, member, levels):
    """Each row's demand held to the lowest level among its links."""
    row_lvl = torch.where(member, levels[:, None], _INF).amin(dim=0)
    return torch.minimum(demand, row_lvl)


def waterfill_coupled(demand, member, link_cap):
    """Max-min fair share across rows coupled by shared links.

    ``demand`` (R,) float64: each row's offered load, ``min(pool, total of
    its transferring caps)`` (0 for a row that does not step);
    ``member`` (L, R) bool (or 0/1): link membership; ``link_cap`` (L,)
    float64. Returns ``(x, levels)``: the grant ``x_r = min(d_r, min over
    the row's links of level_l)`` (R,) and the (L,) final levels, ``+inf``
    where a link is not saturated.

    Jacobi relaxation on the per-link levels, from all links unsaturated:
    each sweep re-solves every link's single-link level (the closed form
    of :func:`waterfill_level`) with its members capped at ``min(demand,
    the lowest level among the row's other links)``, for
    :data:`COUPLED_ITERS` sweeps. The fixed point is progressive filling's
    bottleneck characterization (``reference.coupled_fair_share``). A
    sweep is a function of the levels alone, so one whose levels equal the
    last one's is a fixed point and the sweeps stop there, with the levels
    the remaining sweeps would repeat (a host read a sweep). A row on no
    link passes through: ``x_r = d_r``."""
    if member.shape[0] == 0:
        return demand, torch.zeros((0,), dtype=demand.dtype, device=demand.device)
    member = member != 0
    levels, _ = _coupled_levels(demand, member, link_cap, int(member.sum(dim=1).max()))
    return _grant(demand, member, levels), levels


def coupled_pool(pool, total, live, fab):
    """The rate pools (S,) of a step with shared fabrics ``fab`` (the
    coupled loop's fabric, ``fused_step.fabric_operands``): a row of a
    group (``group_id >= 0``) gets its :func:`waterfill_coupled` grant, a
    row outside every group keeps ``pool``. A ``live`` row of a group
    offers ``min(pool, total)``, ``total`` its transferring caps summed in
    the order of the water-fill the step then runs (so an unsaturated grant
    is that water-fill's own ``min(pool, total)``); the rest offer 0.
    Returns ``(pools, sweeps)``, ``sweeps`` the Jacobi sweeps run, each
    one host read."""
    in_group = fab["group_id"] >= 0
    demand = torch.where(live & in_group, torch.minimum(pool, total), 0.0)
    member = fab["member"]
    if member.shape[0] == 0:
        return pool, 0
    levels, sweeps = _coupled_levels(demand, member, fab["link_cap"], fab["width"])
    return torch.where(in_group, _grant(demand, member, levels), pool), sweeps


def lockstep_dt(dt, live, group_id, n_groups: int):
    """The step lengths (S,) of a step with shared fabrics: each ``live``
    row of a group advances by the least ``dt`` of its group's live rows;
    the other rows keep their own."""
    if n_groups == 0:
        return dt
    in_step = live & (group_id >= 0)
    gi = torch.clamp(group_id, min=0)
    g_dt = torch.full((n_groups,), _INF, dtype=dt.dtype, device=dt.device).scatter_reduce(
        0, gi, torch.where(in_step, dt, _INF), "amin"
    )
    return torch.where(in_step, g_dt[gi], dt)


def disk_pool(n_transferring, bandwidth, disk_rate, saturation_cc, contention):
    """Shared rate pool: ``min(bandwidth, disk aggregate)`` with the disk's
    contention penalty past saturation; 0 when nothing transfers."""
    over_sat = torch.clamp(n_transferring - saturation_cc, min=0)
    agg_disk = disk_rate / (1.0 + contention * over_sat)
    return torch.where(
        n_transferring > 0, torch.minimum(bandwidth, agg_disk), 0.0
    )


def bandwidth_now(bw, prof_t, prof_mult, t):
    """Effective bandwidth (S,) under the piecewise-constant profile
    ``prof_t`` / ``prof_mult`` (S, B) at time ``t`` (S,), and the time of
    each row's next profile step (inf past the last; always inf for a
    width-1, static profile)."""
    if prof_t.shape[1] == 1:
        return bw, torch.full_like(t, _INF)
    at = (prof_t <= t.unsqueeze(-1)).sum(dim=-1) - 1
    mult = torch.gather(prof_mult, -1, torch.clamp(at, min=0).unsqueeze(-1)).squeeze(-1)
    eff_bw = bw * torch.where(at >= 0, mult, 1.0)
    nxt = torch.where(prof_t > t.unsqueeze(-1), prof_t, _INF).amin(dim=-1)
    return eff_bw, nxt


def file_dead_time(control_rtt, pipelining, unhidden_overhead, per_file_overhead):
    """Serial per-file overhead: control gap ``control_rtt/(1+pipelining)``
    + unhidden server-side processing + per-file disk overhead."""
    gap = control_rtt / (1.0 + pipelining)
    return gap + unhidden_overhead + per_file_overhead


def event_horizon(tick_dt, busy, dead, transferring, rem, rates, eps: float = _EPS):
    """Time to the next state change (...,), capped by ``tick_dt``: the
    earliest dead-time expiry or file completion of a busy channel,
    floored at 0."""
    dead_evt = torch.where(busy & (dead > eps), dead, _INF)
    xcond = transferring & (rates > eps)
    xfer_evt = torch.where(xcond, rem, _INF) / torch.where(xcond, rates, 1.0)
    dt = torch.minimum(
        tick_dt,
        torch.minimum(dead_evt.amin(dim=-1), xfer_evt.amin(dim=-1)),
    )
    return torch.clamp(dt, min=0.0)


def advance_channels(active, dt, busy, dead, transferring, rem, rates, eps: float = _EPS):
    """Advance channel state by ``dt`` on ``active`` rows: burn dead time,
    move fluid bytes. Returns ``(busy, dead, rem, moved, finished)``."""
    a = active.unsqueeze(-1)
    dtc = dt.unsqueeze(-1)
    in_dead = busy & (dead > eps) & a
    dead2 = torch.where(in_dead, torch.clamp(dead - dtc, min=0.0), dead)
    moving = transferring & (rates > eps) & a
    moved = torch.where(moving, torch.minimum(rem, rates * dtc), 0.0)
    rem2 = rem - moved
    finished = transferring & a & (rem2 <= eps)
    busy2 = busy & ~finished
    rem3 = torch.where(finished, 0.0, rem2)
    return busy2, dead2, rem3, moved, finished


def tick_ema(rate_est, delivered, delivered_at_tick, period):
    """Measured-rate refresh at a controller tick: the first measurement
    seeds the estimate, later ones blend 50/50."""
    inst = (delivered - delivered_at_tick) / period
    return torch.where(rate_est == 0.0, inst, 0.5 * rate_est + 0.5 * inst)


def compact_channels(trig, chunk_of, busy, dead, rem, cap):
    """Left-pack the channel axis on ``trig`` rows: open channels move to
    the lowest columns keeping their order, freed columns collect at the
    tail in the empty state. Column order is the event simulator's
    channel-list order (closes remove, opens append), which the feed
    ranking and idle-victim selection key on.

    Returns ``(chunk_of, busy, dead, rem, cap)``."""
    C = chunk_of.shape[-1]
    is_open = chunk_of != NO_CHUNK
    # source column of each destination: open columns first, stable
    order = torch.argsort((~is_open).to(torch.uint8), dim=-1, stable=True)
    cols = torch.arange(C, dtype=torch.int64, device=chunk_of.device)
    filled = cols < is_open.sum(dim=-1, keepdim=True)
    t = trig.unsqueeze(-1)

    def pack(arr, empty):
        out = torch.where(filled, torch.gather(arr, -1, order), empty)
        return torch.where(t, out, arr)

    return (
        pack(chunk_of, NO_CHUNK),
        pack(busy, False),
        pack(dead, 0.0),
        pack(rem, 0.0),
        pack(cap, 0.0),
    )


def timeline_push(rec, t, rate, buf_t, buf_r, length, stride, seen, last_t, last_r):
    """Streaming append into the fixed-budget timeline ring with
    uniform-stride decimation: when a store would overflow the budget
    ``T = buf_t.shape[-1]`` the buffer keeps every other sample and the
    stride doubles. Pure selects and integer bookkeeping. Returns the
    seven updated tensors in argument order."""
    T = buf_t.shape[-1]
    cols = torch.arange(T, dtype=torch.int64, device=buf_t.device)
    stride_safe = torch.clamp(stride, min=1)
    want = rec & (seen % stride_safe == 0)
    full = want & (length >= T)
    # stride-2 compaction: storage position j keeps old position 2j
    half = (T + 1) // 2
    comp_t = torch.cat([buf_t[..., 0::2], torch.zeros_like(buf_t[..., : T - half])], dim=-1)
    comp_r = torch.cat([buf_r[..., 0::2], torch.zeros_like(buf_r[..., : T - half])], dim=-1)
    full_e = full.unsqueeze(-1)
    buf_t = torch.where(full_e, comp_t, buf_t)
    buf_r = torch.where(full_e, comp_r, buf_r)
    length = torch.where(full, (length + 1) // 2, length)
    stride = torch.where(full, stride_safe * 2, stride)
    store = rec & (seen % torch.clamp(stride, min=1) == 0) & (length < T)
    at = (cols == length.unsqueeze(-1)) & store.unsqueeze(-1)
    buf_t = torch.where(at, t.unsqueeze(-1), buf_t)
    buf_r = torch.where(at, rate.unsqueeze(-1), buf_r)
    length = length + store.to(length.dtype)
    seen = seen + rec.to(seen.dtype)
    last_t = torch.where(rec, t, last_t)
    last_r = torch.where(rec, rate, last_r)
    return buf_t, buf_r, length, stride, seen, last_t, last_r


def timeline_samples(buf_t, buf_r, length, stride, seen, last_t, last_r):
    """Finalize one scenario's recorded timeline on the host (1-D rows, any
    array-likes): the stored ``(t, rate)`` samples plus the last candidate
    sample when decimation dropped it."""
    n, s, seen = int(length), max(int(stride), 1), int(seen)
    out = [(float(buf_t[j]), float(buf_r[j])) for j in range(n)]
    if seen > 0 and (seen - 1) % s != 0:
        final = (float(last_t), float(last_r))
        if n < len(buf_t):
            out.append(final)
        else:
            out[-1] = final
    return out


def feed_queues(
    enabled, chunk_of, busy, dead, rem, qsizes, qoff, qlen, qptr,
    queue_bytes, fsdt, prepend_sizes=None, prepend_n=None,
):
    """Idle open channels pull the next file of their chunk: resume files
    off the LIFO stack first, then the FIFO queue.

    Ranking a chunk's idle channels in column order, rank ``r`` takes the
    resume file at stack depth ``prepend_n - 1 - r`` while ``r <
    prepend_n`` and the queued file at ``qptr + r - prepend_n`` after.
    ``enabled`` (S,) gates rows; ``prepend_sizes`` (S, K, P) /
    ``prepend_n`` (S, K) may be omitted where no resume file can exist.

    Returns ``(busy, dead, rem, qptr, queue_bytes, prepend_n)``.
    """
    K = qptr.shape[-1]
    dev = chunk_of.device
    if prepend_n is None:
        prepend_n = torch.zeros_like(qptr)
    open_oh = chunk_of.unsqueeze(-1) == torch.arange(K, dtype=torch.int64, device=dev)
    idle = (chunk_of >= 0) & ~busy & enabled.unsqueeze(-1)
    incl = open_oh & idle.unsqueeze(-1)
    # rank of each idle channel within its chunk, in column order
    cum = torch.cumsum(incl.to(torch.int64), dim=-2)
    rank = torch.where(incl, cum, 0).sum(dim=-1) - 1  # -1 when not idle
    ch = torch.clamp(chunk_of, 0, K - 1)
    lookup = TorchOps.table_lookup
    qptr_c = lookup(qptr, ch)
    qlen_c = lookup(qlen, ch)
    qoff_c = lookup(qoff, ch)
    fsdt_c = lookup(fsdt, ch)
    pn_c = lookup(prepend_n, ch)
    if prepend_sizes is not None:
        use_pre = idle & (rank >= 0) & (rank < pn_c)
        P = prepend_sizes.shape[-1]
        ps_flat = prepend_sizes.reshape(prepend_sizes.shape[:-2] + (K * P,))
        pidx = ch * P + torch.clamp(pn_c - 1 - rank, 0, P - 1)
        pre_sz = torch.gather(ps_flat, -1, pidx)
    else:
        use_pre = torch.zeros_like(idle)
        pre_sz = torch.zeros(rank.shape, dtype=torch.float64, device=dev)
    fidx = qptr_c + rank - pn_c
    valid_fifo = idle & (rank >= pn_c) & (fidx < qlen_c)
    if qsizes.shape[0] == 0:  # no files anywhere: the FIFO feeds nothing
        valid_fifo = torch.zeros_like(valid_fifo)
        fifo_sz = torch.zeros(rank.shape, dtype=torch.float64, device=dev)
    else:
        flat = torch.clamp(qoff_c + fidx, 0, qsizes.shape[0] - 1)
        fifo_sz = qsizes[flat]
    valid = use_pre | valid_fifo
    sizes = torch.where(use_pre, pre_sz, torch.where(valid_fifo, fifo_sz, 0.0))
    busy2 = busy | valid
    rem2 = torch.where(valid, sizes, rem)
    dead2 = dead + torch.where(valid, fsdt_c, 0.0)
    # per-chunk counts and sums; sizes are integer-valued doubles, so the
    # summation order is exact
    qptr2 = qptr + (open_oh & valid_fifo.unsqueeze(-1)).sum(dim=-2)
    pn2 = prepend_n - (open_oh & use_pre.unsqueeze(-1)).sum(dim=-2)
    qb2 = queue_bytes - torch.where(
        open_oh & valid.unsqueeze(-1), sizes.unsqueeze(-1), 0.0
    ).sum(dim=-2)
    return busy2, dead2, rem2, qptr2, qb2, pn2
