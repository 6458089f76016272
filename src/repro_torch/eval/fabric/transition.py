"""The transition half of a sweep step on torch tensors, with no host read.

After a step has advanced a row and fed its idle channels, the
transition marks the row's completed chunks, runs the SC / MC / ProMC
completion handlers one chunk at a time (lowest index first, a re-feed
after each), the controller tick (rate EMA, then ProMC's streak check and
channel move with the LIFO resume push) and the done test. Every update
is masked per row. This is the one copy of these semantics in torch: the
driver's host transition (``TorchFabricSimulation._post``) and the plain
version of the loop kernel (``kernels.fused_step.fused_rounds_plain``)
both call :func:`post_transition`, and the loop kernel
(``csrc/fused_step.cu``) mirrors it operation for operation.

State is a mutable mapping of the driver's tensor names (the driver
passes its own ``vars``); functions here replace its entries with new
tensors. Hints (``ks_sc``, ``ks_mc``, ``grant_iters``, ``comp``,
``tick``, ``promc``, ``move``), read from the state before the transition, let a
host caller skip work that would be masked out; they never change a
result.

Two capacity guards find the rows whose transition would need more room
than the axes hold (the reference's two): an SC handler that would open
more channels than the row has free columns (:func:`sc_short`), and a
ProMC tick with a chunk's resume stack at its depth P
(:func:`stack_full`). Their transition is left to a caller that can grow
an axis.

Rows of a custom scheduler (:data:`KIND_CUSTOM`: a Python controller
class) get no built-in handler here. Their completions are marked only
where the class keeps the no-op ``on_chunk_complete`` (``trivial_complete``),
their tick runs the rate EMA, and their callbacks
(:func:`custom_events` finds the rows a step calls) run on the host
through the ``custom`` hooks of :func:`post_transition`.
"""
from __future__ import annotations

import torch

from . import controllers, kernels
from .shim import NO_CHUNK, TorchOps

_EPS = 1e-12

#: controller kinds (the plan's codes): a custom scheduler (a Python
#: controller class, driven through its callbacks on the host), a baseline
#: that acts only at t=0, a static candidate, SC, MC and ProMC
KIND_CUSTOM, KIND_TRIVIAL, KIND_STATIC, KIND_SC, KIND_MC, KIND_PROMC = -1, 0, 1, 2, 3, 4

#: a row's stop code after a loop launch: not run, done, at the step cap,
#: at a capacity guard (its transition left to the host), in error (past
#: ``max_time``, or a stranded chunk), stopped with its fabric group
#: because another member erred or met a guard (the coupled loop), or a
#: custom-scheduler row at an event that calls its callbacks (its
#: transition left to the host, which runs them)
STOP_NONE, STOP_DONE, STOP_CAP, STOP_GUARD, STOP_ERROR, STOP_GROUP, STOP_CUSTOM = (
    0, 1, 2, 3, 4, 5, 6
)

_FEED_OUT = ("busy", "dead", "rem", "qptr", "queue_bytes", "prepend_n")
_CHANNELS = ("chunk_of", "busy", "dead", "rem", "cap")


def feed(s, enabled) -> None:
    """Idle channels of ``enabled`` rows pull their next file (resume stack
    first, then FIFO)."""
    s.update(zip(_FEED_OUT, kernels.feed_queues(
        enabled, s["chunk_of"], s["busy"], s["dead"], s["rem"], s["qsizes"],
        s["qoff"], s["qlen"], s["qptr"], s["queue_bytes"], s["fsdt"],
        s["prepend_sizes"], s["prepend_n"],
    )))


def completions(s, act):
    """``(completed, tick_hit)``: the (S, K) chunks of ``act`` rows with no
    file left and none in flight, and the (S,) rows whose tick is due."""
    K = s["qptr"].shape[-1]
    busy_per_chunk = TorchOps.count_by_chunk(s["chunk_of"], s["busy"], K)
    files_left = s["qlen"] - s["qptr"] + s["prepend_n"]
    completed = (
        act.unsqueeze(-1) & ~s["chunk_done"] & (files_left == 0) & (busy_per_chunk == 0)
    )
    return completed, act & (s["t"] >= s["next_tick"] - _EPS)


def custom_events(s, completed, tick_hit):
    """The (S,) custom-scheduler rows whose callbacks this step's events
    call: a chunk completes and the class has its own
    ``on_chunk_complete``, or the tick is due and it has its own
    ``on_tick``."""
    cust = s["kind"] == KIND_CUSTOM
    return cust & (
        (completed.any(dim=-1) & ~s["trivial_complete"]) | (tick_hit & ~s["trivial_tick"])
    )


def sc_short(s, completed, ks=None):
    """The SC capacity guard (S,): SC rows whose completion handlers, run
    in chunk order, would open more channels than the row has free
    columns at some open. The handlers' per-chunk column counts are
    walked without moving a column. ``ks``: the chunks some SC row
    completed (default all)."""
    K = s["qptr"].shape[-1]
    chunk_of, order, conc = s["chunk_of"], s["sc_order"], s["conc"]
    ks_all = torch.arange(K, dtype=torch.int64, device=chunk_of.device)
    trig_sc = completed & (s["kind"] == KIND_SC).unsqueeze(-1)
    free = (chunk_of == NO_CHUNK).sum(dim=-1)
    held = TorchOps.count_by_chunk(chunk_of, chunk_of != NO_CHUNK, K)
    cursor = s["sc_cursor"]
    short = torch.zeros_like(free, dtype=torch.bool)
    for k in range(K) if ks is None else sorted(ks):
        trig = trig_sc[:, k]
        free = free + torch.where(trig, held[:, k], 0)
        held = torch.where(trig.unsqueeze(-1) & (ks_all == k), 0, held)
        cursor = controllers.sc_advance_cursor(trig, cursor, order, s["nfiles"], s["n_chunks"])
        nxt = torch.gather(order, -1, torch.clamp(cursor, 0, K - 1).unsqueeze(-1))
        n_open = torch.where(
            trig & (cursor < s["n_chunks"]), torch.gather(conc, -1, nxt).squeeze(-1), 0
        )
        short = short | (free < n_open)
        free = free - n_open
        held = held + torch.where(ks_all == nxt, n_open.unsqueeze(-1), 0)
    return short


def stack_full(s, tick_hit):
    """The ProMC capacity guard (S,): ticking ProMC rows with a chunk's
    resume stack at its depth P."""
    P = s["prepend_sizes"].shape[-1]
    return tick_hit & (s["kind"] == KIND_PROMC) & (s["prepend_n"] >= P).any(dim=-1)


def transition_flags(s, completed, tick_hit):
    """What a host caller reads (one int64 vector) to skip masked-out work
    and grow axes: per chunk whether an SC row completed it (K); whether
    any row completed a chunk, any row ticks, any ProMC row ticks, a
    ProMC tick may fire a move (its streak one short of patience or
    closer), and whether the stack guard fires; per chunk the most
    channels an MC or ProMC row that completed it holds (K): what its
    handler frees, since an earlier handler grants nothing to a completed
    chunk, and a handler that frees nothing does nothing; last, whether a
    custom-scheduler row's callbacks run (:func:`custom_read`).
    :func:`hints` turns the read into keyword arguments of
    :func:`post_transition`."""
    kind = s["kind"]
    K = s["qptr"].shape[-1]
    chunk_of = s["chunk_of"]
    is_mc = ((kind == KIND_MC) | (kind == KIND_PROMC)).unsqueeze(-1)
    promc = tick_hit & (kind == KIND_PROMC)
    held = TorchOps.count_by_chunk(chunk_of, chunk_of != NO_CHUNK, K)
    return torch.cat([
        (completed & (kind == KIND_SC).unsqueeze(-1)).any(dim=0).to(torch.int64),
        torch.stack([
            completed.any(), tick_hit.any(), promc.any(),
            (promc & (s["streak"] + 1 >= s["promc_patience"])).any(),
            stack_full(s, tick_hit).any(),
        ]).to(torch.int64),
        torch.where(completed & is_mc, held, 0).amax(dim=0),
        custom_events(s, completed, tick_hit).any().to(torch.int64).unsqueeze(0),
    ])


def hints(flags, K: int) -> dict:
    """:func:`post_transition`'s hints from a host read of
    :func:`transition_flags`."""
    freed = [int(n) for n in flags[K + 5: 2 * K + 5]]
    return {
        "ks_sc": [k for k in range(K) if flags[k]],
        "ks_mc": [k for k in range(K) if freed[k]],
        "comp": bool(flags[K]),
        "tick": bool(flags[K + 1]),
        "promc": bool(flags[K + 2]),
        "move": bool(flags[K + 3]),
        "grant_iters": freed,
    }


def stack_guard_read(flags, K: int) -> bool:
    """Whether :func:`transition_flags`' read says the stack guard fires."""
    return bool(flags[K + 4])


def custom_read(flags, K: int) -> bool:
    """Whether :func:`transition_flags`' read says a custom-scheduler row's
    callbacks run."""
    return bool(flags[2 * K + 5])


def _mark_complete(s, m) -> None:
    s["chunk_done"] = s["chunk_done"] | m
    s["queue_bytes"] = torch.where(m, 0.0, s["queue_bytes"])
    s["completed_at"] = torch.where(m, s["t"].unsqueeze(-1), s["completed_at"])


def views(s):
    """Batched chunk views: (S, K) remaining bytes, open channel counts and
    ETAs for the controller kernels."""
    K = s["qptr"].shape[-1]
    chunk_of = s["chunk_of"]
    open_mask = chunk_of != NO_CHUNK
    n_ch = TorchOps.count_by_chunk(chunk_of, open_mask, K)
    inflight = TorchOps.chunk_scatter_add(
        torch.zeros_like(s["queue_bytes"]), chunk_of, s["rem"], open_mask & s["busy"]
    )
    bytes_rem = s["queue_bytes"] + inflight
    pred = controllers.predicted_chunk_rate(
        s["avg_fs_k"], s["cap_k"], s["fsdt"], n_ch, open_mask.sum(dim=-1),
        s["bw"], s["disk_rate"], s["sat_cc"], s["contention"],
    )
    eta = controllers.chunk_eta(bytes_rem, s["rate_est"], pred, s["chunk_done"])
    return bytes_rem, n_ch, eta


def _sc_handler(s, trig, k: int) -> None:
    """SC's completion handler on ``trig`` rows: close chunk ``k``'s
    channels, advance the cursor past empty size classes, open the next
    class's channels at the lowest free columns."""
    K = s["qptr"].shape[-1]
    s.update(zip(_CHANNELS, controllers.close_chunk(
        trig, k, s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"]
    )))
    cursor = s["sc_cursor"] = controllers.sc_advance_cursor(
        trig, s["sc_cursor"], s["sc_order"], s["nfiles"], s["n_chunks"]
    )
    nxt = torch.gather(
        s["sc_order"], -1, torch.clamp(cursor, 0, K - 1).unsqueeze(-1)
    ).squeeze(-1)
    n_open = torch.where(
        trig & (cursor < s["n_chunks"]),
        torch.gather(s["conc"], -1, nxt.unsqueeze(-1)).squeeze(-1), 0,
    )
    s["chunk_of"], s["dead"], s["cap"] = controllers.open_ranked(
        n_open, nxt, s["chunk_of"], s["dead"], s["cap"], s["setup_cost"], s["cap_k"]
    )


def _mc_handler(s, trig, k: int, grant_iters: int):
    """MC / ProMC's completion handler on ``trig`` rows: re-target chunk
    ``k``'s freed channels to the largest-ETA chunks. Returns the rows
    that acted; with no live receiver a row emits no action at all."""
    K = s["qptr"].shape[-1]
    bytes_rem, n_ch, eta = views(s)
    freed = torch.where(trig, n_ch[:, k], 0)
    ks = torch.arange(K, dtype=torch.int64, device=trig.device)
    live = ~s["chunk_done"] & (ks != k) & (bytes_rem > 0)
    grants, first = controllers.laggard_grants(eta, n_ch, live, freed, grant_iters)
    acted = trig & (grants.sum(dim=-1) > 0)
    (
        s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"], s["n_moves"],
    ) = controllers.apply_grants(
        acted, k, grants, first, s["chunk_of"], s["busy"], s["dead"], s["rem"],
        s["cap"], s["n_moves"], s["par"], s["cap_k"], s["setup_cost"],
    )
    return acted


def _promc_tick(s, rows, move: bool) -> None:
    """ProMC's periodic check on ``rows``: the streak update over the
    post-handler views and, on patience expiry, one fast->slow channel
    move (a busy victim pushes its remainder on the resume stack), then a
    re-feed (skipped where ``move`` says no row can fire)."""
    bytes_rem, n_ch, eta = views(s)
    live = ~s["chunk_done"] & (bytes_rem > 0)
    streak, pf, ps, fire, src, dst = controllers.promc_tick(
        eta, s["rate_est"], n_ch, live, s["streak"], s["pair_fast"],
        s["pair_slow"], s["promc_ratio"], s["promc_patience"],
    )
    s["streak"] = torch.where(rows, streak, s["streak"])
    s["pair_fast"] = torch.where(rows, pf, s["pair_fast"])
    s["pair_slow"] = torch.where(rows, ps, s["pair_slow"])
    if not move:
        return
    moving = rows & fire
    (
        s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"], s["queue_bytes"],
        s["prepend_sizes"], s["prepend_n"], s["n_moves"],
    ) = controllers.move_channel(
        moving, src, dst, s["chunk_of"], s["busy"], s["dead"], s["rem"], s["cap"],
        s["queue_bytes"], s["prepend_sizes"], s["prepend_n"], s["n_moves"],
        s["par"], s["cap_k"], s["setup_cost"],
    )
    feed(s, moving)


def post_transition(
    s, act, completed, tick_hit, *, ks_sc=None, ks_mc=None, grant_iters=None,
    comp: bool = True, tick: bool = True, promc: bool = True, move: bool = True,
    custom=None,
) -> None:
    """The transition of ``act`` rows after a step (``completed`` and
    ``tick_hit`` from :func:`completions` on the same state): completions
    -> handlers -> tick -> done. The rows' capacity guards must not fire
    (callers grow the axes, or leave such rows out of ``act``).
    ``custom``, a pair of callables ``(complete, tick)`` taking no
    argument, runs the custom-scheduler rows' callbacks in the reference's
    order: ``complete`` after the built-in completion handlers, ``tick``
    after the rate EMA and ProMC's tick (they may replace the state's
    tensors); without it no custom row's callback runs."""
    K = s["qptr"].shape[-1]
    kind = s["kind"]
    comp_rows = completed.any(dim=-1)
    if comp:
        # baselines: pure bookkeeping
        _mark_complete(s, completed & s["trivial_complete"].unsqueeze(-1))
        ctrl = completed & (kind >= KIND_SC).unsqueeze(-1)
        _mark_complete(s, ctrl)
        # ProMC drops its streak evidence on any completion
        pr = ctrl.any(dim=-1) & (kind == KIND_PROMC)
        s["streak"] = torch.where(pr, 0, s["streak"])
        s["pair_fast"] = torch.where(pr, -1, s["pair_fast"])
        s["pair_slow"] = torch.where(pr, -1, s["pair_slow"])
    else:
        ks_sc = ks_mc = ()
    is_sc = kind == KIND_SC
    is_mc = (kind == KIND_MC) | (kind == KIND_PROMC)
    ks_sc = range(K) if ks_sc is None else set(ks_sc)
    ks_mc = range(K) if ks_mc is None else set(ks_mc)
    if grant_iters is None:  # a handler frees at most every column
        grant_iters = s["chunk_of"].shape[-1]
    if isinstance(grant_iters, int):
        grant_iters = [grant_iters] * K
    # each completed chunk's handler in index order, a re-feed after each
    for k in range(K):
        if k not in ks_sc and k not in ks_mc:
            continue
        fed = torch.zeros_like(act)
        if k in ks_sc:
            sc_t = ctrl[:, k] & is_sc
            _sc_handler(s, sc_t, k)
            fed = fed | sc_t
        if k in ks_mc and grant_iters[k] > 0:
            fed = fed | _mc_handler(s, ctrl[:, k] & is_mc, k, grant_iters[k])
        feed(s, fed)
    if custom is not None and comp:
        custom[0]()
    if tick:
        rows = tick_hit.unsqueeze(-1)
        ema = kernels.tick_ema(
            s["rate_est"], s["delivered"], s["delivered_at_tick"],
            s["tick_period"].unsqueeze(-1),
        )
        s["rate_est"] = torch.where(rows, ema, s["rate_est"])
        s["delivered_at_tick"] = torch.where(rows, s["delivered"], s["delivered_at_tick"])
        if promc:
            _promc_tick(s, tick_hit & (kind == KIND_PROMC), move)
        if custom is not None:
            custom[1]()
        s["next_tick"] = s["next_tick"] + torch.where(tick_hit, s["tick_period"], 0.0)
    newly = act & s["chunk_done"].all(dim=-1) & (s["fin_any"] | comp_rows)
    s["finish_t"] = torch.where(newly, s["t"], s["finish_t"])
    s["done"] = s["done"] | newly


def stranded(s, act):
    """Rows of ``act`` with no busy channel and a live chunk that holds no
    channel (a scheduler fault)."""
    K = s["qptr"].shape[-1]
    no_busy = act & ~s["busy"].any(dim=-1)
    held = TorchOps.count_by_chunk(s["chunk_of"], s["chunk_of"] != NO_CHUNK, K) > 0
    return no_busy & (~s["chunk_done"] & ~held).any(dim=-1)

