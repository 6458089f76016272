"""Fused sweep steps: the CUDA kernels of ``csrc/fused_step.cu`` and their
plain PyTorch versions.

Port of the Pallas kernel ``_fused_kernel``
(``src/repro/eval/fabric/kernels/fused_step_pallas.py``): per scenario
row, ``disk_pool`` -> bisected water-fill -> ``event_horizon`` ->
``advance_channels`` -> the pure-FIFO branch of ``feed_queues``, and of
the reference's device loop around it (``jax_backend``'s four phases in a
``lax.while_loop``). Two entry points:

* :func:`fused_step`, the Pallas kernel's counterpart: one step of every
  active row a launch, for sweeps with no resume file in the batch.
  Operands, in order: ``act`` (S,) bool; ``busy`` (S, C) bool; ``dead``,
  ``rem``, ``cap`` (S, C) float64; ``chunk_of`` (S, C) int64; ``tick_dt``,
  ``bw``, ``disk_rate`` (S,) float64; ``sat_cc`` (S,) int64;
  ``contention`` (S,) float64; ``qoff``, ``qlen``, ``qptr`` (S, K) int64;
  ``queue_bytes``, ``fsdt`` (S, K) float64; ``qsizes`` (Q,) float64.
  Returns ``(dt, rate_sum, fin_any, busy, dead, rem, moved, qptr,
  queue_bytes)``; inactive rows pass through with ``dt = 0``.
* :func:`fused_rounds`, the whole device loop for the card: each active
  row takes steps until it is done, errs, meets a capacity guard or has
  taken ``max_steps`` (:data:`ROUND_CAP`, the reference's), updating the
  driver's state tensors in place and writing each row's steps and stop
  code (``transition.STOP_*``). A step is :func:`fused_step`'s with the
  profile lookup, the resume-stack feed, the timeline push, the clock,
  the event count and the ``delivered`` scatter, then the transition of
  :func:`..transition.post_transition` (completions, handlers in chunk
  order with a re-feed after each, the tick with ProMC's move, the done
  test). A row at a guard stops before that transition, which the host
  takes; so does a custom-scheduler row at an event that calls its
  callbacks (``transition.STOP_CUSTOM``: a chunk completes and its class
  has its own ``on_chunk_complete``, or the tick is due and it has its own
  ``on_tick``).
* :func:`fused_rounds_coupled`, the same loop for batches with shared
  fabrics (the reference's ``_device_rounds_coupled_fn``): one block a
  fabric group, whose rows take their link grants
  (:func:`.waterfill_coupled`, solved in the block) as pools and step in
  lockstep on the group's earliest event.

:func:`fused_rounds_probe` and :func:`fused_rounds_coupled_probe` are the
loop kernels' probe builds (the card only): the same launches, and SM
cycles by phase of a step or of a group step.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch import _cuda_build as _build
from .. import transition
from ..shim import TorchOps
from . import (
    advance_channels, bandwidth_now, coupled_pool, disk_pool, event_horizon, feed_queues,
    lockstep_dt, timeline_push,
)
from .waterfill_bisect import bisect_level, lane_sum

_EPS = 1e-12

#: the kernels' CUDA source
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_step.cu"

#: steps a row may take in one :func:`fused_rounds` launch (the
#: reference's ``_ROUND_CAP``)
ROUND_CAP = 2048

#: :func:`fused_rounds`' operands by name: (dtype, axes) in the kernel's
#: pointer order. The first group is read, the second updated in place,
#: the third written. Axes: S rows, C channels, K chunks, B profile steps,
#: Q file sizes, P resume-stack depth, T timeline samples.
ROUND_INPUTS = {
    "act": (torch.bool, "S"), "tick_period": (torch.float64, "S"),
    "max_time": (torch.float64, "S"), "record_timeline": (torch.bool, "S"),
    "kind": (torch.int64, "S"), "trivial_tick": (torch.bool, "S"),
    "trivial_complete": (torch.bool, "S"),
    "n_chunks": (torch.int64, "S"), "bw": (torch.float64, "S"),
    "disk_rate": (torch.float64, "S"), "sat_cc": (torch.int64, "S"),
    "contention": (torch.float64, "S"), "setup_cost": (torch.float64, "S"),
    "promc_ratio": (torch.float64, "S"), "promc_patience": (torch.int64, "S"),
    "prof_t": (torch.float64, "SB"), "prof_mult": (torch.float64, "SB"),
    "qoff": (torch.int64, "SK"), "qlen": (torch.int64, "SK"),
    "fsdt": (torch.float64, "SK"), "nfiles": (torch.int64, "SK"),
    "sc_order": (torch.int64, "SK"), "conc": (torch.int64, "SK"),
    "par": (torch.int64, "SK"), "cap_k": (torch.float64, "SK"),
    "avg_fs_k": (torch.float64, "SK"), "qsizes": (torch.float64, "Q"),
}
ROUND_STATE = {
    "t": (torch.float64, "S"), "n_events": (torch.int64, "S"),
    "fin_any": (torch.bool, "S"), "next_tick": (torch.float64, "S"),
    "done": (torch.bool, "S"), "finish_t": (torch.float64, "S"),
    "sc_cursor": (torch.int64, "S"), "streak": (torch.int64, "S"),
    "pair_fast": (torch.int64, "S"), "pair_slow": (torch.int64, "S"),
    "n_moves": (torch.int64, "S"), "busy": (torch.bool, "SC"),
    "dead": (torch.float64, "SC"), "rem": (torch.float64, "SC"),
    "cap": (torch.float64, "SC"), "chunk_of": (torch.int64, "SC"),
    "qptr": (torch.int64, "SK"), "queue_bytes": (torch.float64, "SK"),
    "prepend_n": (torch.int64, "SK"), "chunk_done": (torch.bool, "SK"),
    "completed_at": (torch.float64, "SK"), "delivered": (torch.float64, "SK"),
    "delivered_at_tick": (torch.float64, "SK"), "rate_est": (torch.float64, "SK"),
    "prepend_sizes": (torch.float64, "SKP"), "tl_t": (torch.float64, "ST"),
    "tl_rate": (torch.float64, "ST"), "tl_len": (torch.int64, "S"),
    "tl_stride": (torch.int64, "S"), "tl_seen": (torch.int64, "S"),
    "tl_last_t": (torch.float64, "S"), "tl_last_rate": (torch.float64, "S"),
}
#: per row: the steps taken, the stop code (``transition.STOP_*``) and the
#: water levels reused (steps whose level inputs were the row's last step's
#: in the same launch, :func:`_level_reuse`)
ROUND_OUTPUTS = {"steps": (torch.int64, "S"), "stop": (torch.int64, "S"),
                 "reuses": (torch.int64, "S")}
ROUND_OPERANDS = {**ROUND_INPUTS, **ROUND_STATE, **ROUND_OUTPUTS}

#: the timeline ring's tensors, in ``kernels.timeline_push``'s order
_TIMELINE = (
    "tl_t", "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate",
)

#: argument types of the kernels' C entry points
_ARGTYPES = {
    "fused_step_f64": [ctypes.c_void_p] * 26 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p],
    "fused_rounds_f64": [ctypes.c_void_p] + [ctypes.c_longlong] * 8
    + [ctypes.c_void_p],
    "fused_rounds_coupled_f64": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 10
    + [ctypes.c_void_p],
    "fused_rounds_probe_f64": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 8
    + [ctypes.c_void_p],
    "fused_rounds_coupled_probe_f64": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 10
    + [ctypes.c_void_p],
}

#: the phases of a loop step that :func:`fused_rounds_probe` times, in the
#: order a step runs them (the kernel's ``enum Phase``)
PROBE_PHASES = (
    "error", "profile", "load", "level", "horizon", "advance", "feed", "after_step",
    "transition",
)

#: the phases of a coupled group step that :func:`fused_rounds_coupled_probe`
#: times, in the order a member warp runs them (the kernel's ``enum
#: CoupledPhase``): ``wait1`` and ``wait2`` are the waits at the block's
#: barriers A and B, ``flags`` the reads of the members' flags and horizons
#: after them, ``solve`` the test for the last solve's grants and the grant,
#: ``exchange`` .. ``test`` the sweeps of a solve (the levels' exchange and
#: the caps' shuffles, the sort, the prefix and candidates, the ballot and
#: the fixed-point test)
COUPLED_PROBE_PHASES = (
    "error", "profile", "demand", "wait1", "flags", "solve", "exchange", "sort", "prefix",
    "test", "level", "horizon", "wait2", "advance", "feed", "after_step", "transition",
)

#: water levels a row keeps in the coupled loop kernel (its level memory:
#: the last distinct inputs of its steps); the uncoupled loop kernels keep
#: the last step's
COUPLED_LEVEL_SLOTS = 8

#: the coupled loop kernel's limits: rows a fabric group (a block's warps),
#: links a group (a lane of the group's solve per link and sorted position)
#: and channel columns a row (one tile)
COUPLED_MAX_ROWS = 8
COUPLED_MAX_LINKS = 4
COUPLED_MAX_C = 32


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A C entry point of the kernels' library, built and loaded at first
    use."""
    fn = getattr(_build.load(SOURCE), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _bits(x):
    """The float64 ``x``'s bit patterns, as int64."""
    return x.contiguous().view(torch.int64)


def _level_reuse(cache, act, caps, pool, slots=1):
    """The loop kernels' water-level cache on the ``act`` rows' step with
    transferring caps ``caps`` (S, C) and rate pool ``pool`` (S,): a row
    whose caps and ``pool_eff = max(min(pool, sum(caps)), 0)`` are bit for
    bit those of one of the inputs it keeps reuses that input's level (the
    level is a function of the caps, their largest, which they give, and
    ``pool_eff``). A row keeps the last ``slots`` distinct inputs of its
    steps in this launch, the least recently used one (an empty one first,
    the lowest slot of equals) giving way to a new input: 1, the last
    step's, in the uncoupled loop kernels' row cache;
    :data:`COUPLED_LEVEL_SLOTS` in the coupled loop kernel's level memory.
    Adds the reuses into ``cache["reuses"]`` and keeps this step's input.
    ``cache``: a dict the plain loops start empty at each launch."""
    pool_eff = _bits(torch.clamp(torch.minimum(pool, lane_sum(caps)), min=0.0))
    caps = _bits(caps)
    if "caps" not in cache:
        cache.update(caps=caps.unsqueeze(1).repeat(1, slots, 1),
                     pool_eff=pool_eff.unsqueeze(1).repeat(1, slots),
                     stamp=torch.zeros_like(pool_eff).unsqueeze(1).repeat(1, slots), tick=0,
                     reuses=torch.zeros_like(pool_eff))
    cache["tick"] += 1
    stamp = cache["stamp"]
    match = ((stamp > 0) & (cache["caps"] == caps.unsqueeze(1)).all(dim=-1)
             & (cache["pool_eff"] == pool_eff.unsqueeze(1)))
    hit = act & match.any(dim=-1)
    cache["reuses"] = cache["reuses"] + hit.to(torch.int64)
    slot = torch.where(hit, match.to(torch.int64).argmax(dim=-1), stamp.argmin(dim=-1))
    rows = torch.nonzero(act).squeeze(-1)
    stamp[rows, slot[rows]] = cache["tick"]
    miss = torch.nonzero(act & ~hit).squeeze(-1)
    cache["caps"][miss, slot[miss]] = caps[miss]
    cache["pool_eff"][miss, slot[miss]] = pool_eff[miss]


def _solve_reuse(cache, fab, act, demand):
    """The coupled loop kernel's solve cache on a group step of the ``act``
    rows with demands ``demand`` (S,) (0 off the ``act`` rows): a fabric
    group with links that steps, and whose members' demands are bit for bit
    those of its last step in this launch, takes that step's link grants
    without solving (the solve is a function of the demands alone: a member
    that does not step offers 0). Adds these steps into
    ``cache["solve_reuses"]`` (n_groups,) int64 and keeps this step's
    demands of the groups that step. ``cache``: the launch's dict, as
    :func:`_level_reuse`'s."""
    n = fab["n_groups"]
    gid = fab["group_id"]
    grouped = gid >= 0
    gi = gid[grouped]

    def per_group(x, how):
        init = 1 if how == "amin" else 0
        return torch.full((n,), init, dtype=torch.int64, device=gid.device).scatter_reduce(
            0, gi, x[grouped].to(torch.int64), how) > 0

    steps = per_group(act, "amax") & per_group(fab["member"].any(dim=0), "amax")
    bits = _bits(demand)
    if "dem" in cache:
        same = per_group(bits == cache["dem"], "amin")
        cache["solve_reuses"] = cache["solve_reuses"] + (steps & cache["solved"] & same).to(
            torch.int64)
        cache["dem"] = torch.where(grouped & steps[gid.clamp(min=0)], bits, cache["dem"])
        cache["solved"] = cache["solved"] | steps
    else:
        cache.update(dem=bits, solved=steps, solve_reuses=torch.zeros(
            n, dtype=torch.int64, device=gid.device))


def _advance_plain(
    act, busy, dead, rem, cap, tick_dt, bw, disk_rate, sat_cc, contention, fab=None,
    cache=None,
):
    """The physics half of a step, composed of the fluid kernels: rates,
    horizon, fluid movement. With ``fab`` (the coupled loop's fabric, see
    :func:`fused_rounds_coupled_plain`) the rows of a group take their
    link grants as pools and advance in lockstep. With ``cache`` the step
    counts the water levels the loop kernels reuse (:func:`_level_reuse`)
    and, coupled, the group solves the coupled kernel reuses
    (:func:`_solve_reuse`). Returns ``(dt, rate_sum, fin_any, busy, dead,
    rem, moved)``."""
    transferring = busy & (dead <= _EPS)
    pool = disk_pool(transferring.sum(dim=-1), bw, disk_rate, sat_cc, contention)
    caps = torch.where(transferring, cap, 0.0)
    if fab is not None:
        total = lane_sum(caps)
        if cache is not None and fab["n_groups"]:
            _solve_reuse(cache, fab, act, torch.where(
                act & (fab["group_id"] >= 0), torch.minimum(pool, total), 0.0))
        pool, _ = coupled_pool(pool, total, act, fab)
    if cache is not None:
        _level_reuse(cache, act, caps, pool, 1 if fab is None else COUPLED_LEVEL_SLOTS)
    level = bisect_level(caps, pool)
    rates = torch.where(
        act.unsqueeze(-1), torch.minimum(caps, level.unsqueeze(-1)), 0.0
    )
    dt = event_horizon(tick_dt, busy, dead, transferring, rem, rates)
    dt = torch.where(act, dt, 0.0)
    if fab is not None:
        dt = lockstep_dt(dt, act, fab["group_id"], fab["n_groups"])
    busy2, dead2, rem2, moved, finished = advance_channels(
        act, dt, busy, dead, transferring, rem, rates
    )
    return dt, lane_sum(rates), finished.any(dim=-1), busy2, dead2, rem2, moved


def fused_step_plain(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """Plain PyTorch version of the one-step kernel, composed of the fluid
    kernels."""
    dt, rate_sum, fin, busy2, dead2, rem2, moved = _advance_plain(
        act, busy, dead, rem, cap, tick_dt, bw, disk_rate, sat_cc, contention
    )
    busy3, dead3, rem3, qptr2, qb2, _ = feed_queues(
        act, chunk_of, busy2, dead2, rem2, qsizes, qoff, qlen, qptr,
        queue_bytes, fsdt,
    )
    return dt, rate_sum, fin, busy3, dead3, rem3, moved, qptr2, qb2


def fused_step(
    act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
    contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
):
    """One fused sweep step. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (C and K up to
    1024; no launch for zero rows)."""
    args = (
        act, busy, dead, rem, cap, chunk_of, tick_dt, bw, disk_rate, sat_cc,
        contention, qoff, qlen, qptr, queue_bytes, fsdt, qsizes,
    )
    if busy.dim() != 2 or qptr.dim() != 2:
        raise ValueError("busy must be (S, C) and qptr (S, K)")
    if busy.device.type == "cpu":
        return fused_step_plain(*args)
    if busy.device.type != "cuda":
        raise ValueError(f"unsupported device {busy.device}")
    S, C = busy.shape
    K = qptr.shape[1]
    Q = qsizes.shape[0]
    if C > 1024 or K > 1024 or Q == 0:
        raise ValueError(f"the fused-step kernel takes C, K <= 1024 and Q > 0, got {C}, {K}, {Q}")
    dev = busy.device
    b, f8, i8 = torch.bool, torch.float64, torch.int64
    specs = (
        ("act", b, (S,)), ("busy", b, (S, C)), ("dead", f8, (S, C)),
        ("rem", f8, (S, C)), ("cap", f8, (S, C)), ("chunk_of", i8, (S, C)),
        ("tick_dt", f8, (S,)), ("bw", f8, (S,)), ("disk_rate", f8, (S,)),
        ("sat_cc", i8, (S,)), ("contention", f8, (S,)),
        ("qoff", i8, (S, K)), ("qlen", i8, (S, K)), ("qptr", i8, (S, K)),
        ("queue_bytes", f8, (S, K)), ("fsdt", f8, (S, K)),
        ("qsizes", f8, (Q,)),
    )
    ptrs = [
        _build.check(t, name, dtype, shape, dev)
        for t, (name, dtype, shape) in zip(args, specs)
    ]
    outs = (
        torch.empty((S,), dtype=f8, device=dev),
        torch.empty((S,), dtype=f8, device=dev),
        torch.empty((S,), dtype=b, device=dev),
        torch.empty((S, C), dtype=b, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, C), dtype=f8, device=dev),
        torch.empty((S, K), dtype=i8, device=dev),
        torch.empty((S, K), dtype=f8, device=dev),
    )
    if S == 0:
        return outs
    fn = _entry("fused_step_f64")
    with torch.cuda.device(dev):
        err = fn(
            *ptrs, *(o.data_ptr() for o in outs), S, C, K, Q,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused-step kernel launch failed: cudaError {err}")
    fused_step.launches += 1
    return outs


#: launches of the one-step CUDA kernel in this process
fused_step.launches = 0


def _plain_step(st, run, fab=None, cache=None):
    """One step of the ``run`` rows of the loop operands ``st`` (entries
    replaced): the profile lookup, the physics of :func:`fused_step_plain`
    (coupled through ``fab`` when given), the feed with the resume stack,
    the timeline push, the clock, the event count, the ``delivered``
    scatter, then :func:`..transition.post_transition` on the rows that
    meet no capacity guard and call no custom callback (uncoupled loop
    only: the coupled loop never holds a custom row); ``cache``: the
    launch's water-level cache (:func:`_level_reuse`). Returns ``(guard,
    custom)``, the rows at a guard and the custom rows at a callback
    event, whose transition is left to the host."""
    K = st["qptr"].shape[-1]
    t = st["t"]
    eff_bw, next_prof = bandwidth_now(st["bw"], st["prof_t"], st["prof_mult"], t)
    dt, rate_sum, fin, st["busy"], st["dead"], st["rem"], moved = _advance_plain(
        run, st["busy"], st["dead"], st["rem"], st["cap"],
        torch.minimum(st["next_tick"] - t, next_prof - t), eff_bw,
        st["disk_rate"], st["sat_cc"], st["contention"], fab, cache,
    )
    transition.feed(st, run)
    st.update(zip(_TIMELINE, timeline_push(
        run & st["record_timeline"], t, rate_sum, *(st[k] for k in _TIMELINE)
    )))
    st["t"] = t + dt  # dt is 0 on rows that do not run
    st["n_events"] = st["n_events"] + run.to(torch.int64)
    st["fin_any"] = torch.where(run, fin, st["fin_any"])
    st["delivered"] = TorchOps.chunk_scatter_add(
        st["delivered"], st["chunk_of"], moved, moved != 0.0
    )
    # a row at a capacity guard leaves the step's transition to the host
    completed, tick_hit = transition.completions(st, run)
    flags = transition.transition_flags(st, completed, tick_hit).tolist()
    hint = transition.hints(flags, K)
    guard = transition.stack_full(st, tick_hit)
    if hint["ks_sc"]:
        guard = guard | transition.sc_short(st, completed, hint["ks_sc"])
    custom = torch.zeros_like(guard)
    if fab is None and transition.custom_read(flags, K):
        custom = run & ~guard & transition.custom_events(st, completed, tick_hit)
    go = run & ~guard & ~custom
    transition.post_transition(
        st, go, completed & go.unsqueeze(-1), tick_hit & go, **hint
    )
    return guard, custom


def _stop_errors(st, run, stop):
    """The error test of the ``run`` rows (``t > max_time``, a stranded
    chunk): returns ``(err, stop)`` with the erring rows' stop code set."""
    err = run & ((st["t"] > st["max_time"]) | transition.stranded(st, run))
    return err, torch.where(err, transition.STOP_ERROR, stop)


def fused_rounds_plain(s, max_steps: int = ROUND_CAP):
    """Plain PyTorch version of the loop kernel on the operands ``s`` (a
    mapping of :data:`ROUND_OPERANDS` names to tensors; the outputs may be
    absent), the kernel's yardstick. Each iteration, on the rows still
    running: the error test (``t > max_time``, a stranded chunk), then a
    step (:func:`_plain_step`), masked per row. A row stops done, in error,
    at a guard or a custom callback event (the step's transition not
    taken) or at ``max_steps``. Host
    reads only skip masked-out work. Returns new tensors for every name of
    :data:`ROUND_STATE` and :data:`ROUND_OUTPUTS` (``reuses``: the steps
    whose water level the kernel reuses, :func:`_level_reuse`); ``s`` is
    left as it was."""
    st = dict(s)  # entries are replaced, never written
    steps = torch.zeros_like(st["n_events"])
    stop = torch.full_like(steps, transition.STOP_NONE)
    run = st["act"]
    cache = {}
    while True:
        err, stop = _stop_errors(st, run, stop)
        run = run & ~err
        if not bool(run.any()):
            break
        guard, custom = _plain_step(st, run, cache=cache)
        steps = steps + run.to(torch.int64)
        stop = torch.where(guard, transition.STOP_GUARD, stop)
        stop = torch.where(custom, transition.STOP_CUSTOM, stop)
        go = run & ~guard & ~custom
        capped = go & ~st["done"] & (steps >= max_steps)
        stop = torch.where(go & st["done"], transition.STOP_DONE, stop)
        stop = torch.where(capped, transition.STOP_CAP, stop)
        run = go & ~st["done"] & ~capped
    return _round_outputs(st, steps, stop, cache)


def _round_outputs(st, steps, stop, cache):
    """A plain loop's results: the state of :data:`ROUND_STATE` and the
    outputs of :data:`ROUND_OUTPUTS`."""
    out = {name: st[name] for name in ROUND_STATE}
    out.update(steps=steps, stop=stop, reuses=cache.get("reuses", torch.zeros_like(steps)))
    return out


def fabric_operands(group_id, member, link_cap, device=None, names=None) -> dict:
    """The coupled loop's fabric (a mapping the wrapper and the plain
    version take) from a batch's resolved fabric column: ``group_id`` (S,)
    int64 (-1 outside every group), ``member`` (L, S) bool and
    ``link_cap`` (L,) float64, as tensors on ``device`` (the rows');
    ``n_groups``; ``width``, the most rows a link has; and ``layout``, the kernel's per-group
    layout (:func:`fabric_layout`, on ``device``), or the ``ValueError``
    that names a group beyond the kernel's limits (``names``: the rows'
    scenario names), which the wrapper raises before a launch."""
    gid = np.asarray(group_id, dtype=np.int64)
    member = np.asarray(member, dtype=bool)
    link_cap = np.asarray(link_cap, dtype=np.float64)
    try:
        layout = {k: torch.as_tensor(v, device=device)
                  for k, v in fabric_layout(gid, member, link_cap, names).items()}
    except ValueError as exc:
        layout = exc
    return {
        "group_id": torch.as_tensor(gid, device=device),
        "member": torch.as_tensor(member, device=device),
        "link_cap": torch.as_tensor(link_cap, device=device),
        "n_groups": int(gid.max()) + 1 if gid.size and gid.max() >= 0 else 0,
        "width": int(member.sum(axis=1).max(initial=0)),
        "layout": layout,
    }


def fabric_layout(group_id, member, link_cap, names=None) -> dict:
    """The coupled loop kernel's per-block layout of a batch's fabric
    (numpy, on the host): one block a fabric group, in group order, then
    one a row outside every group. ``rows`` (G, R) int64: the block's rows
    in row order, -1 past them (R the widest block); ``mask`` (G, 4) int64:
    bit j set where the block's j-th row rides the link; ``cap`` (G, 4)
    float64: the links' capacities (unused slots 0 with an empty mask).
    Raises ``ValueError``, naming the group (``names``, a row's scenario
    name, when given), for a group wider than :data:`COUPLED_MAX_ROWS`
    rows or with more than :data:`COUPLED_MAX_LINKS` links."""
    gid = np.asarray(group_id, dtype=np.int64)
    member = np.asarray(member, dtype=bool)
    link_cap = np.asarray(link_cap, dtype=np.float64)
    n_groups = int(gid.max()) + 1 if gid.size and gid.max() >= 0 else 0
    blocks = [np.flatnonzero(gid == g) for g in range(n_groups)]
    blocks += [np.array([r]) for r in np.flatnonzero(gid < 0)]
    links = [np.flatnonzero(member[:, b].any(axis=1)) for b in blocks[:n_groups]]

    def label(g):
        r = int(blocks[g][0])
        return f"group {g} (row {r}" + (f", {names[r]!r})" if names is not None else ")")

    for g in range(n_groups):
        if len(blocks[g]) > COUPLED_MAX_ROWS:
            raise ValueError(
                f"fabric {label(g)} has {len(blocks[g])} rows; the coupled loop kernel "
                f"takes at most {COUPLED_MAX_ROWS} a group"
            )
        if len(links[g]) > COUPLED_MAX_LINKS:
            raise ValueError(
                f"fabric {label(g)} has {len(links[g])} links; the coupled loop kernel "
                f"takes at most {COUPLED_MAX_LINKS} a group"
            )
    G = len(blocks)
    R = max((len(b) for b in blocks), default=1)
    rows = np.full((G, R), -1, dtype=np.int64)
    mask = np.zeros((G, COUPLED_MAX_LINKS), dtype=np.int64)
    cap = np.zeros((G, COUPLED_MAX_LINKS), dtype=np.float64)
    for g, b in enumerate(blocks):
        rows[g, : len(b)] = b
        if g < n_groups:
            for j, li in enumerate(links[g]):
                mask[g, j] = int(sum(1 << i for i, r in enumerate(b) if member[li, r]))
                cap[g, j] = link_cap[li]
    return {"rows": rows, "mask": mask, "cap": cap}


def fused_rounds_coupled_plain(s, fab, max_steps: int = ROUND_CAP, counts=None):
    """Plain PyTorch version of the coupled loop kernel, on the loop
    operands ``s`` and the fabric ``fab`` (:func:`fabric_operands`). A
    fabric group steps in lockstep: each step its live rows offer their
    demand, :func:`.coupled_pool` turns the demands into link grants (one
    :func:`.waterfill_coupled` over the whole (L, S) table), and each live
    row advances by its group's least horizon (:func:`.lockstep_dt`); a
    row outside every group steps as in :func:`fused_rounds_plain` (its
    ``reuses`` counted with the coupled kernel's level memory). Stops
    are per group: a finished row offers zero demand until the group is
    done; a group stops when it has taken ``max_steps`` steps; an erring
    row stops its group before the step (the others with
    ``transition.STOP_GROUP``); a row at a capacity guard stops its group
    after the step, the others' transitions taken. Returns what
    :func:`fused_rounds_plain` returns; ``s`` is left as it was. With a dict
    ``counts``, ``counts["solve_reuses"]`` receives the group steps whose
    solve the kernel takes again (:func:`_solve_reuse`), (G,) int64 in
    :func:`fabric_layout`'s block order (0 for a row outside every group)."""
    st = dict(s)
    gid = fab["group_id"]
    n_groups = fab["n_groups"]
    solo = gid < 0
    # loop blocks: the fabric groups, then each row outside them alone
    block = torch.where(solo, n_groups + torch.cumsum(solo.to(torch.int64), 0) - 1, gid)
    n_blocks = n_groups + int(solo.sum())

    def per_block(mask):
        return torch.zeros(n_blocks, dtype=torch.int64, device=gid.device).scatter_reduce(
            0, block, mask.to(torch.int64), "amax"
        )

    def in_block(mask):
        return per_block(mask)[block] > 0

    gsteps = torch.zeros(n_blocks, dtype=torch.int64, device=gid.device)
    steps = torch.zeros_like(st["n_events"])
    stop = torch.full_like(steps, transition.STOP_NONE)
    run = st["act"]
    cache = {}
    while True:
        capped = run & (gsteps[block] >= max_steps)
        stop = torch.where(capped, transition.STOP_CAP, stop)
        run = run & ~capped
        err, stop = _stop_errors(st, run, stop)
        halt = run & in_block(err)
        stop = torch.where(halt & ~err, transition.STOP_GROUP, stop)
        run = run & ~halt
        if not bool(run.any()):
            break
        guard, _ = _plain_step(st, run, fab, cache)
        steps = steps + run.to(torch.int64)
        gsteps = gsteps + per_block(run)
        held = in_block(guard)
        done = st["done"]
        stop = torch.where(guard, transition.STOP_GUARD, stop)
        stop = torch.where(run & ~guard & done, transition.STOP_DONE, stop)
        stop = torch.where(run & held & ~guard & ~done, transition.STOP_GROUP, stop)
        run = run & ~done & ~held
    if counts is not None:
        reused = torch.zeros(n_blocks, dtype=torch.int64, device=gid.device)
        if "solve_reuses" in cache:
            reused[:n_groups] = cache["solve_reuses"]
        counts["solve_reuses"] = reused
    return _round_outputs(st, steps, stop, cache)


def fused_rounds(s, max_steps: int = ROUND_CAP):
    """Every active row of ``s`` (a mapping of :data:`ROUND_OPERANDS` names
    to tensors) takes steps until it is done, errs, meets a capacity guard
    or a custom callback event, or has taken ``max_steps``; the state and
    output tensors are updated
    in place. Returns ``s["steps"]``. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (C and K up to
    1024; no launch for zero rows). Afterwards ``fused_rounds.reuses`` is
    ``s["reuses"]``, each row's steps that reused its last step's water
    level in this call."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be at least 1, got {max_steps}")
    busy = s["busy"]
    if busy.dim() != 2 or s["qptr"].dim() != 2 or s["prof_t"].dim() != 2:
        raise ValueError("busy must be (S, C), qptr (S, K) and prof_t (S, B)")
    if busy.device.type == "cpu":
        for name, new in fused_rounds_plain(s, max_steps).items():
            s[name].copy_(new)
    elif busy.device.type != "cuda":
        raise ValueError(f"unsupported device {busy.device}")
    else:
        dims, ptrs = _round_pointers(s, 1024)
        if dims["S"]:
            _launch_rounds("fused_rounds_f64", ptrs, dims, max_steps, busy.device)
            fused_rounds.launches += 1
    fused_rounds.reuses = s["reuses"]
    return s["steps"]


#: launches of the loop kernel in this process
fused_rounds.launches = 0
#: the last call's water-level reuses a row, (S,) int64
fused_rounds.reuses = None


def _round_pointers(s, max_c):
    """The loop operands' axes and the kernel's pointer array, each operand
    checked on ``s["busy"]``'s device (C up to ``max_c``, K up to 1024)."""
    busy = s["busy"]
    dims = {"S": busy.shape[0], "C": busy.shape[1], "K": s["qptr"].shape[1],
            "B": s["prof_t"].shape[1], "Q": s["qsizes"].shape[0],
            "P": s["prepend_sizes"].shape[-1], "T": s["tl_t"].shape[-1]}
    if dims["C"] > max_c or dims["K"] > 1024 or dims["Q"] == 0:
        raise ValueError(
            f"the fused-rounds kernel takes C <= {max_c}, K <= 1024 and Q > 0, got "
            f"{dims['C']}, {dims['K']}, {dims['Q']}"
        )
    ptrs = (ctypes.c_void_p * len(ROUND_OPERANDS))(*(
        _build.check(s[name], name, dtype, tuple(dims[a] for a in axes), busy.device)
        for name, (dtype, axes) in ROUND_OPERANDS.items()
    ))
    return dims, ptrs


def _launch_rounds(entry, ptrs, dims, max_steps, dev, *extra):
    """Launch the loop entry point ``entry`` (``extra``: pointers after the
    operand array) on ``dev``'s current stream; raises on a launch error."""
    with torch.cuda.device(dev):
        err = _entry(entry)(
            ptrs, *extra, dims["S"], dims["C"], dims["K"], dims["B"], dims["Q"], dims["P"],
            dims["T"], max_steps, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def fused_rounds_probe(s, max_steps: int = ROUND_CAP):
    """The probe build of the loop kernel on the CUDA operands ``s``: the
    launch of :func:`fused_rounds` (``s`` updated in place, bit for bit
    the same), and each row's SM cycles by phase of its steps
    (:data:`PROBE_PHASES`), summed over the launch, as a new (S, phases)
    int64 tensor (0 on inactive rows). The cycles are read from
    ``clock64()`` at the phase boundaries by each row's warp. Rows of
    C <= 32 columns; the probe has no plain version and raises for CPU
    tensors. Not on any path of the sweep: ``chip_smoke.py`` calls it to
    split the step."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be at least 1, got {max_steps}")
    busy = s["busy"]
    if busy.device.type != "cuda":
        raise ValueError(f"the loop kernel's probe runs on the card only, not on {busy.device}")
    dims, ptrs = _round_pointers(s, 32)
    cycles = torch.zeros((dims["S"], len(PROBE_PHASES)), dtype=torch.int64, device=busy.device)
    if dims["S"]:
        _launch_rounds("fused_rounds_probe_f64", ptrs, dims, max_steps, busy.device,
                       cycles.data_ptr())
        fused_rounds_probe.launches += 1
    return cycles


#: launches of the loop kernel's probe build in this process
fused_rounds_probe.launches = 0


def fused_rounds_coupled(s, fab, max_steps: int = ROUND_CAP):
    """:func:`fused_rounds` for a batch with shared fabrics: every active
    row of ``s`` steps, each fabric group of ``fab``
    (:func:`fabric_operands`) in lockstep, until its group is done, a
    member errs or meets a capacity guard, or the group has taken
    ``max_steps`` steps (:func:`fused_rounds_coupled_plain` says how);
    the state and output tensors are updated in place. Returns
    ``s["steps"]``. CPU tensors take the plain version; CUDA tensors
    launch the coupled loop kernel on the current stream, one block a
    group and one warp a row: rows of at most :data:`COUPLED_MAX_C`
    columns, groups of at most :data:`COUPLED_MAX_ROWS` rows and
    :data:`COUPLED_MAX_LINKS` links (a ``ValueError`` before any launch
    otherwise, from ``fab["layout"]``). After a launch, in
    :func:`fabric_layout`'s block order (0 for a block without links):
    ``fused_rounds_coupled.sweeps`` (G,) int64 holds the Jacobi sweeps each
    block ran, over the group steps that solved; ``fused_rounds_coupled
    .solve_reuses`` (G,) int64 the group steps that took the last solve's
    grants instead, every member's demand bit for bit the last solve's (the
    plain version's count, ``counts`` of :func:`fused_rounds_coupled_plain`,
    which a CPU call sets too). After a call, ``fused_rounds_coupled.reuses``
    is ``s["reuses"]`` (as :func:`fused_rounds`'; a row reuses the level of
    any of its last :data:`COUPLED_LEVEL_SLOTS` distinct inputs, its level
    memory, :func:`_level_reuse`)."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be at least 1, got {max_steps}")
    busy = s["busy"]
    if busy.dim() != 2 or s["qptr"].dim() != 2 or s["prof_t"].dim() != 2:
        raise ValueError("busy must be (S, C), qptr (S, K) and prof_t (S, B)")
    S, C = busy.shape
    if fab["group_id"].shape != (S,) or fab["member"].shape[1:] != (S,):
        raise ValueError(
            f"the fabric's group_id must be ({S},) and member (L, {S}), got "
            f"{tuple(fab['group_id'].shape)} and {tuple(fab['member'].shape)}"
        )
    if busy.device.type == "cpu":
        counts = {}
        for name, new in fused_rounds_coupled_plain(s, fab, max_steps, counts=counts).items():
            s[name].copy_(new)
        fused_rounds_coupled.reuses = s["reuses"]
        fused_rounds_coupled.solve_reuses = counts["solve_reuses"]
        return s["steps"]
    if busy.device.type != "cuda":
        raise ValueError(f"unsupported device {busy.device}")
    counts = _launch_coupled("fused_rounds_coupled_f64", s, fab, max_steps)
    if counts is not None:
        fused_rounds_coupled.launches += 1
        fused_rounds_coupled.sweeps, fused_rounds_coupled.solve_reuses = counts
    fused_rounds_coupled.reuses = s["reuses"]
    return s["steps"]


#: launches of the coupled loop kernel in this process
fused_rounds_coupled.launches = 0
#: the Jacobi sweeps of the last launch's blocks
fused_rounds_coupled.sweeps = None
#: the group steps of the last launch's blocks that reused their last solve
fused_rounds_coupled.solve_reuses = None
#: the last call's water-level reuses a row, (S,) int64
fused_rounds_coupled.reuses = None


def _launch_coupled(entry, s, fab, max_steps, *extra):
    """Launch the coupled loop entry point ``entry`` on the CUDA operands
    ``s`` and the fabric ``fab`` (``extra``: pointers after the counts
    output) on the rows' current stream; raises on a bad layout or a launch
    error. Returns the launch's (2, G) int64 counts, each block's Jacobi
    sweeps and the group steps that reused its last solve, or None for zero
    rows (no launch)."""
    dev = s["busy"].device
    dims, ptrs = _round_pointers(s, COUPLED_MAX_C)
    lay = fab["layout"]
    if isinstance(lay, ValueError):
        raise lay
    G, R = lay["rows"].shape
    counts = torch.zeros((2, G), dtype=torch.int64, device=dev)
    fptrs = [
        _build.check(lay["rows"], "rows", torch.int64, (G, R), dev),
        _build.check(lay["mask"], "mask", torch.int64, (G, COUPLED_MAX_LINKS), dev),
        _build.check(lay["cap"], "cap", torch.float64, (G, COUPLED_MAX_LINKS), dev),
        counts.data_ptr(),
    ]
    if dims["S"] == 0:
        return None
    with torch.cuda.device(dev):
        err = _entry(entry)(
            ptrs, *fptrs, *extra, dims["S"], dims["C"], dims["K"], dims["B"], dims["Q"],
            dims["P"], dims["T"], G, R, max_steps, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return counts


def fused_rounds_coupled_probe(s, fab, max_steps: int = ROUND_CAP):
    """The probe build of the coupled loop kernel on the CUDA operands ``s``
    and fabric ``fab``: the launch of :func:`fused_rounds_coupled` (``s``
    updated in place, bit for bit the same; ``fused_rounds_coupled_probe
    .sweeps`` and ``.solve_reuses`` the launch's), and each active row's SM
    cycles by phase of its group steps (:data:`COUPLED_PROBE_PHASES`),
    summed over the launch, as a new (S, phases) int64 tensor (0 on
    inactive rows). Each
    member warp reads ``clock64()`` at the phase boundaries, its waits at
    the block's barriers included. The probe has no plain version and
    raises for CPU tensors. Not on any path of the sweep: ``chip_smoke.py``
    calls it to split the group step."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be at least 1, got {max_steps}")
    busy = s["busy"]
    if busy.device.type != "cuda":
        raise ValueError(
            f"the coupled loop kernel's probe runs on the card only, not on {busy.device}")
    cycles = torch.zeros((busy.shape[0], len(COUPLED_PROBE_PHASES)), dtype=torch.int64,
                         device=busy.device)
    counts = _launch_coupled("fused_rounds_coupled_probe_f64", s, fab, max_steps,
                             cycles.data_ptr())
    if counts is not None:
        fused_rounds_coupled_probe.launches += 1
        fused_rounds_coupled_probe.sweeps, fused_rounds_coupled_probe.solve_reuses = counts
    return cycles


#: launches of the coupled loop kernel's probe build in this process
fused_rounds_coupled_probe.launches = 0
#: the Jacobi sweeps and the reused solves of the last probe launch's blocks
fused_rounds_coupled_probe.sweeps = None
fused_rounds_coupled_probe.solve_reuses = None
