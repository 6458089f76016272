"""Batched fluid sweep driver on torch tensors.

:class:`TorchFabricSimulation` runs S transfer scenarios at once. Each
sweep advances every live scenario to its own next event (a file
completion, a dead-time expiry, a controller tick or a bandwidth-profile
step); scenarios are independent, so their clocks drift apart freely.

All row state lives on the device as float64, int64 and bool tensors:
scenario scalars (S,), channel state (S, C), per-chunk queue and
controller state (S, K), the LIFO resume stack (S, K, P), the bandwidth
profile (S, B) and the timeline ring (S, T), over one flat file-size
buffer (Q,) padded once at upload. C, K, P, B and Q sit on the bucketing
ladder; C and P are sized up front from the plan's closed-form bound on
simultaneously open channels.

A step advances a row (rates, horizon, fluid byte movement) and feeds its
idle channels; the transition that follows (:mod:`.transition`: chunk
completions, the SC / MC / ProMC handlers, the controller tick, the done
test) is one copy of torch code that the host and the loop kernel's plain
version share. Three routes:

* ``fused_step="rounds"`` (the default): one launch of the loop kernel
  (``csrc/fused_step.cu``) per host round. Each row runs on the card,
  steps and transitions alike (the resume-stack feed and the timeline
  ring included), until it is done, errs (``t > max_time`` or a stranded
  chunk; the host raises), meets a capacity guard (an SC wave wider than
  the free columns, a ProMC tick with a full resume stack: its pending
  transition runs on the host in the next round, which grows the axis,
  and ``SweepStats.host_transitions`` counts it) or has taken
  :data:`ROUND_CAP` steps. C and P are pre-sized so that the guards do not
  fire on the grids.
* ``fused_step="kernel"``: one launch of the one-step fused kernel per
  sweep while no resume file exists in the batch, then :meth:`_post` on
  the host. It has no coupling and raises on a plan with shared fabrics.
* ``fused_step="none"``: every sweep split, whose water-fill is the
  bisected CUDA kernel (``waterfill_impl="kernel"``) or the sort-based
  closed form (``"closed"``), then :meth:`_post`.

Rows of a shared-fabric group (the plan's ``fabrics`` column,
:mod:`.shared`) are coupled: each step their demands become link grants
(``kernels.waterfill_coupled``) that replace their rate pools, and the
group advances in lockstep by its members' least horizon (a
``scatter_reduce("amin")`` over group ids). On ``"rounds"`` the coupled
loop kernel does this inside the launch (one block a group); on
``"none"`` the host's sweep does it in torch. A coupled batch never
compacts: a finished tenant offers zero demand and so releases its share.

On the CPU the same routes run the kernels' plain PyTorch versions. The
controllers run as masked tensor code batched over S; the host reads back
a few flags per round (which paths to take, whether a row broke its
limits, which handlers and axes a host transition needs) and nothing per
row.

Custom-scheduler rows (``transition.KIND_CUSTOM``, a Python controller
from the object ingest ``plan.from_simulations``) run the reference's
scalar callback protocol on the host: at :meth:`start` their initial
actions, and at each event that calls ``on_chunk_complete`` or
``on_tick`` the callback, its actions (Open / Close / Move, idle
channels closed first, a busy one pushing its remainder on the resume
stack, the channel columns kept in the event simulator's order) and a
feed, inside the host transition (:meth:`_post`) in the reference's
order. Each such row is read from the device once, run in numpy, and
written back once. On ``"rounds"`` the loop kernel steps such a row until
an event calls a callback, then stops it (``transition.STOP_CUSTOM``) with
the step's transition pending, which the host runs in the next round
(``SweepStats.post_row_replays`` counts it). A custom row never rides a
shared fabric.
"""
from __future__ import annotations

import copy
import math
import time
import weakref
from contextlib import contextmanager
from typing import List

import numpy as np
import torch

from repro_torch.core import netmodel
from repro_torch.core.device import resolve_device
from repro_torch.core.schedulers import ChunkView, Close, Move, Open
from repro_torch.core.simulator import SimResult

from . import kernels, transition
from .bucketing import COMPACT_FLOOR, PROFILE_PAD_FLOOR, bucket, qsizes_pad
from .kernels.fused_step import (
    ROUND_CAP, ROUND_OPERANDS, fabric_operands, fused_rounds,
    fused_rounds_coupled, fused_step,
)
from .kernels.waterfill_bisect import lane_sum, waterfill_bisect
from .plan import MAX_TIME, PLAN_C_FLOOR, PLAN_PROFILED_C_FLOOR, PROMC_PATIENCE, PROMC_RATIO
from .reference import resume_file
from .shared import resolve_fabric
from .shim import NO_CHUNK, TorchOps
from .stats import SweepStats, wall_timer
from .transition import KIND_CUSTOM, STOP_CUSTOM, STOP_GUARD, STOP_NONE

_EPS = 1e-12

#: timeline samples kept per recording scenario (uniform-stride
#: decimation past it)
TIMELINE_BUDGET = 512

FUSED_STEP_OPTIONS = ("none", "kernel", "rounds")
WATERFILL_OPTIONS = ("closed", "kernel")

#: the widest channel axis the kernels take (C <= 1024)
MAX_COLUMNS = 1024

#: every per-scenario row tensor, for compaction
_ROW_ARRAYS = (
    "t", "done", "next_tick", "tick_period", "n_events", "finish_t",
    "fin_any", "max_time", "record_timeline", "trivial_tick", "trivial_complete", "kind",
    "bw", "disk_rate", "sat_cc", "contention", "n_chunks", "chunk_of",
    "dead", "rem", "busy", "cap", "chunk_done", "completed_at",
    "delivered", "delivered_at_tick", "rate_est", "queue_bytes", "fsdt",
    "qoff", "qlen", "qptr", "prepend_n", "prepend_sizes", "streak",
    "pair_fast", "pair_slow", "promc_ratio", "promc_patience", "sc_cursor",
    "sc_order", "conc", "par", "cap_k", "avg_fs_k", "nfiles", "setup_cost",
    "n_moves", "prof_t", "prof_mult", "tl_t", "tl_rate", "tl_len",
    "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate", "steps", "stop", "reuses",
    "level_reuses",
)

#: a custom-scheduler row's state that its callbacks read and write, by
#: axis: the channels (C), the chunks (K), the resume stack (K x P) and
#: scalars
_HOST_C = ("chunk_of", "busy", "dead", "rem", "cap")
_HOST_K = ("qptr", "queue_bytes", "prepend_n", "chunk_done", "completed_at", "rate_est")
_HOST_S = ("t", "n_moves")

#: per-row results read back when a row retires
_RESULT_ARRAYS = (
    "finish_t", "n_events", "completed_at", "delivered", "n_moves", "tl_t",
    "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate",
    "level_reuses",
)


class _PlanRuntime:
    """Host-side per-scenario metadata: names for results and errors, the
    byte total, the final metrics once the row has retired, and a custom
    row's controller (``custom``, None on the built-in kinds)."""

    __slots__ = (
        "index", "name", "network", "scheduler", "chunks", "total_bytes",
        "archive", "custom",
    )

    def __init__(self, index, name, network, scheduler, chunks, total_bytes, custom=None):
        self.index = index
        self.name = name
        self.network = network
        self.scheduler = scheduler
        self.chunks = chunks
        self.total_bytes = total_bytes
        self.archive = None
        self.custom = custom


class _Controller:
    """A custom-scheduler row's host side: a copy of its scheduler (the
    plan's object is left as it was, so a plan runs again), its chunks,
    network and queues, and the ``predict_chunk_rate`` cache of its views,
    keyed as the reference keys it ``(chunk, its channels, open channels)``."""

    __slots__ = ("scheduler", "chunks", "network", "avg_fs", "qoff", "qlen", "fsdt",
                 "predict_cache")

    def __init__(self, row, network, qoff, qlen, fsdt):
        # the chunks, their files and the network are shared, not copied
        memo = {id(c): c for c in row.chunks}
        memo[id(network)] = network
        self.scheduler = copy.deepcopy(row.scheduler, memo)
        self.chunks = row.chunks
        self.network = network
        self.avg_fs = [max(c.avg_file_size, 1.0) for c in row.chunks]
        self.qoff, self.qlen, self.fsdt = qoff, qlen, fsdt
        self.predict_cache: dict = {}


class _HostRow:
    """One custom row's state, read from the device into numpy: channel
    columns ``ch`` / ``busy`` / ``dead`` / ``rem`` / ``cap`` (C,), chunk
    columns ``qptr`` / ``qb`` / ``pn`` / ``done`` / ``cat`` / ``rate``
    (K,), the resume stack ``ps`` (K, P), the clock ``t`` and ``n_moves``.
    Its C and P double here when a callback needs more room; the driver
    grows its axes to match when the row is written back."""

    __slots__ = ("row", "ctl", "ch", "busy", "dead", "rem", "cap", "qptr", "qb", "pn",
                 "done", "cat", "rate", "ps", "t", "n_moves")


class TorchFabricSimulation:
    """Run the rows of a :class:`repro_torch.eval.fabric.plan.ScenarioPlan`
    through the fluid transfer model simultaneously.

    ``device`` defaults to the card (and raises without one);
    ``fused_step`` is ``"rounds"`` (resume-free sweeps through the loop
    kernel, many steps a launch), ``"kernel"`` (through the one-step
    kernel) or ``"none"`` (every sweep split); ``waterfill_impl`` picks
    the split path's water-fill, ``"kernel"`` (bisected) or ``"closed"``
    (sort-based closed form, the NumPy reference's default).
    """

    def __init__(
        self,
        plan,
        *,
        device=None,
        fused_step: str = "rounds",
        waterfill_impl: str = "kernel",
    ):
        if fused_step not in FUSED_STEP_OPTIONS:
            raise ValueError(f"unknown fused_step {fused_step!r}; options: {FUSED_STEP_OPTIONS}")
        if waterfill_impl not in WATERFILL_OPTIONS:
            raise ValueError(
                f"unknown waterfill_impl {waterfill_impl!r}; options: {WATERFILL_OPTIONS}"
            )
        if plan.custom is not None and any(f is not None for f in plan.fabrics):
            raise ValueError(
                "a plan holds custom-scheduler rows and shared-fabric rows; custom rows run "
                "uncoupled"
            )
        if fused_step == "kernel" and any(f is not None for f in plan.fabrics):
            raise ValueError(
                'fused_step="kernel" has no coupling: a plan with shared fabrics runs on '
                '"rounds" or "none"'
            )
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.fused_step = fused_step
        self.waterfill_impl = waterfill_impl
        self.stats = SweepStats()
        #: weak references to every device tensor the construction made,
        #: on the stream that was current then (:meth:`use_stream` hands
        #: them to another; weak, so that a run still frees what it replaces)
        self._built: List[weakref.ref] = []
        #: the host turn ``run`` was given, and its seconds spent waiting
        #: to take it back after a read
        self._turn = None
        self._turn_wait_s = 0.0
        self._started = False
        self._init_from_plan(plan)
        self._set_fabric(plan)
        self.stats.build_wall_s += time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    def _init_from_plan(self, plan) -> None:
        """Build every row column on the host from the plan (the t=0
        channel layout included) and upload them once."""
        S = self.S = plan.n_rows
        nets = plan.networks
        ni = plan.net_idx
        n_chunks = plan.n_chunks.astype(np.int64)
        K = self.K = bucket(int(n_chunks.max(initial=1)))
        custom = plan.custom or [None] * S
        self.rt = [
            _PlanRuntime(
                i, plan.names[i], nets[ni[i]].name, plan.sched_names[i],
                plan.chunk_names[i], float(plan.total_bytes[i]),
                None if custom[i] is None else _Controller(
                    custom[i], nets[ni[i]], plan.qoff[i], plan.qlen[i], plan.fsdt[i]
                ),
            )
            for i in range(S)
        ]
        #: the plan's file sizes on the host (custom rows' feed)
        self._qsizes_host = plan.qsizes

        def net_f(f, dtype=np.float64):
            return np.array([f(n) for n in nets], dtype=dtype)[ni]

        # time-varying bandwidth: piecewise-constant multiplier steps,
        # padded with (inf, last multiplier) steps the lookup never selects
        profiles = [n.bandwidth_profile or ((0.0, 1.0),) for n in nets]
        B = max((len(profiles[j]) for j in ni), default=1)
        if B > 1:
            B = bucket(B, PROFILE_PAD_FLOOR)
        pt = np.full((len(nets), B), np.inf)
        pm = np.ones((len(nets), B))
        for j, prof in enumerate(profiles):
            for b, (t0, m0) in enumerate(prof[:B]):
                pt[j, b] = t0
                pm[j, b] = m0
            pm[j, len(prof):] = prof[-1][1]

        # channel and resume-stack capacity from the closed-form bound
        open_n = plan.open_n[:, :K]
        vrank = plan.visit_rank[:, :K]
        c_floor = PLAN_C_FLOOR if B == 1 else PLAN_PROFILED_C_FLOOR
        need_c = max(
            int(plan.cap_need.max(initial=1)), c_floor,
            int(open_n.sum(axis=1).max(initial=0)),
        )
        C = self.C = bucket(need_c, 4)
        P = self.P = bucket(need_c + 1, 4)

        # t=0 initial actions: chunk k's channels lie contiguously after
        # those of the chunks served before it, at the full setup cost
        setup_cost = net_f(lambda n: n.channel_setup_cost)
        cap_k = plan.cap_k[:, :K]
        ahead = vrank[:, :, None] > vrank[:, None, :]
        off = np.sum(np.where(ahead, open_n[:, None, :], 0), axis=2)
        cols = np.arange(C)[None, None, :]
        occupies = (cols >= off[:, :, None]) & (cols < (off + open_n)[:, :, None])
        chunk_idx = occupies.argmax(axis=1)
        is_open = occupies.any(axis=1)

        record = plan.record_timeline.astype(bool)
        self._any_record = bool(record.any())
        T = TIMELINE_BUDGET if self._any_record else 1
        kind = plan.kind.astype(np.int64)
        chunk_done = np.arange(K)[None, :] >= n_chunks[:, None]
        qsizes = np.zeros(qsizes_pad(plan.qsizes.shape[0]), dtype=np.float64)
        qsizes[: plan.qsizes.shape[0]] = plan.qsizes
        self.qsizes = self._up(qsizes, torch.float64)

        f8, i8, b1 = torch.float64, torch.int64, torch.bool
        host = {
            "t": (np.zeros(S), f8),
            "done": (np.zeros(S, dtype=bool), b1),
            "next_tick": (plan.tick_period, f8),
            "tick_period": (plan.tick_period, f8),
            "n_events": (np.zeros(S, dtype=np.int64), i8),
            "finish_t": (np.zeros(S), f8),
            "fin_any": (np.zeros(S, dtype=bool), b1),
            "max_time": (np.full(S, MAX_TIME), f8),
            "record_timeline": (record, b1),
            "trivial_tick": (plan.trivial_tick, b1),
            "trivial_complete": (plan.trivial_complete, b1),
            "kind": (kind, i8),
            "bw": (net_f(lambda n: n.bandwidth), f8),
            "disk_rate": (net_f(lambda n: n.disk.streaming_rate), f8),
            "sat_cc": (net_f(lambda n: n.disk.saturation_cc, np.int64), i8),
            "contention": (net_f(lambda n: n.disk.contention), f8),
            "n_chunks": (n_chunks, i8),
            "chunk_of": (np.where(is_open, chunk_idx, NO_CHUNK), i8),
            "dead": (np.where(is_open, setup_cost[:, None], 0.0), f8),
            "rem": (np.zeros((S, C)), f8),
            "busy": (np.zeros((S, C), dtype=bool), b1),
            "cap": (np.where(is_open, np.take_along_axis(cap_k, chunk_idx, axis=1), 0.0), f8),
            "chunk_done": (chunk_done, b1),
            "completed_at": (np.full((S, K), math.nan), f8),
            "delivered": (np.zeros((S, K)), f8),
            "delivered_at_tick": (np.zeros((S, K)), f8),
            "rate_est": (np.zeros((S, K)), f8),
            "queue_bytes": (plan.queue_bytes[:, :K], f8),
            "fsdt": (plan.fsdt[:, :K], f8),
            "qoff": (plan.qoff[:, :K], i8),
            "qlen": (plan.qlen[:, :K], i8),
            "qptr": (np.zeros((S, K), dtype=np.int64), i8),
            "prepend_n": (np.zeros((S, K), dtype=np.int64), i8),
            "prepend_sizes": (np.zeros((S, K, P)), f8),
            "streak": (np.zeros(S, dtype=np.int64), i8),
            "pair_fast": (np.full(S, -1, dtype=np.int64), i8),
            "pair_slow": (np.full(S, -1, dtype=np.int64), i8),
            "promc_ratio": (np.full(S, PROMC_RATIO), f8),
            "promc_patience": (np.full(S, PROMC_PATIENCE, dtype=np.int64), i8),
            "sc_cursor": (np.zeros(S, dtype=np.int64), i8),
            "sc_order": (plan.sc_order[:, :K], i8),
            "conc": (plan.conc[:, :K], i8),
            "par": (plan.par[:, :K], i8),
            "cap_k": (cap_k, f8),
            "avg_fs_k": (plan.avg_fs_k[:, :K], f8),
            "nfiles": (plan.qlen[:, :K], i8),
            "setup_cost": (setup_cost, f8),
            "n_moves": (np.zeros(S, dtype=np.int64), i8),
            "prof_t": (pt[ni], f8),
            "prof_mult": (pm[ni], f8),
            "tl_t": (np.zeros((S, T)), f8),
            "tl_rate": (np.zeros((S, T)), f8),
            "tl_len": (np.zeros(S, dtype=np.int64), i8),
            "tl_stride": (np.ones(S, dtype=np.int64), i8),
            "tl_seen": (np.zeros(S, dtype=np.int64), i8),
            "tl_last_t": (np.zeros(S), f8),
            "tl_last_rate": (np.zeros(S), f8),
            # the last loop launch: each row's steps, stop code and water
            # levels reused; and the reuses of every launch so far
            "steps": (np.zeros(S, dtype=np.int64), i8),
            "stop": (np.full(S, STOP_NONE, dtype=np.int64), i8),
            "reuses": (np.zeros(S, dtype=np.int64), i8),
            "level_reuses": (np.zeros(S, dtype=np.int64), i8),
        }
        for name, (arr, dtype) in host.items():
            setattr(self, name, self._up(arr, dtype))

    def _set_fabric(self, plan) -> None:
        """Lower the plan's fabric column into the coupling tensors
        (``self.coupled`` False when no row rides a fabric)."""
        fab = resolve_fabric(plan.fabrics)
        self.coupled = fab.coupled
        if self.coupled:
            self._fab = fabric_operands(fab.group_id, fab.member, fab.link_cap, self.device,
                                        names=plan.names)
            layout = self._fab["layout"]
            made = [v for v in self._fab.values() if isinstance(v, torch.Tensor)]
            made += list(layout.values()) if isinstance(layout, dict) else []
            self._built += [weakref.ref(t) for t in made]

    def _up(self, arr, dtype) -> torch.Tensor:
        """A new device tensor (never a view of the plan's arrays: the
        fused-rounds kernel updates state in place)."""
        t = torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=self.device)
        self._built.append(weakref.ref(t))
        return t

    def use_stream(self, stream, ready=None) -> None:
        """Hand the driver, built under another stream, to ``stream``, on
        which the caller then runs it: ``stream`` waits for ``ready`` (an
        event recorded once the build was queued), and every tensor the
        build made is marked as used on ``stream``. The run frees them on
        ``stream`` (compaction replaces them), and without the mark the
        caching allocator would give their blocks back to the build's
        stream, where the next chunk's uploads could write them before
        ``stream``'s queued work has read them."""
        if ready is not None:
            stream.wait_event(ready)
        for ref in self._built:
            t = ref()
            if t is not None:
                t.record_stream(stream)
        self._built = []

    # ------------------------------------------------------------------ #
    # host reads
    # ------------------------------------------------------------------ #

    @contextmanager
    def _device_read(self):
        """Around a device-to-host read: its seconds go to
        ``stats.download_wall_s``, and the host turn, when ``run`` was
        given one, is given up while the read waits, so that another
        chunk's host work runs then; the wait to take the turn back is
        counted in no field."""
        turn = self._turn
        if turn is not None:
            turn.release()
        try:
            with wall_timer(self.stats, "download_wall_s"):
                yield
        finally:
            if turn is not None:
                t0 = time.perf_counter()
                turn.acquire()
                self._turn_wait_s += time.perf_counter() - t0

    def _read(self, t: torch.Tensor) -> list:
        """One host read of a small device tensor (waits for the device)."""
        self.stats.host_syncs += 1
        with self._device_read():
            return t.tolist()

    # ------------------------------------------------------------------ #
    # capacity growth (the pre-sized axes make these rare)
    # ------------------------------------------------------------------ #

    def _grow(self) -> None:
        """Double the channel axis C with empty columns (at most
        :data:`MAX_COLUMNS`)."""
        if 2 * self.C > MAX_COLUMNS:
            raise RuntimeError(
                f"the channel axis would grow past {MAX_COLUMNS} columns (C={self.C})"
            )
        pad = self.C
        self.C *= 2

        def z(a, fill):
            tail = torch.full((self.S, pad), fill, dtype=a.dtype, device=a.device)
            return torch.cat([a, tail], dim=1)

        self.chunk_of = z(self.chunk_of, NO_CHUNK)
        self.dead = z(self.dead, 0.0)
        self.rem = z(self.rem, 0.0)
        self.busy = z(self.busy, False)
        self.cap = z(self.cap, 0.0)

    def _grow_prepend(self) -> None:
        """Double the resume-stack depth P."""
        pad = torch.zeros(
            (self.S, self.K, self.P), dtype=torch.float64, device=self.device
        )
        self.P *= 2
        self.prepend_sizes = torch.cat([self.prepend_sizes, pad], dim=2)

    # ------------------------------------------------------------------ #
    # the sweep
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        """t=0: the plan's initial channels (laid out at construction) pull
        their first files; then each custom row, in row order, applies its
        scheduler's initial actions and feeds (as the reference's
        ``start``). Idempotent."""
        if self._started:
            return
        self._started = True
        self._feed(torch.ones(self.S, dtype=torch.bool, device=self.device))
        rows = self._custom_rows()
        if rows:
            hosts = self._read_rows(rows)
            for h in hosts:
                self._apply(h, h.ctl.scheduler.initial_actions(self._view(h)))
                self._feed_py(h)
            self._write_rows(hosts)

    def step(self) -> bool:
        """One host round over the live rows: a synchronized sweep, or on
        the ``"rounds"`` route one loop launch in which each row steps
        until it is done, errs, meets a capacity guard or takes
        :data:`ROUND_CAP` steps. Returns False once every row is done. One
        host read decides the route, compaction, whether any row exceeded
        ``max_time`` or stranded a chunk, and which rows a guard or a custom
        row's callback event stopped (their pending transition runs here
        first)."""
        act = ~self.done
        guarded = act & (self.stop == STOP_GUARD)
        called = act & (self.stop == STOP_CUSTOM)
        pending = guarded | called
        chk = act & ~pending  # a pending row's state is mid-step
        over = chk & (self.t > self.max_time)
        stranded = transition.stranded(vars(self), chk)
        n_act, n_pre, n_over, n_str, n_guard, n_call = self._read(
            torch.stack([
                act.sum(), (self.prepend_n > 0).sum(), over.sum(), stranded.sum(),
                guarded.sum(), called.sum(),
            ])
        )
        n_pend = n_guard + n_call
        if n_act == 0:
            return False
        if n_over:
            s = int(torch.nonzero(over)[0])
            raise RuntimeError(
                f"batch scenario {self.rt[s].name!r} exceeded max_time="
                f"{float(self.max_time[s])}s (t={float(self.t[s]):.1f})"
            )
        if n_str:
            s = int(torch.nonzero(stranded)[0])
            r = self.rt[s]
            raise RuntimeError(
                f"scheduler {r.scheduler} stranded chunks of {r.name!r}"
            )
        if n_pend:
            self.stats.host_transitions += n_guard
            self.stats.post_row_replays += n_call
            self._post(pending, skip_feed=True)
            self.stop = torch.where(pending, STOP_NONE, self.stop)
            act = ~self.done
        # amortized compaction: rebuild once half of a wide batch is done
        # (a coupled batch keeps its rows: done tenants offer zero demand)
        if not self.coupled and self.S > COMPACT_FLOOR and (self.S - n_act) * 2 >= self.S:
            self._compact(act)
            act = ~self.done
        self.stats.sweeps += 1
        if self.fused_step == "rounds":
            self.stats.fused += 1
            # counts the rows' events and takes their transitions itself
            if self.coupled:
                fused_rounds_coupled(self.round_operands(act), self._fab, ROUND_CAP)
            else:
                fused_rounds(self.round_operands(act), ROUND_CAP)
            self.level_reuses = self.level_reuses + self.reuses
            return True
        self.n_events = self.n_events + act.to(torch.int64)
        if self.fused_step == "kernel" and n_pre == 0:
            self.stats.fused += 1
            self._advance_fused(act)
            self._post(act, skip_feed=True)
        else:
            self.stats.split += 1
            self._advance(act)
            self._post(act)
        return True

    def _bandwidth_now(self):
        """Effective per-row bandwidth under the profile at time ``t`` and
        the time of each row's next profile step (inf when static)."""
        return kernels.bandwidth_now(self.bw, self.prof_t, self.prof_mult, self.t)

    def _waterfill(self, caps, pool):
        if self.waterfill_impl == "kernel":
            return waterfill_bisect(caps.contiguous(), pool.contiguous())
        return kernels.waterfill(caps, pool)

    def _record(self, act, rate_sum, t=None) -> None:
        """Push a timeline sample ``(t, rate_sum)`` (``t`` defaults to the
        rows' clocks) on the recording rows of ``act``."""
        (
            self.tl_t, self.tl_rate, self.tl_len, self.tl_stride,
            self.tl_seen, self.tl_last_t, self.tl_last_rate,
        ) = kernels.timeline_push(
            act & self.record_timeline, self.t if t is None else t, rate_sum, self.tl_t,
            self.tl_rate, self.tl_len, self.tl_stride, self.tl_seen,
            self.tl_last_t, self.tl_last_rate,
        )

    def _advance(self, act) -> None:
        """Split physics half of a sweep: rates, horizon, fluid movement;
        with shared fabrics, the coupling step around them."""
        transferring = self.busy & (self.dead <= _EPS)
        eff_bw, next_prof = self._bandwidth_now()
        pool = kernels.disk_pool(
            transferring.sum(dim=-1), eff_bw, self.disk_rate, self.sat_cc,
            self.contention,
        )
        caps = torch.where(transferring, self.cap, 0.0)
        if self.coupled:
            # a demand's total is summed in the order of the water-fill that
            # follows, so an unsaturated grant leaves its level unchanged
            total = lane_sum(caps) if self.waterfill_impl == "kernel" else kernels.caps_total(caps)
            pool, sweeps = kernels.coupled_pool(pool, total, act, self._fab)
            self.stats.host_syncs += sweeps  # each sweep's fixed-point test
        rates = torch.where(act.unsqueeze(-1), self._waterfill(caps, pool), 0.0)
        if self._any_record:
            self._record(act, rates.sum(dim=-1))
        dt = kernels.event_horizon(
            torch.minimum(self.next_tick - self.t, next_prof - self.t),
            self.busy, self.dead, transferring, self.rem, rates,
        )
        dt = torch.where(act, dt, 0.0)
        if self.coupled:  # a fabric group shares one clock
            dt = kernels.lockstep_dt(dt, act, self._fab["group_id"], self._fab["n_groups"])
        self.t = self.t + dt
        self.busy, self.dead, self.rem, moved, finished = kernels.advance_channels(
            act, dt, self.busy, self.dead, transferring, self.rem, rates
        )
        self.delivered = TorchOps.chunk_scatter_add(
            self.delivered, self.chunk_of, moved, moved != 0.0
        )
        self.fin_any = torch.where(act, finished.any(dim=-1), self.fin_any)

    def _advance_fused(self, act) -> None:
        """Physics half + FIFO feed as one fused-step launch (resume-free
        sweeps only); timeline and the delivered scatter stay here."""
        eff_bw, next_prof = self._bandwidth_now()
        (
            dt, rate_sum, fin, self.busy, self.dead, self.rem, moved,
            self.qptr, self.queue_bytes,
        ) = fused_step(
            act, self.busy, self.dead, self.rem, self.cap, self.chunk_of,
            torch.minimum(self.next_tick - self.t, next_prof - self.t),
            eff_bw.contiguous(), self.disk_rate, self.sat_cc, self.contention,
            self.qoff, self.qlen, self.qptr, self.queue_bytes, self.fsdt,
            self.qsizes,
        )
        if self._any_record:
            self._record(act, rate_sum)
        self.t = self.t + dt  # dt is 0 on inactive rows
        self.delivered = TorchOps.chunk_scatter_add(
            self.delivered, self.chunk_of, moved, moved != 0.0
        )
        self.fin_any = torch.where(act, fin, self.fin_any)

    def round_operands(self, act) -> dict:
        """The loop kernel's operands: the driver's own state tensors by
        name (updated in place by a launch), with ``act``."""
        s = {name: getattr(self, name) for name in ROUND_OPERANDS if name != "act"}
        s["act"] = act
        return s

    def _feed(self, enabled) -> None:
        """Idle channels of ``enabled`` rows pull their next file (resume
        stack first, then FIFO)."""
        transition.feed(vars(self), enabled)

    def _post(self, act, skip_feed: bool = False) -> None:
        """Transition half of a sweep on the host: feed (unless the step's
        kernel fed already) -> completions -> tick -> done, through
        :func:`.transition.post_transition` on the driver's own tensors.
        One host read skips handlers no row runs and finds the capacity
        guards, which grow C or P before the transition."""
        s = vars(self)  # post_transition replaces the driver's tensors in place
        if not skip_feed:
            transition.feed(s, act)
        completed, tick_hit = transition.completions(s, act)
        flags = self._read(transition.transition_flags(s, completed, tick_hit))
        hint = transition.hints(flags, self.K)
        if hint["ks_sc"]:
            while self._read(transition.sc_short(s, completed, hint["ks_sc"]).any()):
                self._grow()
        full = transition.stack_guard_read(flags, self.K)
        while full:
            self._grow_prepend()
            full = self._read(transition.stack_full(s, tick_hit).any())
        custom = None
        if transition.custom_read(flags, self.K):
            comp_rows = completed.any(dim=-1) & ~self.trivial_complete
            custom = (
                lambda: self._callbacks(comp_rows, self._on_complete),
                lambda: self._callbacks(tick_hit & ~self.trivial_tick, self._on_tick),
            )
        transition.post_transition(s, act, completed, tick_hit, custom=custom, **hint)

    # ------------------------------------------------------------------ #
    # custom-scheduler rows: the scalar callback protocol on the host
    # ------------------------------------------------------------------ #

    def _custom_rows(self) -> List[int]:
        """The custom rows' indices in row order (host-known)."""
        return [r.index for r in self.rt if r.custom is not None]

    def _read_rows(self, rows: List[int], mask=None) -> List[_HostRow]:
        """One host read of rows ``rows``' state (as float64, exact for
        their int64 and bool values), with ``mask`` (S,) bool when given:
        then only the rows it holds come back."""
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        n = len(rows)
        parts = [] if mask is None else [mask.index_select(0, idx).to(torch.float64).view(n, 1)]
        parts += [
            getattr(self, name).index_select(0, idx).reshape(n, -1).to(torch.float64)
            for name in _HOST_C + _HOST_K + ("prepend_sizes",) + _HOST_S
        ]
        flat = torch.cat(parts, dim=1)
        with self._device_read():
            flat = flat.cpu().numpy()
        self.stats.host_syncs += 1
        C, K, P = self.C, self.K, self.P
        hosts = []
        for j, row in enumerate(rows):
            v = flat[j]
            if mask is not None:
                if not v[0]:
                    continue
                v = v[1:]
            h = _HostRow()
            h.row, h.ctl = row, self.rt[row].custom
            h.ch = v[0:C].astype(np.int64)
            h.busy = v[C:2 * C] != 0
            h.dead, h.rem, h.cap = v[2 * C:3 * C].copy(), v[3 * C:4 * C].copy(), v[4 * C:5 * C].copy()
            o = 5 * C
            h.qptr = v[o:o + K].astype(np.int64)
            h.qb = v[o + K:o + 2 * K].copy()
            h.pn = v[o + 2 * K:o + 3 * K].astype(np.int64)
            h.done = v[o + 3 * K:o + 4 * K] != 0
            h.cat = v[o + 4 * K:o + 5 * K].copy()
            h.rate = v[o + 5 * K:o + 6 * K].copy()
            o += 6 * K
            h.ps = v[o:o + K * P].reshape(K, P).copy()
            h.t, h.n_moves = float(v[o + K * P]), int(v[o + K * P + 1])
            hosts.append(h)
        return hosts

    def _write_rows(self, hosts: List[_HostRow]) -> None:
        """Write rows read by :meth:`_read_rows` back (one upload a tensor),
        first growing C and P to the widest row's."""
        if not hosts:
            return
        while self.C < max(len(h.ch) for h in hosts):
            self._grow()
        while self.P < max(h.ps.shape[1] for h in hosts):
            self._grow_prepend()
        C, P = self.C, self.P

        def pad(a, width, fill):
            return np.concatenate([a, np.full(width - a.shape[-1], fill, dtype=a.dtype)])

        idx = torch.tensor([h.row for h in hosts], dtype=torch.int64, device=self.device)
        cols = {
            "chunk_of": [pad(h.ch, C, NO_CHUNK) for h in hosts],
            "busy": [pad(h.busy, C, False) for h in hosts],
            "dead": [pad(h.dead, C, 0.0) for h in hosts],
            "rem": [pad(h.rem, C, 0.0) for h in hosts],
            "cap": [pad(h.cap, C, 0.0) for h in hosts],
            "qptr": [h.qptr for h in hosts],
            "queue_bytes": [h.qb for h in hosts],
            "prepend_n": [h.pn for h in hosts],
            "chunk_done": [h.done for h in hosts],
            "completed_at": [h.cat for h in hosts],
            "rate_est": [h.rate for h in hosts],
            "prepend_sizes": [
                np.concatenate([h.ps, np.zeros((self.K, P - h.ps.shape[1]))], axis=1)
                for h in hosts
            ],
            "t": [h.t for h in hosts],
            "n_moves": [h.n_moves for h in hosts],
        }
        for name, vals in cols.items():
            cur = getattr(self, name)
            new = torch.as_tensor(np.array(vals), dtype=cur.dtype).to(self.device)
            setattr(self, name, cur.index_copy(0, idx, new))

    def _callbacks(self, rows_mask, run) -> None:
        """Run ``run(h)`` on each custom row that ``rows_mask`` holds, in
        row order: one read of the rows, one write back."""
        hosts = self._read_rows(self._custom_rows(), rows_mask & (self.kind == KIND_CUSTOM))
        for h in hosts:
            run(h)
        self._write_rows(hosts)

    def _on_complete(self, h: _HostRow) -> None:
        """The row's completions: mark every completed chunk, then each
        one's ``on_chunk_complete`` in chunk order, its actions and a
        feed."""
        for k in self._check_completions_py(h):
            actions = h.ctl.scheduler.on_chunk_complete(self._view(h), k)
            if actions:
                self._apply(h, actions)
                self._feed_py(h)

    def _on_tick(self, h: _HostRow) -> None:
        """The row's ``on_tick`` over its post-EMA views, its actions and a
        feed."""
        actions = h.ctl.scheduler.on_tick(self._view(h))
        if actions:
            self._apply(h, actions)
            self._feed_py(h)

    def _view(self, h: _HostRow) -> List[ChunkView]:
        """The row's ChunkViews (the event simulator's ``_view``)."""
        ctl = h.ctl
        nK = len(ctl.chunks)
        ko = h.ch
        open_mask = ko != NO_CHUNK
        n_open_total = int(open_mask.sum())
        busy_m = open_mask & h.busy
        n_ch = np.bincount(ko[open_mask], minlength=nK)
        busy_ch = np.bincount(ko[busy_m], minlength=nK)
        inflight = np.zeros(nK)
        np.add.at(inflight, ko[busy_m], h.rem[busy_m])
        views = []
        for k, chunk in enumerate(ctl.chunks):
            key = (k, int(n_ch[k]), n_open_total)
            predicted = ctl.predict_cache.get(key)
            if predicted is None:
                predicted = netmodel.predict_chunk_rate(
                    ctl.network, ctl.avg_fs[k], chunk.params, max(int(n_ch[k]), 1),
                    total_active_channels=max(1, n_open_total),
                )
                ctl.predict_cache[key] = predicted
            views.append(ChunkView(
                index=k,
                ctype=chunk.ctype,
                bytes_remaining=float(h.qb[k]) + float(inflight[k]),
                files_remaining=self._files_left(h, k) + int(busy_ch[k]),
                throughput=float(h.rate[k]),
                n_channels=int(n_ch[k]),
                done=bool(h.done[k]),
                predicted_rate=predicted,
            ))
        return views

    @staticmethod
    def _files_left(h: _HostRow, k: int) -> int:
        return int(h.ctl.qlen[k] - h.qptr[k] + h.pn[k])

    def _apply(self, h: _HostRow, actions) -> None:
        """A controller's actions on the row, in order."""
        for act in actions:
            if isinstance(act, Open):
                for _ in range(act.n):
                    self._open_channel(h, act.chunk, prev=None)
            elif isinstance(act, Close):
                self._close_channels(h, act.chunk, act.n)
            elif isinstance(act, Move):
                moved = self._close_channels(h, act.src, act.n)
                for prev in moved:
                    self._open_channel(h, act.dst, prev=prev)
                h.n_moves += len(moved)

    def _open_channel(self, h: _HostRow, chunk: int, prev) -> None:
        """Open a channel for ``chunk`` at the lowest free column (after a
        close's left-pack, the end: opens append), doubling the row's C
        when none is free."""
        free = np.flatnonzero(h.ch == NO_CHUNK)
        if free.size == 0:
            width = len(h.ch)
            if 2 * width > MAX_COLUMNS:
                raise RuntimeError(
                    f"custom scheduler of {self.rt[h.row].name!r} opens more than "
                    f"{MAX_COLUMNS} channels"
                )
            h.ch = np.concatenate([h.ch, np.full(width, NO_CHUNK, dtype=np.int64)])
            h.busy = np.concatenate([h.busy, np.zeros(width, dtype=bool)])
            h.dead, h.rem, h.cap = (np.concatenate([a, np.zeros(width)])
                                    for a in (h.dead, h.rem, h.cap))
            free = np.array([width])
        c = free[0]
        params = h.ctl.chunks[chunk].params
        h.ch[c] = chunk
        h.dead[c] = netmodel.channel_open_cost(h.ctl.network, params, prev)
        h.rem[c] = 0.0
        h.busy[c] = False
        h.cap[c] = netmodel.channel_rate_cap(h.ctl.network, params.parallelism)

    def _close_channels(self, h: _HostRow, chunk: int, n: int) -> list:
        """Close up to ``n`` of ``chunk``'s channels, idle ones first (the
        event simulator's preference); a busy one pushes its remainder on
        the resume stack. Left-packs the row after a close. Returns the
        closed channels' parameters."""
        cols = np.flatnonzero(h.ch == chunk)
        cols = sorted(cols, key=lambda c: bool(h.busy[c]))
        params = h.ctl.chunks[chunk].params
        closed = []
        for c in cols[:n]:
            if h.busy[c] and h.rem[c] > 0:
                self._push_resume(h, chunk, float(resume_file(h.rem[c]).size))
            h.ch[c] = NO_CHUNK
            h.busy[c] = False
            h.dead[c] = 0.0
            h.rem[c] = 0.0
            h.cap[c] = 0.0
            closed.append(params)
        if closed:
            self._pack_row(h)
        return closed

    @staticmethod
    def _push_resume(h: _HostRow, chunk: int, size: float) -> None:
        """Push a resume file on ``chunk``'s LIFO stack, doubling the row's
        P when the stack is full."""
        P = h.ps.shape[1]
        if h.pn[chunk] >= P:
            h.ps = np.concatenate([h.ps, np.zeros_like(h.ps)], axis=1)
        h.ps[chunk, h.pn[chunk]] = size
        h.pn[chunk] += 1
        h.qb[chunk] += size

    @staticmethod
    def _pack_row(h: _HostRow) -> None:
        """Left-pack the row's channel columns, keeping their order: closes
        remove a column, opens append one, as in the event simulator's
        channel list (``kernels.compact_channels``)."""
        order = np.argsort(h.ch == NO_CHUNK, kind="stable")
        h.ch, h.busy, h.dead, h.rem, h.cap = (a[order] for a in (h.ch, h.busy, h.dead, h.rem,
                                                                 h.cap))

    def _feed_py(self, h: _HostRow) -> None:
        """Idle open channels, in column order, pull their chunk's next
        file: the resume stack first, then the queue (the event
        simulator's ``_feed_channels``)."""
        ctl = h.ctl
        for c in np.flatnonzero((h.ch != NO_CHUNK) & ~h.busy):
            k = int(h.ch[c])
            if h.pn[k] > 0:
                h.pn[k] -= 1
                size = h.ps[k, h.pn[k]]
            elif h.qptr[k] < ctl.qlen[k]:
                size = self._qsizes_host[ctl.qoff[k] + h.qptr[k]]
                h.qptr[k] += 1
            else:
                continue
            h.qb[k] -= size
            h.busy[c] = True
            h.rem[c] = size
            h.dead[c] += ctl.fsdt[k]

    def _check_completions_py(self, h: _HostRow) -> List[int]:
        """Mark the row's chunks with no file left and none in flight
        complete at its clock; returns them in chunk order."""
        completed = []
        for k in range(len(h.ctl.chunks)):
            if h.done[k]:
                continue
            busy = bool(((h.ch == k) & h.busy).any())
            if self._files_left(h, k) == 0 and not busy:
                h.done[k] = True
                h.qb[k] = 0.0
                h.cat[k] = h.t
                completed.append(k)
        return completed

    # ------------------------------------------------------------------ #
    # live-row compaction and results
    # ------------------------------------------------------------------ #

    def _download(self, rows=None) -> dict:
        """Result columns of ``rows`` (default: all) as numpy arrays."""
        out = {}
        with self._device_read():
            for name in _RESULT_ARRAYS:
                t = getattr(self, name)
                out[name] = (t if rows is None else t.index_select(0, rows)).cpu().numpy()
        self.stats.host_syncs += 1
        return out

    def _compact(self, alive_mask) -> None:
        """Retire finished rows: archive their results on the host and keep
        only the live rows. Scenarios are independent, so this changes no
        survivor's events."""
        alive = torch.nonzero(alive_mask).squeeze(-1)
        gone = torch.nonzero(~alive_mask).squeeze(-1)
        archived = self._download(gone)
        for j, s in enumerate(gone.tolist()):
            self.rt[s].archive = {k: v[j] for k, v in archived.items()}
        for name in _ROW_ARRAYS:
            setattr(self, name, getattr(self, name).index_select(0, alive))
        survivors = []
        for new_row, s in enumerate(alive.tolist()):
            r = self.rt[s]
            r.index = new_row
            survivors.append(r)
        self.rt = survivors
        self.S = len(survivors)

    def run(self, turn=None) -> List[SimResult]:
        """Every row to its end; results in row order. ``turn``, a lock
        (the async executor's host turn), is held for the run and given up
        while a device-to-host read waits. The run's wall seconds less its
        reads (and its waits to take the turn back) add to
        ``stats.compute_wall_s``."""
        t0 = time.perf_counter()
        read0, turn0 = self.stats.download_wall_s, self._turn_wait_s
        if turn is not None:
            turn.acquire()
            self._turn_wait_s += time.perf_counter() - t0
        self._turn = turn
        try:
            all_rt = list(self.rt)
            self.start()
            while self.step():
                pass
            final = self._download()
            for r in self.rt:
                r.archive = {k: v[r.index] for k, v in final.items()}
            self.stats.steps += sum(int(r.archive["n_events"]) for r in all_rt)
            self.stats.level_reuses += sum(int(r.archive["level_reuses"]) for r in all_rt)
            out = [self._result(r) for r in all_rt]
        finally:
            self._turn = None
            if turn is not None:
                turn.release()
        self.stats.compute_wall_s += (
            time.perf_counter() - t0 - (self.stats.download_wall_s - read0)
            - (self._turn_wait_s - turn0)
        )
        return out

    @staticmethod
    def _result(r: _PlanRuntime) -> SimResult:
        a = r.archive
        timeline = kernels.timeline_samples(
            a["tl_t"], a["tl_rate"], a["tl_len"], a["tl_stride"],
            a["tl_seen"], a["tl_last_t"], a["tl_last_rate"],
        )
        total_time = max(float(a["finish_t"]), _EPS)
        return SimResult(
            network=r.network,
            scheduler=r.scheduler,
            total_bytes=r.total_bytes,
            total_time=total_time,
            throughput=r.total_bytes / total_time,
            per_chunk_time={c: float(a["completed_at"][k]) for k, c in enumerate(r.chunks)},
            per_chunk_bytes={c: float(a["delivered"][k]) for k, c in enumerate(r.chunks)},
            timeline=timeline,
            n_events=int(a["n_events"]),
            n_moves=int(a["n_moves"]),
        )
