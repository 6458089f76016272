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

A sweep is :meth:`_advance` (rates, horizon, fluid byte movement) then
:meth:`_post` (feed, chunk completions, controller tick, scenario done).
While no resume file exists in the batch, sweeps take a fused route:

* ``fused_step="rounds"`` (the default): one launch of the fused-rounds
  CUDA kernel per host round. Each row takes steps on the card (rates +
  horizon + advance + feed, the profile lookup, the clock, the event
  count, the ``delivered`` scatter and the tick EMA) until the host has
  something to decide, a chunk completion, a ProMC tick, no busy channel,
  a timeline sample, ``max_time`` or :data:`ROUND_CAP` steps; then
  :meth:`_post` runs once for every row's last step. Every row's event
  sequence is the one-step route's: scenarios are independent.
* ``fused_step="kernel"``: one launch of the one-step fused kernel per
  sweep, then :meth:`_post`.

Sweeps with resume files, and every sweep under ``fused_step="none"``,
take the split path, whose water-fill is the bisected CUDA kernel
(``waterfill_impl="kernel"``) or the sort-based closed form
(``"closed"``). On the CPU the same routes run the kernels' plain PyTorch
versions. The SC / MC / ProMC controllers run as masked tensor code
batched over S; the host reads back a few flags per round (which paths
to take, whether a row broke its limits) and nothing per row.

Only the built-in controllers of a plan are supported; custom scheduler
rows and coupled shared-fabric rows raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.simulator import SimResult

from . import controllers, kernels
from .bucketing import COMPACT_FLOOR, PROFILE_PAD_FLOOR, bucket, qsizes_pad
from .kernels.fused_step import ROUND_CAP, ROUND_OPERANDS, fused_rounds, fused_step
from .kernels.waterfill_bisect import waterfill_bisect
from .plan import PLAN_C_FLOOR, PLAN_PROFILED_C_FLOOR
from .shim import NO_CHUNK, TorchOps

_EPS = 1e-12

#: controller kinds (plan rows carry no custom schedulers)
KIND_TRIVIAL, KIND_STATIC, KIND_SC, KIND_MC, KIND_PROMC = 0, 1, 2, 3, 4

#: default scenario wall-clock guard (seconds of simulated time)
_DEFAULT_MAX_TIME = 48 * 3600.0

#: timeline samples kept per recording scenario (uniform-stride
#: decimation past it)
TIMELINE_BUDGET = 512

FUSED_STEP_OPTIONS = ("none", "kernel", "rounds")
WATERFILL_OPTIONS = ("closed", "kernel")

#: every per-scenario row tensor, for compaction
_ROW_ARRAYS = (
    "t", "done", "next_tick", "tick_period", "n_events", "finish_t",
    "fin_any", "max_time", "record_timeline", "trivial_complete", "kind",
    "bw", "disk_rate", "sat_cc", "contention", "n_chunks", "chunk_of",
    "dead", "rem", "busy", "cap", "chunk_done", "completed_at",
    "delivered", "delivered_at_tick", "rate_est", "queue_bytes", "fsdt",
    "qoff", "qlen", "qptr", "prepend_n", "prepend_sizes", "streak",
    "pair_fast", "pair_slow", "promc_ratio", "promc_patience", "sc_cursor",
    "sc_order", "conc", "par", "cap_k", "avg_fs_k", "nfiles", "setup_cost",
    "n_moves", "prof_t", "prof_mult", "tl_t", "tl_rate", "tl_len",
    "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate", "steps", "rate_sum",
    "t0",
)

#: per-row results read back when a row retires
_RESULT_ARRAYS = (
    "finish_t", "n_events", "completed_at", "delivered", "n_moves", "tl_t",
    "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate",
)


@dataclasses.dataclass
class SweepStats:
    """What one driver did: host rounds (``sweeps``) by route, host reads
    of device values (each one waits for the device), and row steps taken
    on the device (``steps``, the sum of the rows' event counts; on the
    ``"rounds"`` route a round takes many)."""

    sweeps: int = 0
    fused: int = 0
    split: int = 0
    host_syncs: int = 0
    steps: int = 0


class _PlanRuntime:
    """Host-side per-scenario metadata: names for results and errors, the
    byte total, and the final metrics once the row has retired."""

    __slots__ = (
        "index", "name", "network", "scheduler", "chunks", "total_bytes",
        "archive",
    )

    def __init__(self, index, name, network, scheduler, chunks, total_bytes):
        self.index = index
        self.name = name
        self.network = network
        self.scheduler = scheduler
        self.chunks = chunks
        self.total_bytes = total_bytes
        self.archive = None


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
        if (np.asarray(plan.kind) < KIND_TRIVIAL).any():
            raise NotImplementedError("custom scheduler rows are not supported")
        self.device = resolve_device(device)
        self.fused_step = fused_step
        self.waterfill_impl = waterfill_impl
        self.stats = SweepStats()
        self._started = False
        self._init_from_plan(plan)

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
        self.rt = [
            _PlanRuntime(
                i, plan.names[i], nets[ni[i]].name, plan.sched_names[i],
                plan.chunk_names[i], float(plan.total_bytes[i]),
            )
            for i in range(S)
        ]

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
            "max_time": (np.full(S, _DEFAULT_MAX_TIME), f8),
            "record_timeline": (record, b1),
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
            "promc_ratio": (np.full(S, 2.0), f8),
            "promc_patience": (np.full(S, 3, dtype=np.int64), i8),
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
            # the last fused-rounds launch: steps, last rate sum and start
            "steps": (np.zeros(S, dtype=np.int64), i8),
            "rate_sum": (np.zeros(S), f8),
            "t0": (np.zeros(S), f8),
        }
        for name, (arr, dtype) in host.items():
            setattr(self, name, self._up(arr, dtype))

    def _up(self, arr, dtype) -> torch.Tensor:
        """A new device tensor (never a view of the plan's arrays: the
        fused-rounds kernel updates state in place)."""
        return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ #
    # host reads
    # ------------------------------------------------------------------ #

    def _read(self, t: torch.Tensor) -> list:
        """One host read of a small device tensor (waits for the device)."""
        self.stats.host_syncs += 1
        return t.tolist()

    # ------------------------------------------------------------------ #
    # capacity growth (the pre-sized axes make these rare)
    # ------------------------------------------------------------------ #

    def _grow(self) -> None:
        """Double the channel axis C with empty columns."""
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
        their first files. Idempotent."""
        if self._started:
            return
        self._started = True
        self._feed(torch.ones(self.S, dtype=torch.bool, device=self.device))

    def step(self) -> bool:
        """One host round over the live rows: a synchronized sweep, or on
        the ``"rounds"`` route each row's steps up to its next host
        decision. Returns False once every row is done. One host read
        decides the route, compaction and whether any row exceeded
        ``max_time`` or stranded a chunk."""
        act = ~self.done
        over = act & (self.t > self.max_time)
        stranded = self._stranded(act)
        n_act, n_pre, n_over, n_str = self._read(
            torch.stack(
                [act.sum(), (self.prepend_n > 0).sum(), over.sum(), stranded.sum()]
            )
        )
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
        # amortized compaction: rebuild once half of a wide batch is done
        if self.S > COMPACT_FLOOR and (self.S - n_act) * 2 >= self.S:
            self._compact(act)
            act = ~self.done
        self.stats.sweeps += 1
        if self.fused_step == "rounds" and n_pre == 0:
            self.stats.fused += 1
            self._advance_rounds(act)  # counts the rows' events itself
            self._post(act, skip_feed=True)
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

    def _stranded(self, act):
        """Rows with no busy channel and a live chunk that holds no channel
        (a scheduler fault)."""
        no_busy = act & ~self.busy.any(dim=-1)
        held = TorchOps.count_by_chunk(self.chunk_of, self.chunk_of != NO_CHUNK, self.K) > 0
        return no_busy & (~self.chunk_done & ~held).any(dim=-1)

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
        """Split physics half of a sweep: rates, horizon, fluid movement."""
        transferring = self.busy & (self.dead <= _EPS)
        eff_bw, next_prof = self._bandwidth_now()
        pool = kernels.disk_pool(
            transferring.sum(dim=-1), eff_bw, self.disk_rate, self.sat_cc,
            self.contention,
        )
        caps = torch.where(transferring, self.cap, 0.0)
        rates = torch.where(act.unsqueeze(-1), self._waterfill(caps, pool), 0.0)
        if self._any_record:
            self._record(act, rates.sum(dim=-1))
        dt = kernels.event_horizon(
            torch.minimum(self.next_tick - self.t, next_prof - self.t),
            self.busy, self.dead, transferring, self.rem, rates,
        )
        dt = torch.where(act, dt, 0.0)
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
        """The fused-rounds kernel's operands: the driver's own state
        tensors by name (updated in place by a launch), with ``act``."""
        s = {name: getattr(self, name) for name in ROUND_OPERANDS if name != "act"}
        s["act"] = act
        return s

    def _advance_rounds(self, act) -> None:
        """Each row of ``act`` steps on the card up to its next host
        decision (resume-free batches only); the timeline sample of a
        recording row's single step is pushed here."""
        fused_rounds(self.round_operands(act), ROUND_CAP)
        if self._any_record:
            self._record(act, self.rate_sum, self.t0)

    def _feed(self, enabled) -> None:
        """Idle channels of ``enabled`` rows pull their next file (resume
        stack first, then FIFO)."""
        (
            self.busy, self.dead, self.rem, self.qptr, self.queue_bytes,
            self.prepend_n,
        ) = kernels.feed_queues(
            enabled, self.chunk_of, self.busy, self.dead, self.rem,
            self.qsizes, self.qoff, self.qlen, self.qptr, self.queue_bytes,
            self.fsdt, self.prepend_sizes, self.prepend_n,
        )

    def _mark_complete(self, m) -> None:
        self.chunk_done = self.chunk_done | m
        self.queue_bytes = torch.where(m, 0.0, self.queue_bytes)
        self.completed_at = torch.where(m, self.t.unsqueeze(-1), self.completed_at)

    def _post(self, act, skip_feed: bool = False) -> None:
        """Transition half of a sweep: feed -> completions -> tick -> done
        (``skip_feed`` on the fused route, whose kernel fed already)."""
        if not skip_feed:
            self._feed(act)

        # a chunk completes once no file is left and none is in flight
        busy_per_chunk = TorchOps.count_by_chunk(self.chunk_of, self.busy, self.K)
        files_left = self.qlen - self.qptr + self.prepend_n
        completed = (
            act.unsqueeze(-1) & ~self.chunk_done & (files_left == 0)
            & (busy_per_chunk == 0)
        )
        comp_rows = completed.any(dim=-1)
        tick_hit = act & (self.t >= self.next_tick - _EPS)
        # baselines: pure bookkeeping
        self._mark_complete(completed & self.trivial_complete.unsqueeze(-1))
        ctrl = completed & (self.kind >= KIND_SC).unsqueeze(-1)
        is_sc = self.kind == KIND_SC
        is_mc = (self.kind == KIND_MC) | (self.kind == KIND_PROMC)
        promc_tick = tick_hit & (self.kind == KIND_PROMC)
        flags = self._read(
            torch.cat([
                (ctrl & is_sc.unsqueeze(-1)).any(dim=0),
                (ctrl & is_mc.unsqueeze(-1)).any(dim=0),
                tick_hit.any().unsqueeze(0),
                promc_tick.any().unsqueeze(0),
            ])
        )
        K = self.K
        sc_k, mc_k = flags[:K], flags[K: 2 * K]
        if any(sc_k) or any(mc_k):
            self._complete_ctrl(ctrl, sc_k, mc_k, is_sc, is_mc)
        if flags[2 * K]:
            ema = kernels.tick_ema(
                self.rate_est, self.delivered, self.delivered_at_tick,
                self.tick_period.unsqueeze(-1),
            )
            rows = tick_hit.unsqueeze(-1)
            self.rate_est = torch.where(rows, ema, self.rate_est)
            self.delivered_at_tick = torch.where(rows, self.delivered, self.delivered_at_tick)
            if flags[2 * K + 1]:
                self._tick_ctrl(promc_tick)
            self.next_tick = self.next_tick + torch.where(tick_hit, self.tick_period, 0.0)

        newly = act & self.chunk_done.all(dim=-1) & (self.fin_any | comp_rows)
        self.finish_t = torch.where(newly, self.t, self.finish_t)
        self.done = self.done | newly

    # ------------------------------------------------------------------ #
    # batched controller dispatch (SC / MC / ProMC rows)
    # ------------------------------------------------------------------ #

    def _view_arrays(self):
        """Batched chunk views: (S, K) remaining bytes, channel counts and
        ETAs for the controller kernels."""
        open_mask = self.chunk_of != NO_CHUNK
        n_ch = TorchOps.count_by_chunk(self.chunk_of, open_mask, self.K)
        inflight = TorchOps.chunk_scatter_add(
            torch.zeros_like(self.queue_bytes), self.chunk_of, self.rem,
            open_mask & self.busy,
        )
        bytes_rem = self.queue_bytes + inflight
        pred = controllers.predicted_chunk_rate(
            self.avg_fs_k, self.cap_k, self.fsdt, n_ch, open_mask.sum(dim=-1),
            self.bw, self.disk_rate, self.sat_cc, self.contention,
        )
        eta = controllers.chunk_eta(bytes_rem, self.rate_est, pred, self.chunk_done)
        return bytes_rem, n_ch, eta

    def _complete_ctrl(self, m, sc_k, mc_k, is_sc, is_mc) -> None:
        """Chunk completions on controller rows: mark every completed chunk,
        then run each chunk's completion handler in index order (lowest
        first) with a re-feed after each, as the event loop orders them."""
        rows = m.any(dim=-1)
        self._mark_complete(m)
        # ProMC drops its streak evidence on any completion
        pr = rows & (self.kind == KIND_PROMC)
        self.streak = torch.where(pr, 0, self.streak)
        self.pair_fast = torch.where(pr, -1, self.pair_fast)
        self.pair_slow = torch.where(pr, -1, self.pair_slow)
        for k in range(self.K):
            if not (sc_k[k] or mc_k[k]):
                continue
            trig = m[:, k]
            fed = torch.zeros_like(trig)
            short = torch.zeros((), dtype=torch.bool, device=self.device)
            freed = torch.zeros_like(self.n_moves)
            if sc_k[k]:
                sc_t = trig & is_sc
                n_open, nxt = self._sc_close(sc_t, k)
                short = ((self.chunk_of == NO_CHUNK).sum(dim=-1) < n_open).any()
                fed = fed | sc_t
            if mc_k[k]:
                mc_t = trig & is_mc
                bytes_rem, n_ch, eta = self._view_arrays()
                freed = torch.where(mc_t, n_ch[:, k], 0)
            grow, max_iters = self._read(torch.stack([short.to(torch.int64), freed.max()]))
            if sc_k[k]:
                while grow:
                    self._grow()
                    grow = self._read(((self.chunk_of == NO_CHUNK).sum(dim=-1) < n_open).any())
                self.chunk_of, self.dead, self.cap = controllers.open_ranked(
                    n_open, nxt, self.chunk_of, self.dead, self.cap,
                    self.setup_cost, self.cap_k,
                )
            if mc_k[k] and max_iters > 0:
                fed = fed | self._laggard_grant(mc_t, k, bytes_rem, n_ch, eta, freed, max_iters)
            self._feed(fed)

    def _sc_close(self, trig, k: int):
        """SC's completion handler, first half: close the finished chunk's
        channels and advance the cursor past empty size classes. Returns
        how many channels the next chunk opens, and which chunk."""
        (
            self.chunk_of, self.busy, self.dead, self.rem, self.cap,
        ) = controllers.close_chunk(
            trig, k, self.chunk_of, self.busy, self.dead, self.rem, self.cap
        )
        self.sc_cursor = controllers.sc_advance_cursor(
            trig, self.sc_cursor, self.sc_order, self.nfiles, self.n_chunks
        )
        open_ok = trig & (self.sc_cursor < self.n_chunks)
        nxt = torch.gather(
            self.sc_order, -1, torch.clamp(self.sc_cursor, 0, self.K - 1).unsqueeze(-1)
        ).squeeze(-1)
        n_open = torch.where(
            open_ok, torch.gather(self.conc, -1, nxt.unsqueeze(-1)).squeeze(-1), 0
        )
        return n_open, nxt

    def _laggard_grant(self, trig, k, bytes_rem, n_ch, eta, freed, max_iters):
        """MC / ProMC completion handler: re-target the freed channels to
        the largest-ETA chunks. Returns the rows that acted (and re-feed);
        with no live receiver a row emits no action at all."""
        ks = torch.arange(self.K, dtype=torch.int64, device=self.device)
        live = ~self.chunk_done & (ks != k) & (bytes_rem > 0)
        grants, first = controllers.laggard_grants(eta, n_ch, live, freed, max_iters)
        acted = trig & (grants.sum(dim=-1) > 0)
        (
            self.chunk_of, self.busy, self.dead, self.rem, self.cap,
            self.n_moves,
        ) = controllers.apply_grants(
            acted, k, grants, first, self.chunk_of, self.busy, self.dead,
            self.rem, self.cap, self.n_moves, self.par, self.cap_k,
            self.setup_cost,
        )
        return acted

    def _tick_ctrl(self, rows) -> None:
        """ProMC periodic check on ``rows``: streak update and, on patience
        expiry, one fast->slow channel move (a busy victim pushes its
        remainder on the resume stack)."""
        bytes_rem, n_ch, eta = self._view_arrays()
        live = ~self.chunk_done & (bytes_rem > 0)
        streak, pf, ps, move, src, dst = controllers.promc_tick(
            eta, self.rate_est, n_ch, live, self.streak, self.pair_fast,
            self.pair_slow, self.promc_ratio, self.promc_patience,
        )
        self.streak = torch.where(rows, streak, self.streak)
        self.pair_fast = torch.where(rows, pf, self.pair_fast)
        self.pair_slow = torch.where(rows, ps, self.pair_slow)
        moving = rows & move
        full, any_move = self._read(
            torch.stack([(self.prepend_n >= self.P).any(), moving.any()])
        )
        # keep a free stack slot on every chunk, even on no-move ticks
        while full:
            self._grow_prepend()
            full = self._read((self.prepend_n >= self.P).any())
        if not any_move:
            return
        (
            self.chunk_of, self.busy, self.dead, self.rem, self.cap,
            self.queue_bytes, self.prepend_sizes, self.prepend_n,
            self.n_moves,
        ) = controllers.move_channel(
            moving, src, dst, self.chunk_of, self.busy, self.dead, self.rem,
            self.cap, self.queue_bytes, self.prepend_sizes, self.prepend_n,
            self.n_moves, self.par, self.cap_k, self.setup_cost,
        )
        self._feed(moving)

    # ------------------------------------------------------------------ #
    # live-row compaction and results
    # ------------------------------------------------------------------ #

    def _download(self, rows=None) -> dict:
        """Result columns of ``rows`` (default: all) as numpy arrays."""
        out = {}
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

    def run(self) -> List[SimResult]:
        all_rt = list(self.rt)
        self.start()
        while self.step():
            pass
        final = self._download()
        for r in self.rt:
            r.archive = {k: v[r.index] for k, v in final.items()}
        self.stats.steps += sum(int(r.archive["n_events"]) for r in all_rt)
        return [self._result(r) for r in all_rt]

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
