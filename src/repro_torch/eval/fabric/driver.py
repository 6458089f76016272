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
  the host.
* ``fused_step="none"``: every sweep split, whose water-fill is the
  bisected CUDA kernel (``waterfill_impl="kernel"``) or the sort-based
  closed form (``"closed"``), then :meth:`_post`.

On the CPU the same routes run the kernels' plain PyTorch versions. The
controllers run as masked tensor code batched over S; the host reads back
a few flags per round (which paths to take, whether a row broke its
limits, which handlers and axes a host transition needs) and nothing per
row.

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

from . import kernels, transition
from .bucketing import COMPACT_FLOOR, PROFILE_PAD_FLOOR, bucket, qsizes_pad
from .kernels.fused_step import ROUND_CAP, ROUND_OPERANDS, fused_rounds, fused_step
from .kernels.waterfill_bisect import waterfill_bisect
from .plan import PLAN_C_FLOOR, PLAN_PROFILED_C_FLOOR
from .shim import NO_CHUNK, TorchOps
from .transition import KIND_TRIVIAL, STOP_GUARD, STOP_NONE

_EPS = 1e-12

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
    "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate", "steps", "stop",
)

#: per-row results read back when a row retires
_RESULT_ARRAYS = (
    "finish_t", "n_events", "completed_at", "delivered", "n_moves", "tl_t",
    "tl_rate", "tl_len", "tl_stride", "tl_seen", "tl_last_t", "tl_last_rate",
)


@dataclasses.dataclass
class SweepStats:
    """What one driver did: host rounds (``sweeps``) by route, host reads
    of device values (each one waits for the device), row steps taken on
    the device (``steps``, the sum of the rows' event counts; on the
    ``"rounds"`` route a round takes many), and rows whose loop stopped at
    a capacity guard and left a step's transition to the host
    (``host_transitions``; 0 wherever the plan's bounds size C and P)."""

    sweeps: int = 0
    fused: int = 0
    split: int = 0
    host_syncs: int = 0
    steps: int = 0
    host_transitions: int = 0


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
            # the last loop launch: each row's steps and stop code
            "steps": (np.zeros(S, dtype=np.int64), i8),
            "stop": (np.full(S, STOP_NONE, dtype=np.int64), i8),
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
        the ``"rounds"`` route one loop launch in which each row steps
        until it is done, errs, meets a capacity guard or takes
        :data:`ROUND_CAP` steps. Returns False once every row is done. One
        host read decides the route, compaction, whether any row exceeded
        ``max_time`` or stranded a chunk, and which rows a guard stopped
        (their pending transition runs here first)."""
        act = ~self.done
        pending = act & (self.stop == STOP_GUARD)
        chk = act & ~pending  # a pending row's state is mid-step
        over = chk & (self.t > self.max_time)
        stranded = transition.stranded(vars(self), chk)
        n_act, n_pre, n_over, n_str, n_pend = self._read(
            torch.stack([
                act.sum(), (self.prepend_n > 0).sum(), over.sum(), stranded.sum(),
                pending.sum(),
            ])
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
        if n_pend:
            self.stats.host_transitions += n_pend
            self._post(pending, skip_feed=True)
            self.stop = torch.where(pending, STOP_NONE, self.stop)
            act = ~self.done
        # amortized compaction: rebuild once half of a wide batch is done
        if self.S > COMPACT_FLOOR and (self.S - n_act) * 2 >= self.S:
            self._compact(act)
            act = ~self.done
        self.stats.sweeps += 1
        if self.fused_step == "rounds":
            self.stats.fused += 1
            # counts the rows' events and takes their transitions itself
            fused_rounds(self.round_operands(act), ROUND_CAP)
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
        transition.post_transition(s, act, completed, tick_hit, **hint)

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
