"""Discrete-event (fluid) transfer simulator and the per-scenario result.

:class:`Simulation` runs a scheduler (SC / MC / ProMC / a baseline)
against a :class:`NetworkSpec` without real I/O: channels pass through
per-file dead time (control gap, server processing, disk seek) and move
bytes at water-filled rates (:func:`netmodel.allocate_rates`). Rates are
recomputed at every event: a channel state change, a chunk completion, a
controller tick (every 5 s of simulated time by default) or a
bandwidth-profile step.

This is the yardstick the batched sweep
(:mod:`repro_torch.eval.fabric.driver`) is held to
(:mod:`repro_torch.eval.difftest`): a scalar host loop over Python
objects that runs no device code.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.eval.fabric.reference import next_event_dt, resume_file, tick_rate_update

from . import netmodel
from .schedulers import Close, ChunkView, Move, Open, Scheduler
from .types import Chunk, FileSpec, NetworkSpec, TransferParams

_EPS = 1e-12


@dataclasses.dataclass
class _SimChannel:
    chunk: int
    params: TransferParams
    dead: float = 0.0  # remaining serial overhead (setup / file start)
    file_remaining: float = 0.0  # bytes of the current file still to move
    busy: bool = False  # owns a file (in dead time or transferring)
    closed: bool = False

    @property
    def transferring(self) -> bool:
        return self.busy and self.dead <= _EPS and not self.closed


@dataclasses.dataclass
class _ChunkState:
    chunk: Chunk
    queue: Deque[FileSpec]
    queue_bytes: int  # exact bytes still in the queue (not yet pulled)
    delivered: float = 0.0
    delivered_at_last_tick: float = 0.0
    rate_estimate: float = 0.0
    done: bool = False
    completed_at: float = math.nan


@dataclasses.dataclass
class SimResult:
    network: str
    scheduler: str
    total_bytes: float
    total_time: float
    #: aggregate achieved throughput, bytes/s
    throughput: float
    per_chunk_time: Dict[str, float]
    per_chunk_bytes: Dict[str, float]
    timeline: List[tuple]  # (t, instantaneous aggregate rate)
    n_events: int
    n_moves: int

    @property
    def throughput_gbps(self) -> float:
        return self.throughput * 8.0 / 1e9


class Simulation:
    """One transfer task: a set of chunks driven by a Scheduler."""

    def __init__(
        self,
        chunks: Sequence[Chunk],
        network: NetworkSpec,
        scheduler: Scheduler,
        tick_period: float = 5.0,
        max_time: float = 48 * 3600.0,
        record_timeline: bool = False,
    ):
        self.network = network
        self.scheduler = scheduler
        self.tick_period = tick_period
        self.max_time = max_time
        self.record_timeline = record_timeline
        self.t = 0.0
        self.channels: List[_SimChannel] = []
        self.states = [
            _ChunkState(
                chunk=c,
                queue=collections.deque(c.files),
                queue_bytes=c.total_bytes,
            )
            for c in chunks
        ]
        self.timeline: List[tuple] = []
        self.n_events = 0
        self.n_moves = 0
        self._started = False
        #: a view is the costliest part of a tick: skip it for schedulers
        #: that keep the no-op ``on_tick`` (their empty action list makes
        #: the apply and feed after it no-ops, so no event changes)
        self._nontrivial_tick = type(scheduler).on_tick is not Scheduler.on_tick

    # ------------------------------------------------------------------ #
    # controller plumbing
    # ------------------------------------------------------------------ #

    def _bytes_remaining(self, i: int) -> float:
        """Queue bytes plus the remainders of files held by channels."""
        inflight = sum(
            ch.file_remaining
            for ch in self.channels
            if ch.chunk == i and ch.busy and not ch.closed
        )
        return self.states[i].queue_bytes + inflight

    def _view(self) -> List[ChunkView]:
        views = []
        for i, st in enumerate(self.states):
            n_ch = sum(1 for ch in self.channels if ch.chunk == i and not ch.closed)
            predicted = netmodel.predict_chunk_rate(
                self.network,
                max(st.chunk.avg_file_size, 1.0),
                st.chunk.params,
                max(n_ch, 1),
                total_active_channels=max(1, self._n_open()),
            )
            views.append(
                ChunkView(
                    index=i,
                    ctype=st.chunk.ctype,
                    bytes_remaining=self._bytes_remaining(i),
                    files_remaining=len(st.queue)
                    + sum(
                        1
                        for ch in self.channels
                        if ch.chunk == i and ch.busy and not ch.closed
                    ),
                    throughput=st.rate_estimate,
                    n_channels=n_ch,
                    done=st.done,
                    predicted_rate=predicted,
                )
            )
        return views

    def _n_open(self) -> int:
        return sum(1 for ch in self.channels if not ch.closed)

    def _apply(self, actions) -> None:
        for act in actions:
            if isinstance(act, Open):
                for _ in range(act.n):
                    self._open_channel(act.chunk, prev=None)
            elif isinstance(act, Close):
                self._close_channels(act.chunk, act.n)
            elif isinstance(act, Move):
                moved = self._close_channels(act.src, act.n)
                for prev in moved:
                    self._open_channel(act.dst, prev=prev)
                self.n_moves += len(moved)

    def _open_channel(self, chunk: int, prev: Optional[TransferParams]) -> None:
        params = self.states[chunk].chunk.params
        setup = netmodel.channel_open_cost(self.network, params, prev)
        self.channels.append(_SimChannel(chunk=chunk, params=params, dead=setup))

    def _close_channels(self, chunk: int, n: int) -> List[TransferParams]:
        """Close up to n channels of a chunk, idle ones first. In-flight
        files go back to the front of the chunk's queue (the remainder
        restarts)."""
        closed: List[TransferParams] = []
        candidates = sorted(
            (ch for ch in self.channels if ch.chunk == chunk and not ch.closed),
            key=lambda ch: ch.busy,  # idle first
        )
        for ch in candidates[:n]:
            if ch.busy and ch.file_remaining > 0:
                st = self.states[ch.chunk]
                f = resume_file(ch.file_remaining)
                st.queue.appendleft(f)
                st.queue_bytes += f.size
            ch.closed = True
            ch.busy = False
            closed.append(ch.params)
        self.channels = [c for c in self.channels if not c.closed]
        return closed

    # ------------------------------------------------------------------ #
    # event loop
    # ------------------------------------------------------------------ #

    def _feed_channels(self) -> None:
        """Idle channels pull the next file of their chunk (paying dead time)."""
        for ch in self.channels:
            if ch.closed or ch.busy:
                continue
            st = self.states[ch.chunk]
            if st.queue:
                f = st.queue.popleft()
                st.queue_bytes -= f.size
                ch.busy = True
                ch.file_remaining = float(f.size)
                ch.dead += netmodel.file_start_dead_time(self.network, ch.params)

    def _check_completions(self) -> List[int]:
        completed = []
        for i, st in enumerate(self.states):
            if st.done:
                continue
            busy = any(
                ch.busy for ch in self.channels if ch.chunk == i and not ch.closed
            )
            if not st.queue and not busy:
                st.done = True
                st.queue_bytes = 0
                st.completed_at = self.t
                completed.append(i)
        return completed

    @property
    def done(self) -> bool:
        return all(st.done for st in self.states)

    def start(self) -> None:
        """Record totals, apply the controller's initial allocation, feed."""
        self._total_bytes = float(sum(st.queue_bytes for st in self.states))
        self._next_tick = self.tick_period
        self._started = True
        self._apply(self.scheduler.initial_actions(self._view()))
        self._feed_channels()

    def transfer_demand(self) -> tuple:
        """``(pool, demand)`` of this instant: ``pool`` the uncoupled rate
        pool (link bandwidth against the disk aggregate, as
        ``allocate_rates`` takes it), ``demand`` the rate the transfer
        could use, ``min(pool, sum of the transferring channels' caps)``."""
        transferring = [ch for ch in self.channels if not ch.closed and ch.transferring]
        if not transferring:
            return 0.0, 0.0
        pool = min(
            self.network.bandwidth_at(self.t),
            self.network.disk.aggregate_rate(len(transferring)),
        )
        caps = sum(
            netmodel.channel_rate_cap(self.network, ch.params.parallelism)
            for ch in transferring
        )
        return pool, min(pool, caps)

    def _rates(self, open_chs, bandwidth: Optional[float]) -> List[float]:
        return netmodel.allocate_rates(
            self.network,
            [ch.params.parallelism for ch in open_chs],
            [ch.transferring for ch in open_chs],
            bandwidth=self.network.bandwidth_at(self.t) if bandwidth is None else bandwidth,
        )

    def _horizon(self, open_chs, rates) -> float:
        # a bandwidth-profile step is an event: rates change there, so it
        # caps the horizon like the controller tick
        busy = [ch for ch in open_chs if ch.busy]
        return next_event_dt(
            min(
                self._next_tick - self.t,
                self.network.next_profile_change(self.t) - self.t,
            ),
            [ch.dead for ch in busy],
            [ch.file_remaining for ch in busy],
            [r for ch, r in zip(open_chs, rates) if ch.busy],
        )

    def next_dt(self, bandwidth: Optional[float] = None) -> float:
        """The horizon :meth:`step` would advance by, without advancing;
        ``bandwidth`` overrides the rate pool as in :meth:`step`."""
        open_chs = [ch for ch in self.channels if not ch.closed]
        return self._horizon(open_chs, self._rates(open_chs, bandwidth))

    def step(
        self,
        max_dt: Optional[float] = None,
        bandwidth: Optional[float] = None,
    ) -> None:
        """Advance to the next event (state change, completion or tick).

        Rates are recomputed from scratch, the horizon comes from
        ``next_event_dt``, and the transitions after the advance run in a
        fixed order: feed, then each completion's callback (each followed
        by a feed), then the tick. The batched driver
        (``eval.fabric.driver.TorchFabricSimulation``) keeps this order.
        ``bandwidth`` replaces the rate pool and ``max_dt`` caps the
        horizon; the defaults leave the transfer uncoupled.
        """
        if not self._started:
            raise RuntimeError("Simulation.step() before start()")
        if self.t > self.max_time:
            raise RuntimeError(
                f"simulation exceeded max_time={self.max_time}s "
                f"(t={self.t:.1f}); remaining="
                f"{[self._bytes_remaining(i) for i in range(len(self.states))]}"
            )
        self.n_events += 1
        open_chs = [ch for ch in self.channels if not ch.closed]
        rates = self._rates(open_chs, bandwidth)
        if self.record_timeline:
            self.timeline.append((self.t, sum(rates)))

        dt = self._horizon(open_chs, rates)
        if max_dt is not None:
            dt = min(dt, max_dt)
        if not any(ch.busy for ch in open_chs):
            # no channel holds work: either every chunk is done (the loop
            # exits) or the scheduler stranded a live chunk
            live = [i for i, st in enumerate(self.states) if not st.done]
            held = {ch.chunk for ch in open_chs}
            if any(i not in held for i in live):
                raise RuntimeError(
                    f"scheduler {self.scheduler.name} stranded chunks "
                    f"{[self.states[i].chunk.name for i in live]}"
                )

        # advance
        self.t += dt
        for ch, r in zip(open_chs, rates):
            if ch.closed or not ch.busy:
                continue
            if ch.dead > _EPS:
                ch.dead = max(0.0, ch.dead - dt)
                continue
            if r > _EPS and dt > 0:
                moved = min(ch.file_remaining, r * dt)
                ch.file_remaining -= moved
                self.states[ch.chunk].delivered += moved
            if ch.file_remaining <= _EPS:
                ch.busy = False
                ch.file_remaining = 0.0

        self._feed_channels()
        for cid in self._check_completions():
            self._apply(self.scheduler.on_chunk_complete(self._view(), cid))
            self._feed_channels()

        if self.t >= self._next_tick - _EPS:
            # measured per-chunk rates over the last period
            for st in self.states:
                delta = st.delivered - st.delivered_at_last_tick
                st.delivered_at_last_tick = st.delivered
                st.rate_estimate = tick_rate_update(st.rate_estimate, delta, self.tick_period)
            if self._nontrivial_tick:
                self._apply(self.scheduler.on_tick(self._view()))
                self._feed_channels()
            self._next_tick += self.tick_period

    def result(self) -> SimResult:
        if not self._started:
            raise RuntimeError("Simulation.result() before start()")
        total_time = max(self.t, _EPS)
        return SimResult(
            network=self.network.name,
            scheduler=self.scheduler.name,
            total_bytes=self._total_bytes,
            total_time=total_time,
            throughput=self._total_bytes / total_time,
            per_chunk_time={st.chunk.name: st.completed_at for st in self.states},
            per_chunk_bytes={st.chunk.name: st.delivered for st in self.states},
            timeline=self.timeline,
            n_events=self.n_events,
            n_moves=self.n_moves,
        )

    def run(self) -> SimResult:
        self.start()
        while not self.done:
            self.step()
        return self.result()
