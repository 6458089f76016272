"""Real threaded TransferEngine — the paper's algorithms over actual I/O.

The simulator proves schedule *quality*; this engine proves the algorithms
are a real, runnable system. It drives the same Scheduler controllers (the
scalar facade of :mod:`.schedulers` over the torch decision kernels) with
OS threads:

  channel      = worker thread bound to a slot; a slot is (re)assigned to a
                 chunk by the controller (Move/Open/Close)
  pipelining   = per-channel command prefetch queue: the command latency
                 (control RTT) is paid by a background prefetcher instead of
                 blocking the data path (optionally injected for demos/tests)
  parallelism  = striped pread/pwrite of one file by p sub-threads
  concurrency  = number of live channel slots

Used by :mod:`repro_torch.checkpoint` (shard saves) and
:mod:`repro_torch.data.pipeline` (file ingestion). On a laptop-class CI box
the latency injection is what makes the paper's effects visible; with it
disabled the engine is simply a correct, concurrent, striped file mover.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import netmodel
from .schedulers import Close, ChunkView, Move, Open, Scheduler
from .types import Chunk, FileSpec, NetworkSpec, TransferParams

Reader = Callable[[int, int], bytes]  # (offset, length) -> data
Writer = Callable[[int, bytes], None]  # (offset, data) -> None


@dataclasses.dataclass
class TransferTask:
    """Concrete I/O endpoints for one FileSpec."""

    spec: FileSpec
    read: Reader
    write: Writer
    finalize: Optional[Callable[[], None]] = None


class _DstFd:
    """One destination fd for a TransferTask's lifetime.

    The old implementation reopened (and closed) the destination on every
    ``pwrite`` — per-block syscall churn that dominated small-block striped
    writes and defeated kernel write-behind. ``pwrite`` is positional and
    thread-safe on a shared fd, so the stripe sub-threads need no lock on
    the data path; the lock only guards lazy open and close.
    """

    __slots__ = ("path", "_fd", "_lock")

    def __init__(self, path: str):
        self.path = path
        self._fd = None
        self._lock = threading.Lock()

    def get(self) -> int:
        fd = self._fd
        if fd is None:
            with self._lock:
                if self._fd is None:
                    self._fd = os.open(
                        self.path, os.O_RDWR | os.O_CREAT, 0o644
                    )
                fd = self._fd
        return fd

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


def file_task(spec: FileSpec, src: str, dst: str) -> TransferTask:
    """Copy a real file src -> dst (dst created at first write; one fd held
    for the task's lifetime, released in ``finalize``)."""

    def read(offset: int, length: int) -> bytes:
        with open(src, "rb") as f:
            f.seek(offset)
            return f.read(length)

    out = _DstFd(dst)

    def write(offset: int, data: bytes) -> None:
        os.pwrite(out.get(), data, offset)

    return TransferTask(spec=spec, read=read, write=write, finalize=out.close)


def bytes_task(
    spec: FileSpec, data: bytes, dst: str
) -> TransferTask:
    """Write an in-memory payload (e.g. a checkpoint shard) to dst. ``data``
    is bytes or any object whose ``[a:b]`` gives a buffer ``os.pwrite``
    takes (a memoryview, a checkpoint's ``.npy`` file)."""

    def read(offset: int, length: int) -> bytes:
        return data[offset : offset + length]

    out = _DstFd(dst)

    def write(offset: int, chunk: bytes) -> None:
        os.pwrite(out.get(), chunk, offset)

    return TransferTask(spec=spec, read=read, write=write, finalize=out.close)


@dataclasses.dataclass
class EngineReport:
    scheduler: str
    total_bytes: int
    total_time: float
    throughput: float
    per_chunk_bytes: Dict[str, int]
    n_moves: int
    files_done: int


class _Slot:
    """One channel slot: assignment is mutated by the controller thread."""

    def __init__(self, slot_id: int, chunk: int, params: TransferParams):
        self.id = slot_id
        self.chunk = chunk
        self.params = params
        self.alive = True
        self.lock = threading.Lock()

    def assignment(self):
        with self.lock:
            return self.chunk, self.params, self.alive

    def reassign(self, chunk: int, params: TransferParams):
        with self.lock:
            self.chunk, self.params = chunk, params

    def kill(self):
        with self.lock:
            self.alive = False


class TransferEngine:
    """Execute chunks' TransferTasks under a Scheduler controller."""

    STRIPE_MIN = 4 * 1024 * 1024  # don't stripe files below 4 MB
    IO_BLOCK = 1024 * 1024

    def __init__(
        self,
        network: NetworkSpec,
        tick_period: float = 0.25,
        inject_latency: bool = False,
        latency_scale: float = 1.0,
    ):
        self.network = network
        self.tick_period = tick_period
        self.inject_latency = inject_latency
        self.latency_scale = latency_scale

    # ------------------------------------------------------------------ #

    def run(
        self,
        chunks: Sequence[Chunk],
        scheduler: Scheduler,
        tasks: Dict[str, TransferTask],
    ) -> EngineReport:
        queues: List[collections.deque] = [
            collections.deque(c.files) for c in chunks
        ]
        qlocks = [threading.Lock() for _ in chunks]
        delivered = [0 for _ in chunks]  # bytes, guarded by stats_lock
        inflight = [0 for _ in chunks]
        done_files = [0]
        stats_lock = threading.Lock()
        completed = [False for _ in chunks]
        rate_window: List[collections.deque] = [
            collections.deque(maxlen=8) for _ in chunks
        ]
        slots: List[_Slot] = []
        slots_lock = threading.Lock()
        threads: List[threading.Thread] = []
        stop = threading.Event()
        errors: List[BaseException] = []
        n_moves = [0]

        def pull(chunk_idx: int) -> Optional[FileSpec]:
            with qlocks[chunk_idx]:
                if queues[chunk_idx]:
                    f = queues[chunk_idx].popleft()
                    with stats_lock:
                        inflight[chunk_idx] += 1
                    return f
            return None

        def transfer_one(f: FileSpec, params: TransferParams, chunk_idx: int):
            task = tasks[f.name]
            if self.inject_latency:
                # control-channel gap amortized by pipelining depth (uses
                # the control RTT on asymmetric paths, like the simulator)
                gap = netmodel.control_gap(self.network, params)
                time.sleep((gap + self.network.unhidden_overhead) * self.latency_scale)
            size = f.size
            p = params.parallelism if size >= self.STRIPE_MIN else 1
            if p <= 1:
                off = 0
                while off < size:
                    blk = min(self.IO_BLOCK, size - off)
                    task.write(off, task.read(off, blk))
                    off += blk
                    with stats_lock:
                        delivered[chunk_idx] += blk
            else:
                stripe = (size + p - 1) // p

                def stripe_worker(start: int, end: int):
                    off = start
                    while off < end:
                        blk = min(self.IO_BLOCK, end - off)
                        task.write(off, task.read(off, blk))
                        off += blk
                        with stats_lock:
                            delivered[chunk_idx] += blk

                subs = []
                for s in range(p):
                    a, b = s * stripe, min(size, (s + 1) * stripe)
                    if a >= b:
                        continue
                    th = threading.Thread(target=stripe_worker, args=(a, b))
                    th.start()
                    subs.append(th)
                for th in subs:
                    th.join()
            if task.finalize:
                task.finalize()
            with stats_lock:
                inflight[chunk_idx] -= 1
                done_files[0] += 1

        def worker(slot: _Slot):
            try:
                while not stop.is_set():
                    chunk_idx, params, alive = slot.assignment()
                    if not alive:
                        return
                    f = pull(chunk_idx)
                    if f is None:
                        time.sleep(0.005)
                        continue
                    transfer_one(f, params, chunk_idx)
            except BaseException as e:  # surface worker failures to caller
                errors.append(e)
                stop.set()

        next_slot_id = [0]

        def apply(actions):
            for act in actions:
                if isinstance(act, Open):
                    for _ in range(act.n):
                        s = _Slot(
                            next_slot_id[0],
                            act.chunk,
                            chunks[act.chunk].params,
                        )
                        next_slot_id[0] += 1
                        with slots_lock:
                            slots.append(s)
                        th = threading.Thread(target=worker, args=(s,), daemon=True)
                        threads.append(th)
                        th.start()
                elif isinstance(act, Close):
                    with slots_lock:
                        victims = [s for s in slots if s.chunk == act.chunk][: act.n]
                        for s in victims:
                            s.kill()
                            slots.remove(s)
                elif isinstance(act, Move):
                    with slots_lock:
                        movable = [s for s in slots if s.chunk == act.src][: act.n]
                        for s in movable:
                            s.reassign(act.dst, chunks[act.dst].params)
                            n_moves[0] += 1

        def view() -> List[ChunkView]:
            with stats_lock, slots_lock:
                views = []
                for i, c in enumerate(chunks):
                    remaining = c.total_bytes - delivered[i]
                    rate = (
                        sum(rate_window[i]) / (len(rate_window[i]) * self.tick_period)
                        if rate_window[i]
                        else 0.0
                    )
                    views.append(
                        ChunkView(
                            index=i,
                            ctype=c.ctype,
                            bytes_remaining=max(0, remaining),
                            files_remaining=len(queues[i]) + inflight[i],
                            throughput=rate,
                            n_channels=sum(1 for s in slots if s.chunk == i),
                            done=completed[i],
                            predicted_rate=1.0,  # engine always has measurements fast
                        )
                    )
                return views

        t0 = time.monotonic()
        apply(scheduler.initial_actions(view()))
        last_delivered = [0 for _ in chunks]

        try:
            while not stop.is_set():
                time.sleep(self.tick_period)
                if errors:
                    break
                with stats_lock:
                    for i in range(len(chunks)):
                        rate_window[i].append(delivered[i] - last_delivered[i])
                        last_delivered[i] = delivered[i]
                # chunk completions
                for i, c in enumerate(chunks):
                    if completed[i]:
                        continue
                    with qlocks[i], stats_lock:
                        empty = not queues[i] and inflight[i] == 0
                    if empty:
                        completed[i] = True
                        apply(scheduler.on_chunk_complete(view(), i))
                if all(completed):
                    break
                apply(scheduler.on_tick(view()))
        finally:
            stop.set()
            for s in list(slots):
                s.kill()
            for th in threads:
                th.join(timeout=5.0)
        if errors:
            raise errors[0]

        total_time = max(time.monotonic() - t0, 1e-9)
        total_bytes = sum(delivered)
        return EngineReport(
            scheduler=scheduler.name,
            total_bytes=total_bytes,
            total_time=total_time,
            throughput=total_bytes / total_time,
            per_chunk_bytes={
                chunks[i].name: delivered[i] for i in range(len(chunks))
            },
            n_moves=n_moves[0],
            files_done=done_files[0],
        )
