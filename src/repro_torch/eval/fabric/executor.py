"""Overlap-pipelined chunk executor for the batched sweeps.

A serial chunk loop builds a chunk's driver on the host (its plan, its
host columns, their upload), runs it, reads its results back, and only
then builds the next: the host waits while the card runs and the card
idles while the host builds. :func:`execute_chunks` can overlap the two:

* **prep workers** (one a device slot) claim chunk indices from a shared
  cursor and build each chunk's driver; chunk ``j`` goes to device
  ``j % n_devices``;
* **one compute worker per device** drains that device's bounded queue,
  runs each driver and writes its results at the chunk's original row
  indices, so results come back in input order however the chunks
  interleave;
* the queue bound (:data:`DEFAULT_QUEUE_DEPTH` staged chunks a device, or
  ``REPRO_FABRIC_EXECUTOR_DEPTH``) is the back-pressure: host memory holds
  a few chunks, never the sweep;
* the first exception in any thread stops the pipeline: the prep workers
  stop claiming chunks, the compute workers drain their queues without
  running what is left, every thread is joined, and the exception is
  raised again in the caller. Nothing is run again serially.

``mode="serial"`` (the default, or ``REPRO_FABRIC_EXECUTOR=serial``) is
the plain loop on the calling thread; so is ``"async"`` for at most one
chunk, where there is nothing to overlap. The default is serial because
the pipeline has shown no gain on an H100 (PERF.md): under the host turn
below, all it can hide is a chunk's build under another chunk's device
time, and the tuner's sweeps are host-bound.

The threads take turns at the host (one lock, the host turn): a prep
worker holds it while it builds a chunk, a driver's ``run(turn)`` while
it runs, except while it waits on a device-to-host read. The GIL lets one
thread run Python at a time in any case, and a driver's step loop gives
the GIL up at every torch call: beside a prep thread that runs Python
freely, it waits a whole switch interval to get it back at each one, and
the sweep ran slower than the serial loop. With the turn, the host's work
stays as serial as the GIL makes it, and builds never run at once, so a
builder need not be thread-safe.

CUDA streams are where the overlap lives. Each device has one side
stream and one compute stream, made at first use and kept for the
process (new streams a call would leave the caching allocator's blocks
cached against streams later calls do not use). A prep worker builds its
driver under the side stream, so the uploads queue behind nothing the
compute stream runs, and records an event once the driver is built; the
compute worker hands the driver over with
``TorchFabricSimulation.use_stream`` (the compute stream waits on the
event, and the build's tensors are marked as used there) and runs it on
the compute stream (every kernel wrapper launches on the thread's current
stream). On the CPU (``device="cpu"``) the executor touches no
``torch.cuda`` API.

The reference also runs an AOT warm thread that compiles each chunk's XLA
programs ahead of its run. That has no counterpart here: the port's CUDA
kernels are built once, at first use, under ``repro_torch._cuda_build``'s
lock, and every later chunk launches the same binaries.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .stats import SweepStats, merge_stats

#: recognised ``REPRO_FABRIC_EXECUTOR`` values
EXECUTOR_MODES = ("serial", "async")

#: staged (built, not yet running) chunks a device: 1 is double buffering,
#: one chunk running, one staged, one being built
DEFAULT_QUEUE_DEPTH = 1

#: each CUDA device's (side, compute) streams, made at first use
_STREAMS: Dict[torch.device, Tuple] = {}
_STREAMS_LOCK = threading.Lock()


def executor_mode(override: Optional[str] = None) -> str:
    """The executor mode: an explicit ``override`` (a runner argument or
    CLI flag) first, then ``REPRO_FABRIC_EXECUTOR``, then ``"serial"``."""
    mode = override or os.environ.get("REPRO_FABRIC_EXECUTOR") or "serial"
    if mode not in EXECUTOR_MODES:
        raise ValueError(f"unknown executor mode {mode!r}; options: {EXECUTOR_MODES}")
    return mode


def _queue_depth(depth: Optional[int]) -> int:
    if depth is None:
        depth = int(os.environ.get("REPRO_FABRIC_EXECUTOR_DEPTH", DEFAULT_QUEUE_DEPTH))
    return max(1, depth)


def backend_devices(device: torch.device) -> List[torch.device]:
    """The devices the chunks are dealt over: every visible card for a CUDA
    device without an index, else ``device`` alone (the CPU is one slot)."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _streams(device: torch.device) -> Tuple:
    """``device``'s (side, compute) streams, the same on every call."""
    with _STREAMS_LOCK:
        pair = _STREAMS.get(device)
        if pair is None:
            pair = _STREAMS[device] = (torch.cuda.Stream(device=device),
                                       torch.cuda.Stream(device=device))
        return pair


def execute_chunks(
    parts: Sequence[Sequence[int]],
    make_chunk: Callable,
    results: List,
    mode: Optional[str] = None,
    queue_depth: Optional[int] = None,
    device: Optional[torch.device] = None,
    stats: Optional[SweepStats] = None,
) -> List:
    """Run ``parts`` (lists of row indices): ``make_chunk(part, device)``
    returns a ready driver for the rows of ``part`` (its ``run()``, or
    ``run(turn)`` in the pipeline, gives their results in order, its
    ``stats`` what it did); each result
    lands at ``results[i]``, and each driver's stats are merged into
    ``stats`` under one lock. ``device`` (default the CPU) picks the slots
    chunks are dealt over (:func:`backend_devices`)."""
    mode = executor_mode(mode)
    parts = [list(p) for p in parts]
    device = torch.device("cpu") if device is None else torch.device(device)

    def run_one(part, drv, turn=None) -> None:
        out = drv.run() if turn is None else drv.run(turn)
        for i, res in zip(part, out):
            results[i] = res
        merge_stats(stats, drv.stats)

    if mode == "serial" or len(parts) <= 1:
        for part in parts:
            run_one(part, make_chunk(part, device))
        return results

    devices = backend_devices(device)
    cuda = devices[0].type == "cuda"
    turn = threading.Lock()  # the host turn (module docstring)
    queues = [queue.Queue(maxsize=_queue_depth(queue_depth)) for _ in devices]
    stop = threading.Event()
    errors: List[BaseException] = []
    err_lock = threading.Lock()

    def fail(exc: BaseException) -> None:
        with err_lock:
            errors.append(exc)
        stop.set()

    def put(q: queue.Queue, item) -> None:
        # a bounded put that gives up once the pipeline has failed; the
        # sentinel (None) always goes through: a worker drains until it
        # sees one
        while True:
            if stop.is_set() and item is not None:
                return
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    cursor = [0]
    cursor_lock = threading.Lock()

    def prep() -> None:
        try:
            while not stop.is_set():
                with cursor_lock:
                    j = cursor[0]
                    if j >= len(parts):
                        return
                    cursor[0] = j + 1
                slot = j % len(devices)
                dev = devices[slot]
                ready = None
                with turn:
                    if cuda:
                        with torch.cuda.stream(_streams(dev)[0]):
                            drv = make_chunk(parts[j], dev)
                            ready = torch.cuda.Event()
                            ready.record()
                    else:
                        drv = make_chunk(parts[j], dev)
                put(queues[slot], (parts[j], drv, ready))
        except BaseException as exc:  # a chunk's build may raise anything
            fail(exc)

    def compute(slot: int) -> None:
        q = queues[slot]
        while True:
            item = q.get()
            if item is None:
                return
            if stop.is_set():
                continue  # drain, so that no prep worker waits on a full queue
            part, drv, ready = item
            try:
                if cuda:
                    stream = _streams(devices[slot])[1]
                    with torch.cuda.stream(stream):
                        drv.use_stream(stream, ready)
                        run_one(part, drv, turn)
                else:
                    run_one(part, drv, turn)
            except BaseException as exc:
                fail(exc)

    n_prep = min(len(devices), len(parts))
    preps = [threading.Thread(target=prep, name=f"fabric-prep{p}") for p in range(n_prep)]
    workers = [threading.Thread(target=compute, args=(d,), name=f"fabric-dev{d}")
               for d in range(len(devices))]
    for t in preps + workers:
        t.start()
    # the sentinels go in once every prep worker has finished
    for t in preps:
        t.join()
    for q in queues:
        put(q, None)
    for t in workers:
        t.join()
    if errors:
        raise errors[0]
    return results
