"""Transfer scheduling algorithms: SC, MC (Alg. 2) and ProMC (Alg. 3).

Schedulers are controllers: they choose the channel allocation up front
and answer periodic ticks and chunk completions with channel actions.
The event simulator drives them through three calls:

    controller.initial_actions(view)            -> [Action]
    controller.on_tick(view)                    -> [Action]   (every period)
    controller.on_chunk_complete(view, cid)     -> [Action]

``view`` is a sequence of :class:`ChunkView` (bytes remaining, measured
throughput, channel counts, ETAs); actions are Open, Close and Move of
channels.

This module is a scalar facade over the tensor controllers of
:mod:`repro_torch.eval.fabric.controllers`: round-robin and delta-weighted
channel distribution, the ProMC streak state machine and the laggard-ETA
discounting run through the kernels the batched sweep runs, here on one
scenario's (K,) CPU tensors (float64, int64, bool), so the two cannot
drift apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.eval.fabric import controllers as _ctrl

from .params import assign_chunk_params
from .types import (
    MC_ROUND_ROBIN_ORDER,
    PROMC_DELTA,
    Chunk,
    ChunkType,
    NetworkSpec,
    TransferParams,
)

#: the facade's tensors live on the host: one scenario's views are a few
#: values, and the event loop that asks for them runs on the host
_CPU = torch.device("cpu")

#: ctype -> position in the MC round-robin service order
_RR_RANK = {ct: i for i, ct in enumerate(MC_ROUND_ROBIN_ORDER)}


def _f64(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64, device=_CPU)


def _i64(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=_CPU)


def _bool(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.bool, device=_CPU)


# --------------------------------------------------------------------------
# Controller protocol
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Open:
    chunk: int
    n: int = 1


@dataclasses.dataclass(frozen=True)
class Close:
    chunk: int
    n: int = 1


@dataclasses.dataclass(frozen=True)
class Move:
    src: int
    dst: int
    n: int = 1


Action = object  # Open | Close | Move

#: placeholder parameters of chunks with no files (no channel ever opens)
_EMPTY_CHUNK_PARAMS = TransferParams(pipelining=0, parallelism=1, concurrency=1)


@dataclasses.dataclass
class ChunkView:
    """State of one chunk at a point in time, as the backend reports it."""

    index: int
    ctype: ChunkType
    bytes_remaining: float
    files_remaining: int
    throughput: float  # recent measured rate (bytes/s), 0 before data flows
    n_channels: int
    done: bool
    predicted_rate: float = 0.0  # model-based rate, for cold ETAs

    @property
    def eta(self) -> float:
        """Estimated completion time = remaining / throughput (Sec. 3.3)."""
        if self.done or self.bytes_remaining <= 0:
            return 0.0
        rate = self.throughput if self.throughput > 0 else self.predicted_rate
        if rate <= 0:
            return math.inf
        return self.bytes_remaining / rate


ChunkViews = Sequence[ChunkView]


def _view_tensors(view: ChunkViews):
    """ChunkViews -> the (K,) CPU tensors the decision kernels take:
    ``(bytes_remaining, throughput, n_channels, done, eta)``."""
    bytes_rem = _f64([v.bytes_remaining for v in view])
    thr = _f64([v.throughput for v in view])
    pred = _f64([v.predicted_rate for v in view])
    done = _bool([v.done for v in view])
    n_ch = _i64([v.n_channels for v in view])
    eta = _ctrl.chunk_eta(bytes_rem, thr, pred, done)
    return bytes_rem, thr, n_ch, done, eta


class Scheduler:
    """Base controller; subclasses implement the paper's algorithms."""

    name = "base"

    def __init__(self, chunks: Sequence[Chunk], network: NetworkSpec, max_cc: int):
        if max_cc < 1:
            raise ValueError("max_cc must be >= 1")
        self.chunks = list(chunks)
        self.network = network
        self.max_cc = max_cc
        for c in self.chunks:
            if c.params is None:
                if len(c) == 0:
                    # Algorithm 1 is undefined on zero files; placeholder
                    # params keep views well-formed
                    c.params = _EMPTY_CHUNK_PARAMS
                else:
                    assign_chunk_params(c, network, max_cc)

    # -- protocol ----------------------------------------------------------
    def initial_actions(self, view: ChunkViews) -> List[Action]:
        raise NotImplementedError

    def on_tick(self, view: ChunkViews) -> List[Action]:
        return []

    def on_chunk_complete(self, view: ChunkViews, chunk: int) -> List[Action]:
        return []

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def distribute_to_laggards(
        view: ChunkViews, src: int, n_channels: int
    ) -> List[Action]:
        """Hand ``n_channels`` freed channels to the chunks with the largest
        estimated completion times, one at a time, discounting a chunk's
        ETA as it receives channels (Sec. 3.3)."""
        bytes_rem, _thr, n_ch, done, eta = _view_tensors(view)
        idx = torch.arange(len(view), dtype=torch.int64, device=_CPU)
        live = ~done & (idx != src) & (bytes_rem > 0)
        if n_channels <= 0 or not bool(live.any()):
            return []
        grants, first = _ctrl.laggard_grants(
            eta, n_ch, live, _i64(n_channels), n_channels
        )
        grants, first = grants.tolist(), first.tolist()
        order = sorted((d for d, g in enumerate(grants) if g > 0), key=lambda d: first[d])
        return [Move(src=src, dst=d, n=grants[d]) for d in order]


# --------------------------------------------------------------------------
# Single-Chunk (SC): sequential, per-chunk tuned parameters (Sec. 3.2)
# --------------------------------------------------------------------------


class SingleChunkScheduler(Scheduler):
    """Transfer chunks one by one, each with its Algorithm-1 parameters,
    largest size class first."""

    name = "SC"

    def __init__(self, chunks, network, max_cc):
        super().__init__(chunks, network, max_cc)
        ctypes = _i64([int(c.ctype) for c in self.chunks])
        self._order = _ctrl.sc_chunk_order(ctypes).tolist() if self.chunks else []
        self._cursor = 0

    def _open_current(self) -> List[Action]:
        while self._cursor < len(self._order):
            idx = self._order[self._cursor]
            chunk = self.chunks[idx]
            if len(chunk) > 0:
                # the chunk's own (maxCC-capped) concurrency
                return [Open(chunk=idx, n=chunk.params.concurrency)]
            self._cursor += 1
        return []

    def initial_actions(self, view: ChunkViews) -> List[Action]:
        return self._open_current()

    def on_chunk_complete(self, view: ChunkViews, chunk: int) -> List[Action]:
        actions: List[Action] = [Close(chunk=chunk, n=view[chunk].n_channels)]
        self._cursor += 1
        actions.extend(self._open_current())
        return actions


# --------------------------------------------------------------------------
# Multi-Chunk (MC): co-scheduled chunks, round-robin channels (Alg. 2)
# --------------------------------------------------------------------------


def round_robin_distribution(chunks: Sequence[Chunk], max_cc: int) -> Dict[int, int]:
    """Alg. 2 lines 8-12: maxCC channels round-robin over the chunks in
    the order {Huge, Small, Large, Medium}. Keys iterate in that service
    order (the order channels open)."""
    if not chunks:
        return {}
    rank = [_RR_RANK[c.ctype] for c in chunks]
    nonempty = [len(c) > 0 for c in chunks]
    alloc = _ctrl.round_robin_alloc(_i64(rank), _bool(nonempty), _i64(max_cc)).tolist()
    order = sorted((i for i, ne in enumerate(nonempty) if ne), key=lambda i: (rank[i], i))
    return {i: alloc[i] for i in order}


class MultiChunkScheduler(Scheduler):
    """MC (Sec. 3.3): every chunk at once, maxCC channels in all,
    round-robin distributed; freed channels go to the largest-ETA chunk."""

    name = "MC"

    def initial_actions(self, view: ChunkViews) -> List[Action]:
        alloc = round_robin_distribution(self.chunks, self.max_cc)
        return [Open(chunk=i, n=n) for i, n in alloc.items() if n > 0]

    def on_chunk_complete(self, view: ChunkViews, chunk: int) -> List[Action]:
        freed = view[chunk].n_channels
        return self.distribute_to_laggards(view, src=chunk, n_channels=freed)


# --------------------------------------------------------------------------
# Pro-Active Multi-Chunk (ProMC): weighted channels and online
# re-allocation (Sec. 3.4, Alg. 3)
# --------------------------------------------------------------------------


def weighted_distribution(
    chunks: Sequence[Chunk], max_cc: int, delta: Optional[Dict] = None
) -> Dict[int, int]:
    """Alg. 3 lines 5-12: weight_i = delta_i * size_i, normalized;
    concurrency_i = floor(weight_i * maxCC). Every non-empty chunk gets at
    least one channel, and channels left over from flooring go by largest
    fractional part, never past maxCC in all."""
    delta = delta or PROMC_DELTA
    nonempty = [len(c) > 0 for c in chunks]
    if not any(nonempty):
        return {}
    weights = _f64([delta[c.ctype] * c.total_bytes for c in chunks])
    alloc = _ctrl.weighted_alloc(
        weights, _bool(nonempty), _i64(max_cc), trim_iters=len(chunks)
    ).tolist()
    return {i: alloc[i] for i, ne in enumerate(nonempty) if ne}


class ProActiveMultiChunkScheduler(Scheduler):
    """ProMC: delta-weighted initial allocation and online re-allocation.

    If a chunk's ETA is at least ``ratio`` (2x) smaller than another's for
    ``patience`` (3) consecutive periods, one channel moves from the fast
    chunk to the slow one; the backend's tick drives the check."""

    name = "ProMC"

    def __init__(
        self,
        chunks,
        network,
        max_cc,
        *,
        delta: Optional[Dict] = None,
        ratio: float = 2.0,
        patience: int = 3,
    ):
        super().__init__(chunks, network, max_cc)
        self.delta = delta or PROMC_DELTA
        self.ratio = ratio
        self.patience = patience
        self._streak = 0
        self._streak_pair: Optional[tuple] = None

    def initial_actions(self, view: ChunkViews) -> List[Action]:
        alloc = weighted_distribution(self.chunks, self.max_cc, self.delta)
        return [Open(chunk=i, n=n) for i, n in alloc.items() if n > 0]

    def on_tick(self, view: ChunkViews) -> List[Action]:
        # scalar short cut, the kernel's "fewer than two contenders" reset:
        # single-chunk scenarios and endgames (most ticks) build no tensor
        n_live = sum(
            1
            for v in view
            if not v.done and v.bytes_remaining > 0 and v.n_channels > 0
        )
        if n_live < 2:
            self._streak, self._streak_pair = 0, None
            return []
        bytes_rem, thr, n_ch, done, eta = _view_tensors(view)
        pf, ps = self._streak_pair if self._streak_pair else (-1, -1)
        streak, pf, ps, move, src, dst = _ctrl.promc_tick(
            eta,
            thr,
            n_ch,
            ~done & (bytes_rem > 0),
            _i64(self._streak),
            _i64(pf),
            _i64(ps),
            self.ratio,
            _i64(self.patience),
        )
        self._streak = int(streak)
        pf = int(pf)
        self._streak_pair = (pf, int(ps)) if pf >= 0 else None
        if bool(move):
            return [Move(src=int(src), dst=int(dst), n=1)]
        return []

    def on_chunk_complete(self, view: ChunkViews, chunk: int) -> List[Action]:
        freed = view[chunk].n_channels
        self._streak, self._streak_pair = 0, None
        return self.distribute_to_laggards(view, src=chunk, n_channels=freed)


SCHEDULERS = {
    "sc": SingleChunkScheduler,
    "mc": MultiChunkScheduler,
    "promc": ProActiveMultiChunkScheduler,
}


def make_scheduler(name: str, chunks, network, max_cc, **kw) -> Scheduler:
    try:
        cls = SCHEDULERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; options: {list(SCHEDULERS)}")
    return cls(chunks, network, max_cc, **kw)
