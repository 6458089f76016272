"""Gradient synchronization between ranks scheduled by the paper's technique,
the reference's ``distributed/grad_sync.py`` over a ``torch.distributed``
process group.

The WAN -> inter-rank link mapping: gradient tensors are the "files" (their
byte sizes span 5+ orders of magnitude), the link between ranks is the
wide-area link, and the three protocol parameters become:

    pipelining   -> in-flight window of bucket collectives;
    parallelism  -> slicing one large tensor into p independent collective
                    operands ("streams") on its leading axis;
    concurrency  -> number of simultaneously outstanding collectives.

``build_sync_plan`` partitions the gradient tree into Small/../Huge chunks
(Fig.-3 thresholds against the network spec, default the pod-pair DCN),
assigns Algorithm-1 parameters per chunk, allocates channels with MC
round-robin or ProMC delta-weighting, and emits a deterministic
interleaved ordering: the reference's plan, item for item. ``apply_sync``
runs it: one collective an item, issued in plan order with
``async_op=True``, at most ``plan.max_cc`` outstanding. ``simulate_sync``
replays the plan through the discrete-event simulator to score schedule
quality.

A gradient tree is the reference's layout (``BaseLM.param_tree``): nested
dicts (keys in sorted order) and lists, paths joined by ``/``. A leaf is a
tensor, or a non-empty list of tensors that the reference stacks on a
leading axis (the layers of a stacked parameter): it counts as one file of
shape (L, ...), and a slice of it is a run of layers. For a plan, any
object with ``shape`` and ``dtype`` is a leaf too (a ``meta`` tensor).

Numerics, the reference's CPU/GPU branch on every device; every rank sums
in the same order, so every rank ends with the same bits:
  * ``none``: an fp32 all-reduce (sum), divided by the ranks;
  * ``bf16``: each rank's gradient rounded to bf16 and all-gathered (bf16
    on the wire), summed in fp32 in rank order, divided by the ranks;
  * ``int8``: the int8 payloads and fp32 scales all-gathered, dequantized
    and summed in fp32 in rank order, divided by the ranks. The scale is
    one max-abs over the item's whole operand (all its layers).

Beyond-paper extension: per-chunk-class gradient compression — precision
becomes a fourth per-class "protocol parameter"; Small (latency-bound)
chunks stay fp32, bandwidth-bound chunks compress.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import testbeds
from repro_torch.core.chunking import partition_files
from repro_torch.core.params import assign_chunk_params
from repro_torch.core.runner import build_scheduler
from repro_torch.core.schedulers import round_robin_distribution, weighted_distribution
from repro_torch.core.simulator import SimResult, Simulation
from repro_torch.core.types import Chunk, ChunkType, FileSpec, NetworkSpec
from repro_torch.distributed import compression
from repro_torch.models.model import is_stacked, leaf_paths, map_leaves

Tree = Any


def leaf_shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape in the reference's layout ((L, ...) for a stacked one)."""
    if is_stacked(leaf):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def leaf_bytes(leaf) -> int:
    """A leaf's bytes as the reference counts a file (at least 1 element)."""
    dtype = leaf[0].dtype if is_stacked(leaf) else leaf.dtype
    return int(math.prod(leaf_shape(leaf)) or 1) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class SyncItem:
    """One collective: a whole gradient leaf or one slice of it."""

    path: str
    slice_idx: int  # -1 = whole tensor
    n_slices: int
    bytes: int
    chunk_type: ChunkType
    compress: str  # "none" | "bf16" | "int8"


@dataclasses.dataclass
class SyncPlan:
    network: NetworkSpec
    algorithm: str
    max_cc: int
    chunks: List[Chunk]  # core chunks (files = leaf tensors)
    channel_alloc: Dict[int, int]  # chunk idx -> channels
    order: List[SyncItem]  # emission order (interleaved by allocation)
    slicing: Dict[str, int]  # leaf path -> n_slices
    compress_by_class: Dict[ChunkType, str]

    def summary(self) -> str:
        lines = [
            f"sync plan [{self.algorithm}] on {self.network.name}: "
            f"{len(self.order)} collectives, maxCC={self.max_cc}"
        ]
        for i, c in enumerate(self.chunks):
            p = c.params
            lines.append(
                f"  {c.name:6s}: {len(c)} tensors, {c.total_bytes/1e6:.1f} MB, "
                f"pp={p.pipelining} par={p.parallelism} cc={p.concurrency} "
                f"channels={self.channel_alloc.get(i, 0)} "
                f"compress={self.compress_by_class[c.ctype]}"
            )
        return "\n".join(lines)


DEFAULT_COMPRESSION = {
    ChunkType.SMALL: "none",  # latency-bound; compression saves nothing
    ChunkType.MEDIUM: "bf16",
    ChunkType.LARGE: "bf16",
    ChunkType.HUGE: "bf16",  # bandwidth-bound; halve the wire bytes
    ChunkType.ALL: "none",
}

NO_COMPRESSION = {t: "none" for t in ChunkType}


def build_sync_plan(
    grad_shapes: Tree,
    *,
    network: NetworkSpec = testbeds.DCN,
    max_cc: int = 8,
    num_chunks: int = 2,
    algorithm: str = "promc",
    compress_by_class: Optional[Dict[ChunkType, str]] = None,
) -> SyncPlan:
    """grad_shapes: a tree of gradients, or of leaves with ``shape`` and
    ``dtype`` (see the module's docstring)."""
    compress_by_class = dict(
        DEFAULT_COMPRESSION if compress_by_class is None else compress_by_class
    )
    leaves = leaf_paths(grad_shapes)
    files = [FileSpec(name=path, size=leaf_bytes(leaf)) for path, leaf in leaves]
    chunks = partition_files(files, network, num_chunks)
    for c in chunks:
        assign_chunk_params(c, network, max_cc)

    if algorithm == "mc":
        alloc = round_robin_distribution(chunks, max_cc)
    elif algorithm == "promc":
        alloc = weighted_distribution(chunks, max_cc)
    elif algorithm == "sc":
        # sequential: chunks emitted one after another, per-chunk concurrency
        alloc = {i: c.params.concurrency for i, c in enumerate(chunks)}
    else:
        raise ValueError(f"unknown sync algorithm {algorithm!r}")

    shape_by_path = {path: leaf_shape(leaf) for path, leaf in leaves}
    slicing: Dict[str, int] = {}
    per_chunk_items: List[List[SyncItem]] = []
    for c in chunks:
        comp = compress_by_class[c.ctype]
        items = []
        par = c.params.parallelism
        for f in c.files:
            shape = shape_by_path[f.name]
            n_slices = 1
            if par > 1 and shape and f.size >= 2 * network.buffer_size:
                # largest divisor of the leading dim <= the stream count
                n_slices = max(d for d in range(1, par + 1) if shape[0] % d == 0)
            slicing[f.name] = n_slices
            if n_slices == 1:
                items.append(SyncItem(f.name, -1, 1, f.size, c.ctype, comp))
            else:
                for si in range(n_slices):
                    items.append(SyncItem(f.name, si, n_slices, f.size // n_slices,
                                          c.ctype, comp))
        per_chunk_items.append(items)

    # emission order: SC = sequential by chunk; MC/ProMC = interleave chunks
    # proportionally to their channel allocation (a weighted round-robin), so
    # `cc` transfers of each class are in flight together
    order: List[SyncItem] = []
    if algorithm == "sc":
        for items in per_chunk_items:
            order.extend(items)
    else:
        cursors = [0] * len(chunks)
        weights = [max(alloc.get(i, 0), 0) for i in range(len(chunks))]
        while any(cursors[i] < len(per_chunk_items[i]) for i in range(len(chunks))):
            for i in range(len(chunks)):
                take = max(weights[i], 1) if cursors[i] < len(per_chunk_items[i]) else 0
                for _ in range(take):
                    if cursors[i] < len(per_chunk_items[i]):
                        order.append(per_chunk_items[i][cursors[i]])
                        cursors[i] += 1

    return SyncPlan(
        network=network,
        algorithm=algorithm,
        max_cc=max_cc,
        chunks=chunks,
        channel_alloc=alloc,
        order=order,
        slicing=slicing,
        compress_by_class=compress_by_class,
    )


# ------------------------------------------------------------------ #
# execution over a process group
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class SyncReport:
    """What one sync did on this rank: collectives issued, bytes this rank
    sends by codec (ring counts: an all-reduce of n bytes sends 2 n (P-1) /
    P, an all-gather of n bytes a rank sends n (P-1)), the most collectives
    outstanding at once, and the wall seconds of the call (its last
    collective waited for)."""

    collectives: int = 0
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    max_outstanding: int = 0
    seconds: float = 0.0


def _pieces(leaf, item: Optional[SyncItem]) -> List[torch.Tensor]:
    """The tensors an item covers: a whole leaf (its layers, if stacked),
    or its ``slice_idx``-th of ``n_slices`` runs on the leading axis (a run
    of layers of a stacked leaf)."""
    if item is None or item.n_slices == 1:
        return list(leaf) if is_stacked(leaf) else [leaf]
    n0 = leaf_shape(leaf)[0] // item.n_slices
    lo, hi = item.slice_idx * n0, (item.slice_idx + 1) * n0
    return list(leaf[lo:hi]) if is_stacked(leaf) else [leaf[lo:hi]]


def _flat(pieces: List[torch.Tensor]) -> torch.Tensor:
    """The pieces' elements in order as one new fp32 vector."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in pieces])


def _split(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for p in like:
        out.append(flat[at:at + p.numel()].view(p.shape).to(p.dtype))
        at += p.numel()
    return out


def _rank_sum(parts: List[torch.Tensor], scales: Optional[List[torch.Tensor]] = None):
    """sum_r parts[r] (times scales[r]) in fp32, in rank order."""
    acc = None
    for r, p in enumerate(parts):
        x = p.to(torch.float32)
        if scales is not None:
            x = x * scales[r]
        acc = x if acc is None else acc + x
    return acc


def _start(flat: torch.Tensor, compress: str, group, world: int, report: SyncReport,
           ef: Optional[torch.Tensor]):
    """Issue one item's collective on ``flat`` (fp32, this rank's own
    copy); -> (work handles, finish() -> (synced fp32, new ef or None))."""
    report.collectives += 1
    if compress == "none":
        work = dist.all_reduce(flat, group=group, async_op=True)
        report.wire_bytes["none"] = (report.wire_bytes.get("none", 0)
                                     + 2 * flat.numel() * 4 * (world - 1) // world)
        return [work], lambda: (flat / world, None)
    if compress == "bf16":
        payload = flat.to(torch.bfloat16)
        parts = [torch.empty_like(payload) for _ in range(world)]
        work = dist.all_gather(parts, payload, group=group, async_op=True)
        report.wire_bytes["bf16"] = (report.wire_bytes.get("bf16", 0)
                                     + payload.numel() * 2 * (world - 1))
        return [work], lambda: (_rank_sum(parts) / world, None)
    if compress == "int8":
        q, scale, new_ef = compression.int8_encode(flat, ef)
        qs = [torch.empty_like(q) for _ in range(world)]
        ss = [torch.empty(1, dtype=torch.float32, device=flat.device) for _ in range(world)]
        works = [dist.all_gather(qs, q, group=group, async_op=True),
                 dist.all_gather(ss, scale.reshape(1), group=group, async_op=True)]
        report.collectives += 1
        report.wire_bytes["int8"] = (report.wire_bytes.get("int8", 0)
                                     + (q.numel() + 4) * (world - 1))
        return works, lambda: (_rank_sum(qs, ss) / world, new_ef)
    raise ValueError(f"unknown compression {compress!r}")


def apply_sync(
    plan: SyncPlan,
    grads: Tree,
    *,
    group: Optional[dist.ProcessGroup] = None,
    ef_state: Optional[Tree] = None,
    report: Optional[SyncReport] = None,
) -> Tuple[Tree, Optional[Tree]]:
    """Execute the plan on this rank: one collective a plan item (a whole
    leaf, or a run of rows / layers on its leading axis), per-chunk
    compression, in plan order, at most ``plan.max_cc`` outstanding.
    ``grads`` is in the plan's layout; ``group`` defaults to the default
    group. ``ef_state`` (same layout) threads int8 error feedback for whole
    leaves only, as the reference does. Returns (the synced tree, new
    tensors in the same layout; the new error-feedback tree or None).
    ``report`` is filled with what the call did."""
    report = SyncReport() if report is None else report
    t0 = time.perf_counter()
    world = dist.get_world_size(group)
    leaves = dict(leaf_paths(grads))
    ef_leaves = dict(leaf_paths(ef_state)) if ef_state is not None else {}
    out: Dict[str, Dict[int, List[torch.Tensor]]] = collections.defaultdict(dict)
    new_ef: Dict[str, Any] = {}
    pending: collections.deque = collections.deque()

    def finish():
        works, done, item, like = pending.popleft()
        for w in works:
            w.wait()
        synced, ef = done()
        out[item.path][item.slice_idx] = _split(synced, like)
        if ef is not None and item.n_slices == 1:  # no residual for a slice
            new_ef[item.path] = _split(ef, like)

    for item in plan.order:
        like = _pieces(leaves[item.path], item)
        ef = None
        if item.n_slices == 1 and item.path in ef_leaves:
            ef = _flat(_pieces(ef_leaves[item.path], None))
        while len(pending) >= max(plan.max_cc, 1):
            finish()
        works, done = _start(_flat(like), item.compress, group, world, report, ef)
        pending.append((works, done, item, like))
        report.max_outstanding = max(report.max_outstanding, len(pending))
    while pending:
        finish()

    def rebuild(path, leaf, parts):
        tensors = [t for _, ts in sorted(parts[path].items()) for t in ts]
        if is_stacked(leaf):
            return tensors
        return tensors[0] if len(tensors) == 1 else torch.cat(tensors, dim=0)

    synced_tree = map_leaves(lambda p, leaf: rebuild(p, leaf, out), grads)
    ef_tree = None
    if ef_state is not None:
        ef_tree = map_leaves(lambda p, leaf: leaf if p not in new_ef else (
            new_ef[p] if is_stacked(leaf) else new_ef[p][0]), ef_state)
    report.seconds += time.perf_counter() - t0
    return synced_tree, ef_tree


def naive_sync(grads: Tree, *, group: Optional[dist.ProcessGroup] = None,
               report: Optional[SyncReport] = None) -> Tree:
    """Baseline: one monolithic fp32 all-reduce a leaf (a stacked leaf's
    layers together), one at a time, no schedule, no compression."""
    report = SyncReport() if report is None else report
    t0 = time.perf_counter()
    world = dist.get_world_size(group)
    values = {}
    for path, leaf in leaf_paths(grads):
        like = _pieces(leaf, None)
        works, done = _start(_flat(like), "none", group, world, report, None)
        report.max_outstanding = max(report.max_outstanding, 1)
        works[0].wait()
        parts = _split(done()[0], like)
        values[path] = parts if is_stacked(leaf) else parts[0]
    report.seconds += time.perf_counter() - t0
    return map_leaves(lambda p, _: values[p], grads)


# ------------------------------------------------------------------ #
# schedule-quality evaluation (discrete-event simulation on the DCN)
# ------------------------------------------------------------------ #


def simulate_sync(
    grad_shapes: Tree,
    *,
    network: NetworkSpec = testbeds.DCN,
    algorithm: str = "promc",
    max_cc: int = 8,
    num_chunks: int = 2,
    compress_by_class: Optional[Dict[ChunkType, str]] = None,
    tick_period: float = 0.05,
) -> SimResult:
    """Score a sync schedule: simulated completion time of one gradient sync
    over the network (compression scales the transferred byte counts)."""
    comp = dict(DEFAULT_COMPRESSION if compress_by_class is None else compress_by_class)
    factor = {"none": 1.0, "bf16": 0.5, "int8": 0.25}
    # byte sizes after per-class compression, classified with the raw size
    raw = [(path, leaf_bytes(leaf)) for path, leaf in leaf_paths(grad_shapes)]
    chunks_probe = partition_files([FileSpec(p, s) for p, s in raw], network, num_chunks)
    class_of = {f.name: c.ctype for c in chunks_probe for f in c.files}
    plan_files = [FileSpec(path, max(1, int(size * factor[comp[class_of[path]]])))
                  for path, size in raw]
    sched = build_scheduler(
        algorithm if algorithm in ("sc", "mc", "promc", "untuned", "globus") else "mc",
        plan_files, network, max_cc=max_cc, num_chunks=num_chunks,
    )
    sim = Simulation(sched.chunks, sched.network, sched, tick_period=tick_period)
    return sim.run()


def compress_table(compress: bool, codec: str) -> Optional[Dict[ChunkType, str]]:
    """The train step's per-class codecs, chosen as the reference's
    (``train/train_step.py``): none without compression; int8 in place of
    bf16 for the ``"int8"`` codec; else the default table (None)."""
    if not compress:
        return NO_COMPRESSION
    if codec == "int8":
        return {t: ("int8" if c != "none" else "none") for t, c in DEFAULT_COMPRESSION.items()}
    return None

