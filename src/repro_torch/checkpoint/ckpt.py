"""Sharded checkpointing executed by the paper's TransferEngine.

Checkpoint shards ARE the mixed-size dataset of the paper: a train state has
KB-scale scalars/norms next to GB-scale stacked weight matrices. A save
therefore runs through :mod:`repro_torch.core`: shards are partitioned into
size-class chunks (Fig. 3 vs the storage path spec), Algorithm 1 tunes each
chunk (pipelining = queued shard writes, parallelism = striped I/O of one
big shard, concurrency = simultaneous shard files), and MC/ProMC schedules
the channels.

Layout (atomic-commit protocol), the reference's byte for byte:
  <dir>/step_<N>.tmp/            shards written here first
  <dir>/step_<N>/                renamed on completion (atomic on POSIX)
      index.json                 tree structure, shapes, dtypes, step
      <leafpath>.npy             one shard per leaf
Restore only ever reads directories with a committed index, so a crash
mid-save can never yield a half-checkpoint.

A tree is nested dicts and lists (or tuples) whose leaves are tensors,
numpy arrays or scalars. Leaves are named as the reference names a pytree's
(dict keys in sorted order, joined by ``.``; a list entry ``#i``) and
written as ``np.save`` writes them, C-ordered in their own dtype. A non-empty list of
tensors is one leaf, stacked on a new leading axis: the port's layout of a
parameter that the reference stacks over layers (``BaseLM.param_tree``).
It is stacked on the host one entry at a time, so a state on the card is
never copied on the card. Either package restores the other's checkpoints.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import testbeds
from repro_torch.core.engine import EngineReport, TransferEngine, TransferTask, bytes_task
from repro_torch.core.runner import prepare_chunks
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.types import FileSpec, NetworkSpec
from repro_torch.models.model import is_stacked, leaf_paths

Tree = Any


@dataclasses.dataclass
class CheckpointReport:
    """What one save or restore did. ``seconds``: the call's wall time;
    ``serialize_s``: the leaves to the host and their ``.npy`` headers; ``snapshot_s``:
    an asynchronous save's copy to the host, on the caller's thread;
    ``chunks``: (size class, files, bytes, (pipelining, parallelism,
    concurrency)) of each engine chunk; ``start`` / ``end``:
    ``time.monotonic()`` around the call (the snapshot excluded)."""

    kind: str  # "save" | "restore"
    step: int
    path: str
    files: int
    bytes: int
    seconds: float
    start: float
    end: float
    serialize_s: float = 0.0
    snapshot_s: float = 0.0
    engine: Optional[EngineReport] = None
    chunks: Tuple = ()


Observer = Callable[[CheckpointReport], None]


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host_copy(t: torch.Tensor, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``t`` copied into ``out`` (default: a new host array of its shape and
    dtype), one device-to-host copy for a tensor on the card."""
    if out is None:
        out = np.empty(tuple(t.shape), dtype=_numpy_dtype(t.dtype))
    torch.from_numpy(out).copy_(t.detach())
    return out


def _to_host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a C-ordered host array; with ``copy`` one that shares no
    memory with the leaf (a tensor on the CPU shares it with ``.numpy()``,
    and a training step writes the parameters in place)."""
    if is_stacked(leaf):
        first = leaf[0]
        out = np.empty((len(leaf), *first.shape), dtype=_numpy_dtype(first.dtype))
        for i, t in enumerate(leaf):
            _host_copy(t, out[i])
        return out
    if isinstance(leaf, torch.Tensor):
        if copy or leaf.device.type != "cpu":
            return _host_copy(leaf)
        return np.asarray(leaf.detach().numpy(), order="C")
    return np.array(leaf, order="C") if copy else np.asarray(leaf, order="C")


def _flatten(tree: Tree, copy: bool = False) -> List[Tuple[str, np.ndarray]]:
    """(reference leaf name, host array) of every leaf, in the reference's
    flattening order."""
    return [(name, _to_host(leaf, copy)) for name, leaf in leaf_paths(tree, ".", "#{}".format)]


class _NpyFile:
    """A leaf's ``.npy`` file, the bytes ``np.save(..., allow_pickle=False)``
    writes for a C-ordered array (the version 1.0 header, far from its 64
    KiB limit at a train state's shapes, then the array's bytes), without
    a copy of the array: a slice is the header's bytes or a memoryview of
    the array's. So the engine's ``pwrite``s read the leaf in place and
    release the interpreter lock; a serialized copy (two 12 GB host copies
    for a gemma3-1b state) would hold it for each 16 MiB piece, against the
    training step's dispatch on the loop thread."""

    def __init__(self, arr: np.ndarray):
        head = io.BytesIO()
        np.lib.format.write_array_header_1_0(head, np.lib.format.header_data_from_array_1_0(arr))
        self.header = head.getvalue()
        self.data = memoryview(arr.reshape(-1).view(np.uint8))

    def __len__(self) -> int:
        return len(self.header) + len(self.data)

    def __getitem__(self, span: slice):
        h = len(self.header)
        if span.start >= h:
            return self.data[span.start - h: span.stop - h]
        return self.header[span] + bytes(self.data[: max(0, span.stop - h)])


def snapshot(tree: Tree) -> Tree:
    """A host copy of ``tree`` in the reference's layout (stacked leaves
    stacked), sharing no memory with it."""
    return _nest(dict(_flatten(tree, copy=True)))


def save(
    state: Tree,
    directory: str,
    step: int,
    *,
    network: NetworkSpec = testbeds.CKPT_STORE,
    algorithm: str = "mc",
    max_cc: int = 4,
    keep: int = 3,
    on_report: Optional[Observer] = None,
) -> str:
    """Write a checkpoint through the scheduled transfer engine; returns
    its committed directory. ``on_report`` is called with the save's
    :class:`CheckpointReport` after the commit."""
    start = time.monotonic()
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten(state)
    specs: List[FileSpec] = []
    tasks: Dict[str, TransferTask] = {}
    index = {"step": step, "leaves": {}}
    for name, arr in leaves:
        payload = _NpyFile(arr)
        fname = name.replace("/", "_") + ".npy"
        spec = FileSpec(name=name, size=len(payload))
        specs.append(spec)
        tasks[name] = bytes_task(spec, payload, os.path.join(tmp, fname))
        index["leaves"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    serialize_s = time.monotonic() - start

    chunks = prepare_chunks(specs, network, num_chunks=2, max_cc=max_cc)
    sched = make_scheduler(algorithm, chunks, network, max_cc)
    engine = TransferEngine(network, tick_period=0.05)
    report = engine.run(chunks, sched, tasks)
    if report.files_done != len(specs):
        raise IOError(
            f"checkpoint save incomplete: {report.files_done}/{len(specs)}"
        )

    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(directory, keep)
    if on_report is not None:
        end = time.monotonic()
        on_report(CheckpointReport(
            kind="save", step=step, path=final, files=len(specs),
            bytes=sum(s.size for s in specs), seconds=end - start, start=start, end=end,
            serialize_s=serialize_s, engine=report,
            chunks=tuple((c.ctype.name, len(c.files), c.total_bytes,
                          (c.params.pipelining, c.params.parallelism, c.params.concurrency))
                         for c in chunks)))
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _committed_steps(directory: str) -> List[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "index.json")):
                out.append(int(d[len("step_"):]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def _nest(flat: Dict[str, np.ndarray]) -> Tree:
    tree: Dict = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return _undo_list_nodes(tree)


def restore(directory: str, step: Optional[int] = None, *,
            on_report: Optional[Observer] = None) -> Tuple[Tree, int]:
    """Load the newest complete checkpoint (or a specific step) as a tree
    of numpy arrays nested by the original path segments (stacked leaves
    stacked, as the reference's). ``on_report`` is called with the
    restore's :class:`CheckpointReport`."""
    start = time.monotonic()
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)

    flat = {name: np.load(os.path.join(d, meta["file"]), allow_pickle=False)
            for name, meta in index["leaves"].items()}
    tree = _nest(flat)
    if on_report is not None:
        end = time.monotonic()
        on_report(CheckpointReport(
            kind="restore", step=int(index["step"]), path=d, files=len(flat),
            bytes=sum(os.path.getsize(os.path.join(d, m["file"]))
                      for m in index["leaves"].values()),
            seconds=end - start, start=start, end=end))
    return tree, int(index["step"])


def _undo_list_nodes(node):
    """Dict nodes whose keys are all '#<i>' were lists originally."""
    if not isinstance(node, dict):
        return node
    out = {k: _undo_list_nodes(v) for k, v in node.items()}
    if out and all(k.startswith("#") for k in out):
        return [out[f"#{i}"] for i in range(len(out))]
    return out


class AsyncCheckpointer:
    """Fire-and-forget saves on a background thread (one in flight)."""

    def __init__(self, directory: str, **save_kw):
        self.directory = directory
        self.save_kw = save_kw
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Tree, step: int) -> None:
        """Snapshot ``state`` to the host on the caller's thread (a copy:
        the caller may change its tensors right after), then save it on a
        background thread."""
        self.wait()
        t0 = time.monotonic()
        host_state = snapshot(state)
        snapshot_s = time.monotonic() - t0
        save_kw = dict(self.save_kw)
        observer = save_kw.pop("on_report", None)
        if observer is not None:
            save_kw["on_report"] = lambda r: observer(
                dataclasses.replace(r, snapshot_s=snapshot_s))

        def run():
            try:
                save(host_state, self.directory, step, **save_kw)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
