"""Ranks of a ``torch.distributed`` process group as the reference's pods.

The reference replicates the model over the ``"pod"`` axis of its mesh and
gives pod i the i-th block of the global batch (``in_specs=P("pod")`` in
its ``train/train_step.py``). Here a pod is a process: it holds the whole
model on its own device, takes its block of rows with :func:`local_rows`,
and the gradient collectives run over the process group.

The backend rule, printed by :func:`init_pods`:
  * ``"nccl"`` when every rank has a card of its own;
  * ``"gloo"`` on the CPU, or when ranks share a card (NCCL refuses two
    ranks on one device).
A collective that fails raises; it is never retried on another backend.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Pods:
    """One rank's view of the group: its rank, the group's size, the
    backend, the rank's device and the process group."""
    rank: int
    world: int
    backend: str
    device: torch.device
    group: dist.ProcessGroup


def pod_device(rank: int, world: int,
               device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The rank's device: the CPU if asked for, else card ``rank`` when
    there are at least ``world`` cards, else card ``rank % count`` (ranks
    share the cards). Raises without a card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(device: torch.device, rank: int, world: int) -> str:
    """``"nccl"`` when each of the ``world`` ranks has a card of its own
    (there are ``world`` cards or more and rank r is on card r), else
    ``"gloo"``."""
    if device.type == "cuda" and torch.cuda.device_count() >= world and device.index == rank:
        return "nccl"
    return "gloo"


def init_pods(rank: int, world: int, *, init_method: str,
              device: Optional[Union[str, torch.device]] = None) -> Pods:
    """Join the default process group as ``rank`` of ``world`` (its
    address: ``init_method``, ``"file://..."`` or
    ``"tcp://localhost:<port>"``) with the backend of the module's rule
    (:func:`pick_backend`) and return the rank's :class:`Pods`."""
    dev = pod_device(rank, world, device)
    backend = pick_backend(dev, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shared = dev.type == "cuda" and backend == "gloo"
    print(f"[pods] rank {rank} of {world} on {dev}: backend {backend}"
          + (" (the ranks share the cards)" if shared else ""), flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return Pods(rank=rank, world=world, backend=backend, device=dev, group=dist.group.WORLD)


def close_pods() -> None:
    """Leave the default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def local_rows(batch: Mapping, rank: int, world: int) -> dict:
    """The rank's contiguous block of the global batch on axis 0: rows
    ``rank B / world`` to ``(rank + 1) B / world - 1`` of every entry
    (numpy arrays or tensors, views)."""
    out = {}
    for name, x in batch.items():
        rows = np.shape(x)[0]
        if rows % world:
            raise ValueError(f"batch entry {name!r}: {rows} rows do not split over {world} ranks")
        n = rows // world
        out[name] = x[rank * n:(rank + 1) * n]
    return out
