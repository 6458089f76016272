"""Ranks of a gloo group on the CPU for the port's multi-rank tests.

``run_ranks(worker, world, tmp, *args)`` spawns ``world`` processes; each
joins a group through a ``file://`` store under ``tmp``
(:func:`repro_torch.distributed.pods.init_pods` with ``device="cpu"``),
runs ``worker(pods, *args)`` with one intra-op thread and pickles its
result. A worker is a module-level function of a module the children can
import (this one imports only torch, numpy and the port). A rank that
raises makes the call raise.
"""
from __future__ import annotations

import os
import pickle

import torch
import torch.multiprocessing as mp


def _entry(rank, worker, world, store, out_dir, args):
    from repro_torch.distributed.pods import close_pods, init_pods

    torch.set_num_threads(1)
    pods = init_pods(rank, world, init_method=f"file://{store}", device="cpu")
    try:
        result = worker(pods, *args)
    finally:
        close_pods()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(worker, world: int, tmp, *args) -> list:
    """Each rank's result, in rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    mp.spawn(_entry, args=(worker, world, store, tmp, args), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
