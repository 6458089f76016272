"""Heuristic protocol-parameter estimation (Algorithm 1).

    pipelining  = BDP / avgFileSize
    parallelism = min(ceil(BDP / bufferSize), ceil(avgFileSize / bufferSize))
    concurrency = min(max(BDP / avgFileSize, 2), maxCC)

The arithmetic lives in the tensor kernel
:func:`repro_torch.eval.fabric.controllers.tuning.optimal_params`, which
the plan runs over every (row, chunk); this module validates and runs
it for one chunk, on CPU float64 / int64 tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.eval.fabric.controllers.tuning import optimal_params

from .types import Chunk, NetworkSpec, TransferParams

#: practical cap on the pipelining depth Algorithm 1 may request
MAX_PIPELINING = 4096

_CPU = torch.device("cpu")


def find_optimal_parameters(
    avg_file_size: float,
    bdp: float,
    buffer_size: float,
    max_cc: int,
    num_files: Optional[int] = None,
) -> TransferParams:
    """Algorithm 1 with integer rounding at the edges. ``num_files``
    caps pipelining and concurrency at the chunk's file count."""
    if avg_file_size <= 0:
        raise ValueError("avg_file_size must be positive")
    if max_cc < 1:
        raise ValueError("max_cc must be >= 1")

    def f8(x):
        return torch.tensor(float(x), dtype=torch.float64, device=_CPU)

    pp, par, cc = optimal_params(
        f8(avg_file_size),
        f8(bdp),
        f8(buffer_size),
        f8(max_cc),
        torch.tensor(num_files if num_files is not None else 0, dtype=torch.int64, device=_CPU),
        MAX_PIPELINING,
    )
    return TransferParams(
        pipelining=int(pp), parallelism=int(par), concurrency=int(cc)
    )


def assign_chunk_params(chunk: Chunk, network: NetworkSpec, max_cc: int) -> Chunk:
    """Fill ``chunk.params`` from Algorithm 1 for this network. A chunk of
    zero-byte files has its average floored at one byte, as the plan's
    columns are."""
    chunk.params = find_optimal_parameters(
        avg_file_size=max(chunk.avg_file_size, 1.0),
        bdp=network.bdp,
        buffer_size=network.buffer_size,
        max_cc=max_cc,
        num_files=len(chunk),
    )
    return chunk
