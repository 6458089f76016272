"""Partitioning a dataset into size-class chunks (Fig. 3).

Thresholds come from the link bandwidth BW (bytes moved in 1/20, 1/5 and
1 second at line rate): Small <= BW/20 < Medium <= BW/5 < Large <= BW <
Huge. ``num_chunks`` selects how many thresholds apply; with fewer, the
upper classes merge. Empty chunks are dropped.
"""
from __future__ import annotations

from typing import List, Sequence

from .types import Chunk, ChunkType, FileSpec, NetworkSpec


def size_thresholds(bandwidth: float, num_chunks: int) -> List[float]:
    """Cut-off points (bytes) for a given chunk count (Fig. 3)."""
    if not 1 <= num_chunks <= 4:
        raise ValueError(f"num_chunks must be in [1, 4], got {num_chunks}")
    full = [bandwidth / 20.0, bandwidth / 5.0, bandwidth]
    return full[: num_chunks - 1]


def classify(size: float, thresholds: Sequence[float]) -> int:
    """Index of the size class of ``size`` under ascending ``thresholds``."""
    for i, t in enumerate(thresholds):
        if size <= t:
            return i
    return len(thresholds)


#: size-class label per (num_chunks, class index); with fewer thresholds
#: the upper classes merge
_CLASS_LABELS = {
    1: [ChunkType.ALL],
    2: [ChunkType.SMALL, ChunkType.LARGE],
    3: [ChunkType.SMALL, ChunkType.MEDIUM, ChunkType.LARGE],
    4: [ChunkType.SMALL, ChunkType.MEDIUM, ChunkType.LARGE, ChunkType.HUGE],
}


def partition_files(
    files: Sequence[FileSpec],
    network: NetworkSpec,
    num_chunks: int = 2,
) -> List[Chunk]:
    """Partition ``files`` into up to ``num_chunks`` size-class chunks,
    file order kept within a chunk; every file lands in exactly one."""
    thresholds = size_thresholds(network.bandwidth, num_chunks)
    labels = _CLASS_LABELS[num_chunks]
    buckets: List[List[FileSpec]] = [[] for _ in labels]
    for f in files:
        buckets[classify(f.size, thresholds)].append(f)
    return [
        Chunk(ctype=label, files=bucket)
        for label, bucket in zip(labels, buckets)
        if bucket
    ]
