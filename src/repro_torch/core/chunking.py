"""File-size classes of the chunk partitioning (Fig. 3)."""
from __future__ import annotations

from typing import List

from .types import ChunkType


def size_thresholds(bandwidth: float, num_chunks: int) -> List[float]:
    """Cut-off points (bytes) for a given chunk count (Fig. 3)."""
    if not 1 <= num_chunks <= 4:
        raise ValueError(f"num_chunks must be in [1, 4], got {num_chunks}")
    full = [bandwidth / 20.0, bandwidth / 5.0, bandwidth]
    return full[: num_chunks - 1]


#: size-class label per (num_chunks, class index); with fewer thresholds
#: the upper classes merge
_CLASS_LABELS = {
    1: [ChunkType.ALL],
    2: [ChunkType.SMALL, ChunkType.LARGE],
    3: [ChunkType.SMALL, ChunkType.MEDIUM, ChunkType.LARGE],
    4: [ChunkType.SMALL, ChunkType.MEDIUM, ChunkType.LARGE, ChunkType.HUGE],
}
