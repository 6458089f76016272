"""Synthetic dataset generators matching the paper's evaluation datasets.

Every generator is deterministic: it draws from ``np.random.RandomState
(seed)`` in a fixed order, so a file set comes out bit for bit the same
on every machine. ``scale`` in (0, 1] shrinks the file count while
keeping the size distribution.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.types import GB, KB, MB, FileSpec


def _spec_list(prefix: str, sizes: np.ndarray) -> List[FileSpec]:
    return [
        FileSpec(name=f"{prefix}/{i:06d}", size=int(max(1, s)))
        for i, s in enumerate(sizes)
    ]


def dark_energy_survey(scale: float = 1.0, seed: int = 0) -> List[FileSpec]:
    """427 files uniform in 250..750 MB, total ~212 GB (Fig. 8a)."""
    rng = np.random.RandomState(seed)
    n = max(2, int(round(427 * scale)))
    sizes = rng.uniform(250 * MB, 750 * MB, size=n)
    sizes *= (212 * GB * scale) / sizes.sum()
    return _spec_list("des", sizes)


def genome_sequencing(scale: float = 1.0, seed: int = 1) -> List[FileSpec]:
    """~120 K files; 45% < 100 KB, 93% < 1 MB, a few up to 13 GB (Fig. 8b)."""
    rng = np.random.RandomState(seed)
    n = max(20, int(round(120_000 * scale)))
    n_tiny = int(0.45 * n)
    n_small = int(0.48 * n)
    n_huge = max(1, int(round(6 * scale)))
    n_mid = max(1, n - n_tiny - n_small - n_huge)
    tiny = rng.uniform(1 * KB, 100 * KB, size=n_tiny)
    small = rng.uniform(100 * KB, 1 * MB, size=n_small)
    mid = np.exp(rng.uniform(np.log(1 * MB), np.log(8 * MB), size=n_mid))
    huge = np.exp(rng.uniform(np.log(1 * GB), np.log(13 * GB), size=n_huge))
    # the tail keeps ~40% of the small/mid bytes at every scale
    rest = tiny.sum() + small.sum() + mid.sum()
    huge *= 0.4 * rest / huge.sum()
    huge = np.clip(huge, 1 * MB, 13 * GB)
    sizes = np.concatenate([tiny, small, mid, huge])
    rng.shuffle(sizes)
    return _spec_list("genome", sizes)


def mixed_dataset(scale: float = 1.0, seed: int = 2) -> List[FileSpec]:
    """6,232 files, 1 MB..5 GB, all four size classes (Fig. 8c)."""
    rng = np.random.RandomState(seed)
    n = max(8, int(round(6232 * scale)))
    n_s = int(0.62 * n)
    n_m = int(0.20 * n)
    n_l = int(0.13 * n)
    n_h = max(1, n - n_s - n_m - n_l)
    sizes = np.concatenate(
        [
            np.exp(rng.uniform(np.log(1 * MB), np.log(62 * MB), size=n_s)),
            rng.uniform(63 * MB, 250 * MB, size=n_m),
            rng.uniform(251 * MB, 1250 * MB, size=n_l),
            rng.uniform(1251 * MB, 5 * GB, size=n_h),
        ]
    )
    rng.shuffle(sizes)
    return _spec_list("mixed", sizes)


def small_dominated_mixed(scale: float = 1.0, seed: int = 3) -> List[FileSpec]:
    """Fig. 12: the mixed dataset with its small files doubled."""
    base = mixed_dataset(scale=scale, seed=seed)
    extra = [
        FileSpec(name=f.name + "+dup", size=f.size)
        for f in base
        if f.size <= 62 * MB
    ]
    return base + extra


def heavy_tail_dataset(
    scale: float = 1.0, seed: int = 6, alpha: float = 1.1
) -> List[FileSpec]:
    """Pareto(alpha~1.1) file sizes: a handful of files carry most of the
    bytes while small ones dominate the count."""
    rng = np.random.RandomState(seed)
    n = max(12, int(round(4000 * scale)))
    sizes = 256 * KB * (1.0 + rng.pareto(alpha, size=n))
    sizes = np.clip(sizes, 64 * KB, 20 * GB)
    rng.shuffle(sizes)
    return _spec_list("htail", sizes)


def small_file_swarm(scale: float = 1.0, seed: int = 7) -> List[FileSpec]:
    """95% of files in 32 KB..2 MB plus a thin mid band, no huge files."""
    rng = np.random.RandomState(seed)
    n = max(20, int(round(15_000 * scale)))
    n_tiny = int(0.95 * n)
    n_mid = max(1, n - n_tiny)
    tiny = np.exp(rng.uniform(np.log(32 * KB), np.log(2 * MB), size=n_tiny))
    mid = rng.uniform(2 * MB, 48 * MB, size=n_mid)
    sizes = np.concatenate([tiny, mid])
    rng.shuffle(sizes)
    return _spec_list("swarm", sizes)


def uniform_files(n: int, size: int, prefix: str = "u") -> List[FileSpec]:
    """n equal files."""
    return [FileSpec(name=f"{prefix}/{i:06d}", size=size) for i in range(n)]
