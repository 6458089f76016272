"""Deterministic synthetic token stream for training: a copy of the
reference's ``data/synthetic.py`` (numpy only), so its batches equal the
reference's bit for bit.

The stream is a learnable mixture: a fixed Markov chain over a 64-token
sub-vocabulary plus positional repetition, so a small model's loss falls
clearly within a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic corpus with a fixed random transition table."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.RandomState(data.seed)
        v = cfg.vocab_size
        k = min(v, 64)  # active sub-vocabulary
        self.active = rng.choice(v, size=k, replace=False)
        # each active token prefers ~3 successors
        self.next_tbl = rng.randint(0, k, size=(k, 3))
        self.k = k

    def _sequence(self, rng: np.random.RandomState, length: int) -> np.ndarray:
        idx = np.empty(length, np.int64)
        cur = rng.randint(0, self.k)
        for t in range(length):
            idx[t] = cur
            cur = int(self.next_tbl[cur][rng.randint(0, 3)])
        return self.active[idx]

    def batches(self, n_steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Batch after batch (``n_steps`` of them, or without end): int32
        ``tokens`` and ``targets`` (global_batch, seq_len), the targets the
        tokens shifted by one, and the model's :func:`frontend_stubs`. Step
        i's batch depends only on the seed and i."""
        d = self.data
        step = 0
        while n_steps is None or step < n_steps:
            rng = np.random.RandomState(d.seed * 100003 + step)
            toks = np.stack([self._sequence(rng, d.seq_len + 1)
                             for _ in range(d.global_batch)])
            batch = {
                "tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32),
            }
            batch.update(frontend_stubs(self.cfg, d.global_batch, seed=step))
            yield batch
            step += 1


def frontend_stubs(cfg: ModelConfig, batch: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Precomputed modality-frontend embeddings, fp32: SigLIP patch rows
    ``prefix_embed`` (B, num_prefix_tokens, D) for a vision stub, audio
    frames ``frames`` (B, encoder_seq, D) for an audio stub, none else."""
    out: Dict[str, np.ndarray] = {}
    rng = np.random.RandomState(seed + 7)
    if cfg.frontend == "vision_stub":
        out["prefix_embed"] = (
            rng.randn(batch, cfg.num_prefix_tokens, cfg.d_model).astype(np.float32) * 0.02)
    if cfg.frontend == "audio_stub":
        out["frames"] = (
            rng.randn(batch, cfg.encoder_seq, cfg.d_model).astype(np.float32) * 0.02)
    return out
