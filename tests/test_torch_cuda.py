"""The CUDA kernels on the card: each against its plain PyTorch version,
and the smoke matrix through both routes against the golden snapshot.

These need an NVIDIA GPU and ``nvcc``; without a card they skip. On the
card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.kernels import waterfill_bisect as wf
from repro_torch.eval.runner import compare_golden, load_golden, metrics_snapshot, run_matrix
from repro_torch.eval.scenarios import smoke_matrix

pytestmark = pytest.mark.gpu

GOLDEN = Path(__file__).resolve().parent / "golden" / "eval_smoke.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("C", [4, 8, 16, 32, 64])
def test_kernels_match_their_plain_versions_on_the_card(cuda, C):
    rng = np.random.RandomState(C)
    S, K, Q = 300, 4, 1024
    chunk_of = rng.randint(-1, K, (S, C))
    busy = (chunk_of >= 0) & (rng.uniform(size=(S, C)) < 0.5)
    qlen = rng.randint(0, 3, (S, K))
    qoff = np.minimum((np.cumsum(qlen.ravel()) - qlen.ravel()).reshape(S, K), Q - 1)
    f8, i8 = torch.float64, torch.int64

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    args = (
        t(rng.uniform(size=S) < 0.8, torch.bool), t(busy, torch.bool),
        t(np.where(rng.uniform(size=(S, C)) < 0.3, rng.uniform(0, 0.2, (S, C)), 0.0), f8),
        t(np.where(busy, np.floor(rng.uniform(1e5, 5e9, (S, C))), 0.0), f8),
        t(np.where(chunk_of >= 0, rng.uniform(1e8, 5e8, (S, C)), 0.0), f8),
        t(chunk_of, i8), t(rng.uniform(0.05, 5, S), f8), t(np.full(S, 1.25e9), f8),
        t(rng.uniform(4e8, 3e9, S), f8), t(rng.randint(2, 9, S), i8),
        t(rng.uniform(0.01, 0.08, S), f8), t(qoff, i8), t(qlen, i8),
        t(np.zeros((S, K)), i8), t(np.floor(rng.uniform(0, 1e11, (S, K))), f8),
        t(rng.uniform(0.005, 0.1, (S, K)), f8), t(np.floor(rng.uniform(1e5, 1e10, Q)), f8),
    )
    before = fs.fused_step.launches
    out = fs.fused_step(*args)
    assert fs.fused_step.launches == before + 1
    for o, r in zip(out, fs.fused_step_plain(*args)):
        if r.dtype == f8:
            torch.testing.assert_close(o, r, rtol=1e-12, atol=0)
        else:
            assert torch.equal(o, r)
    caps = torch.where(args[1], args[4], 0.0).contiguous()
    pool = caps.sum(dim=-1) * 0.7
    torch.testing.assert_close(
        wf.waterfill_bisect(caps, pool), wf.waterfill_bisect_plain(caps, pool),
        rtol=1e-12, atol=0,
    )


@pytest.mark.parametrize("fused", ["kernel", "none"])
def test_smoke_matrix_on_the_card_matches_golden(cuda, fused):
    scs = smoke_matrix()
    launches = (wf.waterfill_bisect.launches, fs.fused_step.launches)
    out = run_matrix(scs, device=cuda, fused_step=fused)
    assert compare_golden(load_golden(str(GOLDEN)), metrics_snapshot(scs, out)) == []
    used = fs.fused_step.launches if fused == "kernel" else wf.waterfill_bisect.launches
    assert used > launches[fused == "kernel"]
