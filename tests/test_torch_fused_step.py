"""The fused-step kernel's plain PyTorch version against the Pallas kernel
it ports, interpreted on the CPU in float64 through its cached
``pallas_call`` builder.

Tolerance: bool and int64 outputs exact; float64 outputs within 1e-12
relative (the bisection's row sums run in another order)."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.eval.fabric.kernels import fused_step_pallas
from repro_torch.eval.fabric.kernels import fused_step as fs

RTOL = 1e-12


def _draw(S, C, K, Q, seed):
    """Sweep-like operands: idle, busy, in-dead-time and closed channels,
    inactive rows, queues that run dry, integer-valued file sizes."""
    rng = np.random.RandomState(seed)
    chunk_of = rng.randint(-1, K, (S, C)).astype(np.int64)
    busy = (chunk_of >= 0) & (rng.uniform(size=(S, C)) < 0.5)
    dead = np.where(rng.uniform(size=(S, C)) < 0.3, rng.uniform(0, 0.2, (S, C)), 0.0)
    rem = np.where(busy, np.floor(rng.uniform(1e5, 5e9, (S, C))), 0.0)
    cap = np.where(chunk_of >= 0, rng.uniform(1e8, 5e8, (S, C)), 0.0)
    qlen = rng.randint(0, 5, (S, K)).astype(np.int64)
    qoff = (np.cumsum(qlen.ravel()) - qlen.ravel()).reshape(S, K)
    qptr = (rng.uniform(size=(S, K)) * (qlen + 1)).astype(np.int64)
    act = rng.uniform(size=S) < 0.8
    return (
        act, busy, dead, rem, cap, chunk_of, rng.uniform(0.05, 5.0, S),
        rng.choice([1.25e9, 3.75e9], S), rng.uniform(4e8, 3e9, S),
        rng.randint(2, 9, S).astype(np.int64), rng.uniform(0.01, 0.08, S),
        qoff, qlen, qptr, np.floor(rng.uniform(0, 1e11, (S, K))),
        rng.uniform(0.005, 0.1, (S, K)), np.floor(rng.uniform(1e5, 1e10, Q)),
    )


def _pallas(args):
    S, C = args[1].shape
    K = args[13].shape[1]
    Q = args[16].shape[0]
    with jax.enable_x64(True):
        import jax.numpy as jnp

        call = fused_step_pallas._build_call(S, C, K, Q, True)
        out = call(*[jnp.asarray(a) for a in args])
        return [np.asarray(o) for o in out]


def _assert_outputs_match(out, ref):
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape, i
        if r.dtype == np.float64:
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=0, err_msg=f"output {i}")
        else:
            assert o.dtype == r.dtype, i
            np.testing.assert_array_equal(o, r, err_msg=f"output {i}")


@pytest.mark.parametrize(
    "S,C,K,Q,seed",
    [(8, 4, 4, 64, 0), (16, 8, 4, 128, 1), (8, 16, 2, 64, 2), (4, 32, 4, 64, 3)],
)
def test_plain_matches_interpreted_pallas_kernel(S, C, K, Q, seed):
    args = _draw(S, C, K, Q, seed)
    ref = _pallas(args)
    out = fs.fused_step_plain(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    _assert_outputs_match([o.numpy() for o in out], ref)
    # inactive rows pass through with dt = 0
    act = args[0]
    assert (ref[0][~act] == 0).all()
    np.testing.assert_array_equal(ref[7][~act], args[13][~act])


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _draw(8, 8, 4, 64, 5)]
    before = fs.fused_step.launches
    out = fs.fused_step(*args)
    assert fs.fused_step.launches == before  # no kernel on the CPU
    for o, r in zip(out, fs.fused_step_plain(*args)):
        assert torch.equal(o, r)
