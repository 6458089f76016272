"""The RG-LRU scan's plain PyTorch version against the Pallas kernel it ports
(interpreted on the CPU), the reference's plain version, and the reference
model's associative scan.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances, as in the reference's own kernel tests: rtol = atol = 1e-5 for
fp32 inputs, 5e-2 for bf16 inputs (both sides upcast the same bf16 values
to fp32, but the limit is the reference's); 1e-4 against the associative
scan, which sums in another order."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro.models.rglru import rglru_scan_ref as assoc_scan
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels.ref import rglru_scan_ref

#: (B, T, W): the reference's RG_CASES (tests/test_kernels.py)
RG_CASES = [(1, 64, 128), (2, 128, 256), (1, 96, 512), (3, 100, 64)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _draw(b, t, w, seed):
    """a in (0, 1), x, h0 as fp32 numpy."""
    rng = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, w))))
    x = 0.5 * rng.standard_normal((b, t, w))
    h0 = 0.5 * rng.standard_normal((b, w))
    return [v.astype(np.float32) for v in (a, x, h0)]


def _jax(arrays, dtype):
    """a and x in ``dtype``; h0 stays fp32, as in the reference's tests."""
    jd = getattr(jnp, dtype)
    return [jnp.asarray(arrays[0], jd), jnp.asarray(arrays[1], jd), jnp.asarray(arrays[2])]


def _torch(arrays, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(arrays[0]).to(td), torch.from_numpy(arrays[1]).to(td),
            torch.from_numpy(arrays[2])]


def _close(out, ref, tol):
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", RG_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_ops_match_the_interpreted_pallas_kernel(case, dtype):
    arrays = _draw(*case, seed=sum(case))
    ref = pallas_rglru_scan(*_jax(arrays, dtype), chunk=32, block_w=64, interpret=True)
    _close(rglru_scan_ref(*_torch(arrays, dtype)), ref, TOL[dtype])
    _close(ops.rglru_scan(*_torch(arrays, dtype)), ref, TOL[dtype])


@pytest.mark.parametrize("case", RG_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_reference_plain_version(case, dtype):
    arrays = _draw(*case, seed=100 + sum(case))
    ref = jax_ref.rglru_scan_ref(*_jax(arrays, dtype))
    _close(rglru_scan_ref(*_torch(arrays, dtype)), ref, TOL[dtype])


@pytest.mark.parametrize("case", [(2, 64, 128), (3, 100, 64)], ids=str)
def test_plain_matches_the_models_associative_scan(case):
    arrays = _draw(*case, seed=7 + sum(case))
    ref = assoc_scan(*_jax(arrays, "float32"))
    _close(rglru_scan_ref(*_torch(arrays, "float32")), ref, 1e-4)


def test_state_carries_over_between_calls():
    """The first part, then the rest from its final state, equals the whole
    sequence in one call; the split point divides no chunk size."""
    a, x, h0 = _torch(_draw(2, 80, 96, seed=11), "float32")
    h, h_fin = rglru_scan_ref(a, x, h0)
    cut = 33
    h1, mid = rglru_scan_ref(a[:, :cut], x[:, :cut], h0)
    h2, end = rglru_scan_ref(a[:, cut:], x[:, cut:], mid)
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    assert torch.equal(end, h_fin)
    torch.testing.assert_close(h_fin, h[:, -1])


@pytest.mark.parametrize("case", [(2, 1, 128), (3, 97, 40)], ids=["decode_T1", "prime_T97_odd_W"])
def test_decode_step_and_a_length_no_chunk_divides(case):
    """T = 1 (a decode step) and T = 97 with W = 40, which the Pallas
    kernel's chunk of 32 and lane block of 64 do not divide; the port's
    kernel has no chunk."""
    arrays = _draw(*case, seed=3)
    ref = pallas_rglru_scan(*_jax(arrays, "float32"), chunk=32, block_w=64, interpret=True)
    out = rglru_scan_ref(*_torch(arrays, "float32"))
    _close(out, ref, TOL["float32"])
    assert tuple(out[0].shape) == case and tuple(out[1].shape) == (case[0], case[2])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = rg.rglru_scan.launches
    args = _torch(_draw(2, 16, 32, seed=5), "float32")
    out = rg.rglru_scan(*args)
    assert rg.rglru_scan.launches == before
    for o, r in zip(out, rglru_scan_ref(*args)):
        assert torch.equal(o, r)


def test_wrapper_refuses_other_devices_and_bad_ranks():
    a = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rg.rglru_scan(a, a, torch.empty((1, 16), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, T, W\)"):
        rg.rglru_scan(torch.zeros(4, 16), torch.zeros(4, 16), torch.zeros(16))
