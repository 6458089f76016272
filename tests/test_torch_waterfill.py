"""The water-fill kernel's plain PyTorch version against the Pallas kernel
it ports (interpreted on the CPU in float64) and against the sort-based
closed form of the NumPy reference.

Tolerance: 1e-12 relative. The bisection and the closed form sum in
different orders, and the bisected level stops within a few ulps of the
exact one. Against the closed form the error is taken relative to the
row's largest cap: with a zero pool the bisected level ends at
``max(caps) * 2**-80`` instead of 0."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.eval.fabric import kernels as ref_kernels
from repro.eval.fabric.kernels.waterfill_pallas import waterfill_pallas
from repro.eval.fabric.shim import numpy_ops
from repro_torch.eval.fabric import kernels
from repro_torch.eval.fabric.kernels import waterfill_bisect as wf

RTOL = 1e-12


def _draw(C, seed, S=16):
    """caps with idle (zero) channels; pools that bind, that are slack
    (above the cap sum) and that are zero."""
    rng = np.random.RandomState(seed)
    caps = rng.uniform(0, 1e9, size=(S, C))
    caps[rng.uniform(size=caps.shape) < 0.3] = 0.0
    caps[0] = 0.0  # a row with every channel idle
    pool = rng.uniform(0, 1.0, size=S) * caps.sum(axis=1)
    pool[1::4] = caps[1::4].sum(axis=1) * 1.5 + 1.0  # slack pools
    pool[2] = 0.0
    return caps, pool


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("C", [4, 8, 16, 32])
def test_plain_matches_interpreted_pallas_kernel(C):
    caps, pool = _draw(C, seed=C)
    with jax.enable_x64(True):
        ref = np.asarray(waterfill_pallas(caps, pool, interpret=True))
    assert ref.dtype == np.float64
    out = wf.waterfill_bisect_plain(_t(caps), _t(pool)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("C", [4, 8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_numpy_closed_form(C, seed):
    caps, pool = _draw(C, seed=100 + seed)
    ref = ref_kernels.waterfill(numpy_ops(), caps, pool)
    out = wf.waterfill_bisect_plain(_t(caps), _t(pool)).numpy()
    scale = np.maximum(caps.max(axis=1, keepdims=True), 1.0)
    assert (np.abs(out - ref) / scale).max() <= RTOL
    # slack pools give every channel its full cap; idle rows get nothing
    np.testing.assert_allclose(out[1::4], caps[1::4], rtol=RTOL, atol=0)
    assert (out[0] == 0).all()


@pytest.mark.parametrize("C", [4, 8, 16, 32])
def test_torch_closed_form_is_the_numpy_closed_form(C):
    caps, pool = _draw(C, seed=200 + C)
    ref = ref_kernels.waterfill(numpy_ops(), caps, pool)
    np.testing.assert_array_equal(kernels.waterfill(_t(caps), _t(pool)).numpy(), ref)
    np.testing.assert_array_equal(
        kernels.waterfill_level(_t(caps), _t(pool)).numpy(),
        ref_kernels.waterfill_level(numpy_ops(), caps, pool),
    )
    np.testing.assert_array_equal(
        kernels.caps_total(_t(caps)).numpy(),
        ref_kernels.caps_total(numpy_ops(), caps),
    )


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    caps, pool = _draw(8, seed=3)
    before = wf.waterfill_bisect.launches
    out = wf.waterfill_bisect(_t(caps), _t(pool))
    assert wf.waterfill_bisect.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, wf.waterfill_bisect_plain(_t(caps), _t(pool)), rtol=0, atol=0)


def _butterfly_chain(caps, pool):
    """The halving chain one level at a time, each sum in the warp
    butterfly's pairing (the kernel's one-at-a-time form)."""
    pad = torch.nn.functional.pad(caps, (0, 32 - caps.shape[1]))
    pool_eff = torch.clamp(torch.minimum(pool, wf.fold(pad)), min=0.0)
    hi = torch.clamp(pad.amax(dim=-1), min=0.0)
    lo = torch.zeros_like(hi)
    for _ in range(wf.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        low = wf.fold(torch.minimum(pad, mid[:, None])) < pool_eff
        lo, hi = torch.where(low, mid, lo), torch.where(low, hi, mid)
    return torch.minimum(caps, hi[:, None])


@pytest.mark.parametrize("C", [1, 3, 4, 8, 16, 17, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_descent_mirror_is_the_butterfly_halving_chain_bit_for_bit(C, seed):
    """The 32-way descent takes the chain's mids and sums: its level and
    output equal the one-at-a-time chain's exactly."""
    caps, pool = _draw(C, seed=300 + 10 * C + seed, S=64)
    out = wf.waterfill_descent_plain(_t(caps), _t(pool))
    assert torch.equal(out, _butterfly_chain(_t(caps), _t(pool)))


def _tied_pools(caps):
    """Pools at the sum of ``min(caps, c)`` for a cap c of the row, and one
    ulp either side: the near-ties where the order of a sum decides
    ``sum < pool``."""
    level = caps.max(axis=1, keepdims=True) * 0.37
    exact = np.minimum(caps, level).sum(axis=1)
    return np.concatenate([exact, np.nextafter(exact, np.inf), np.nextafter(exact, 0)])


@pytest.mark.parametrize("C", [3, 8, 16, 17, 32, 40, 64])
def test_plain_level_sums_in_the_kernels_order(C):
    """``bisect_level`` (the water level of every plain step) sums in the
    kernels' order (``lane_sum``: tiles of 32 lanes in turn, then the warp
    butterfly), so on rows of C <= 32 it is the descent's level bit for bit
    and on wider rows the one-at-a-time chain of the kernels' butterfly
    sums, on any device. A plain ``sum`` in the CPU's order parts from it
    at near-tie pools."""
    caps, _ = _draw(C, seed=700 + C, S=256)
    pool = _tied_pools(caps)
    caps = np.concatenate([caps] * 3)
    out = wf.waterfill_bisect_plain(_t(caps), _t(pool))
    lanes = torch.nn.functional.pad(_t(caps), (0, 64 - C)).unflatten(-1, (2, 32))
    assert torch.equal(wf.lane_sum(_t(caps)), wf.fold(lanes[:, 0] + lanes[:, 1]))
    if C <= 32:
        assert torch.equal(out, wf.waterfill_descent_plain(_t(caps), _t(pool)))
        assert torch.equal(out, _butterfly_chain(_t(caps), _t(pool)))


@pytest.mark.parametrize("C", [1, 3, 16, 17, 32])
def test_descent_mirror_matches_interpreted_pallas_kernel(C):
    caps, pool = _draw(C, seed=400 + C)
    with jax.enable_x64(True):
        ref = np.asarray(waterfill_pallas(caps, pool, interpret=True))
    out = wf.waterfill_descent_plain(_t(caps), _t(pool)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(out, wf.waterfill_bisect_plain(_t(caps), _t(pool)).numpy(),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("pool_kind", ["zero", "above_the_caps", "negative"])
def test_descent_mirror_edge_pools(pool_kind):
    """A zero or negative pool fills to ``max(caps) * 2**-80`` at most (the
    bracket's lower end is 0); a pool above the caps' sum gives every
    channel its cap."""
    caps, _ = _draw(16, seed=500)
    total = caps.sum(axis=1)
    pool = {"zero": 0.0 * total, "above_the_caps": 2.0 * total + 1.0,
            "negative": -1.0 - total}[pool_kind]
    out = wf.waterfill_descent_plain(_t(caps), _t(pool))
    assert torch.equal(out, _butterfly_chain(_t(caps), _t(pool)))
    if pool_kind == "above_the_caps":
        np.testing.assert_allclose(out.numpy(), caps, rtol=RTOL, atol=0)
    else:
        assert (out.numpy() <= caps.max(axis=1, keepdims=True) * 2.0 ** -80).all()
        assert (out.numpy() >= 0).all()


def test_descent_mirror_refuses_rows_wider_than_a_warp():
    caps, pool = _draw(33, seed=6)
    with pytest.raises(ValueError, match="C <= 32"):
        wf.waterfill_descent_plain(_t(caps), _t(pool))
