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
