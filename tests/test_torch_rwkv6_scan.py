"""The WKV-6 scan's plain PyTorch version against the Pallas kernel it ports
(interpreted on the CPU) and against the reference's plain version.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerance, as in the reference's own kernel tests: rtol = atol = 1e-4 for
fp32 inputs, 5e-2 for bf16 inputs (both sides upcast the same bf16 values
to fp32, but the limit is the reference's)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.kernels.ref import rwkv6_scan_ref

#: (B, H, T, D): the reference's WKV_CASES (tests/test_kernels.py)
WKV_CASES = [(1, 2, 64, 32), (2, 4, 128, 64), (1, 1, 96, 16)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _draw(b, h, t, d, seed):
    """r, k, v, w (B, H, T, D), u (H, D), s0 (B, H, D, D) as fp32 numpy."""
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, d)) for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((b, h, t, d))))  # decay in (0, 1)
    u = 0.5 * rng.standard_normal((h, d))
    s0 = 0.1 * rng.standard_normal((b, h, d, d))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _jax(arrays, dtype):
    """r, k, v, w in ``dtype``; u and s0 stay fp32, as in the reference."""
    jd = getattr(jnp, dtype)
    return [jnp.asarray(a, jd) for a in arrays[:4]] + [jnp.asarray(a) for a in arrays[4:]]


def _torch(arrays, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(a).to(td) for a in arrays[:4]] + [torch.from_numpy(a) for a in arrays[4:]]


def _close(out, ref, tol):
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpreted_pallas_kernel(case, dtype):
    arrays = _draw(*case, seed=sum(case))
    ref = pallas_rwkv6_scan(*_jax(arrays, dtype), chunk=32, interpret=True)
    out = rwkv6_scan_ref(*_torch(arrays, dtype))
    assert out[0].dtype == out[1].dtype == torch.float32
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_reference_plain_version(case, dtype):
    arrays = _draw(*case, seed=100 + sum(case))
    ref = jax_ref.rwkv6_scan_ref(*_jax(arrays, dtype))
    _close(rwkv6_scan_ref(*_torch(arrays, dtype)), ref, TOL[dtype])


@pytest.mark.parametrize("case", [(2, 3, 1, 64), (3, 2, 97, 32)], ids=["decode_T1", "prime_T97"])
def test_decode_step_and_a_length_no_chunk_divides(case):
    """T = 1 (a decode step) and T = 97, which the Pallas kernel's chunk of
    32 does not divide (it falls back to chunks of 1); the port's kernel has
    no chunk."""
    arrays = _draw(*case, seed=7)
    ref = pallas_rwkv6_scan(*_jax(arrays, "float32"), chunk=32, interpret=True)
    _close(rwkv6_scan_ref(*_torch(arrays, "float32")), ref, TOL["float32"])


def test_state_carries_over_between_calls():
    """The first half, then the second half from its final state, equals
    the whole sequence in one call (and the whole equals the reference)."""
    r, k, v, w, u, s0 = _torch(_draw(2, 2, 80, 32, seed=11), "float32")
    y, s = rwkv6_scan_ref(r, k, v, w, u, s0)
    h = 33
    y1, s1 = rwkv6_scan_ref(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0)
    y2, s2 = rwkv6_scan_ref(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2, s, rtol=1e-6, atol=1e-6)
    ref = jax_ref.rwkv6_scan_ref(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u, s0)))
    _close((y, s), ref, TOL["float32"])


def test_model_layout_wrapper_matches_the_reference_ops():
    """``ops.rwkv6_scan`` in model layout (B, T, H, D) against the
    reference's ``kernels.ops.rwkv6_scan`` (the Pallas kernel, interpreted
    off the TPU). CPU tensors take the plain version and count no launch."""
    r, k, v, w, u, s0 = _draw(2, 4, 48, 32, seed=3)
    model_layout = [np.ascontiguousarray(np.moveaxis(a, 2, 1)) for a in (r, k, v, w)]
    ref = ref_ops.rwkv6_scan(*(jnp.asarray(a) for a in model_layout), jnp.asarray(u), jnp.asarray(s0))
    before = wk.rwkv6_scan.launches
    out = ops.rwkv6_scan(*(torch.from_numpy(a) for a in model_layout),
                         torch.from_numpy(u), torch.from_numpy(s0))
    assert wk.rwkv6_scan.launches == before
    assert out[0].shape == (2, 48, 4, 32)
    _close(out, ref, TOL["float32"])


def test_wrapper_refuses_other_devices():
    r = torch.empty((1, 1, 4, 16), device="meta")
    u, s0 = torch.empty((1, 16), device="meta"), torch.empty((1, 1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.rwkv6_scan(r, r, r, r, u, s0)


def _model_layout(b, t, h, d, seed):
    """r, k, v, w as (B, T, H, D) tensors, u, s0, from ``_draw``."""
    r, k, v, w, u, s0 = _draw(b, h, t, d, seed=seed)
    seq = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 2, 1))) for a in (r, k, v, w)]
    return seq, torch.from_numpy(u), torch.from_numpy(s0)


@pytest.mark.parametrize("view", ["model_layout", "sliced", "strided_time"])
def test_wrapper_and_ops_give_the_same_results_on_views_as_on_copies(view):
    """Non-contiguous (B, T, H, D) views, as the model hands them over and
    as slices of wider tensors, give what their contiguous copies give,
    through the wrapper and through ``ops.rwkv6_scan``."""
    seq, u, s0 = _model_layout(2, 24, 3, 32, seed=21)
    if view == "sliced":  # every other head of a tensor twice as wide
        seq = [torch.cat([x, x.flip(2)], dim=2)[:, :, ::2] for x in seq]
    elif view == "strided_time":  # every other step of a sequence twice as long
        seq = [torch.repeat_interleave(x, 2, dim=1)[:, ::2] for x in seq]
    kernel_views = [x.movedim(1, 2) for x in seq]
    assert not any(x.is_contiguous() for x in kernel_views)
    copies = [x.contiguous() for x in kernel_views]
    y, s = wk.rwkv6_scan(*kernel_views, u, s0)
    y_c, s_c = wk.rwkv6_scan(*copies, u, s0)
    assert torch.equal(y, y_c) and torch.equal(s, s_c)
    y_m, s_m = ops.rwkv6_scan(*seq, u, s0)
    y_mc, s_mc = ops.rwkv6_scan(*(x.contiguous() for x in seq), u, s0)
    assert torch.equal(y_m, y_mc) and torch.equal(s_m, s_mc)
    assert torch.equal(y_m, y.movedim(1, 2)) and y_m.shape == seq[0].shape


def test_the_kernel_reads_model_layout_views_in_place():
    """The kernel reads a (B, H, T, D) view of a (B, T, H, D) fp32 tensor
    where it lies (no copy) and passes its strides; views it cannot read
    (a last dim that is not contiguous, a stride that is no multiple of 4
    elements, a 4-byte offset) are copied. A dim of size 1 takes any
    stride, and is passed as 0."""
    x = torch.zeros((2, 5, 3, 16)).movedim(1, 2)  # (B, H, T, D) view
    assert wk._in_place(x) is x
    assert wk._strides(x) == [5 * 3 * 16, 16, 3 * 16]
    one = torch.zeros((2, 1, 3, 16)).movedim(1, 2)  # T = 1
    assert wk._in_place(one) is one and wk._strides(one) == [48, 16, 0]
    for bad in (torch.zeros((2, 3, 16, 5)).transpose(2, 3),  # D not contiguous
                torch.zeros((2, 3, 5, 18))[..., :16],       # a row of 18 elements
                torch.zeros(2 * 3 * 5 * 16 + 1)[1:].view(2, 3, 5, 16)):  # 4-byte offset
        copied = wk._in_place(bad)
        assert copied is not bad and copied.is_contiguous() and torch.equal(copied, bad)
        assert copied.data_ptr() % 16 == 0
