"""The flash-attention kernel's plain PyTorch version against the Pallas
kernel it ports (interpreted on the CPU, as ``tests/test_kernels.py`` runs
it) and the reference's plain version, and the wrapper's checks.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances are the reference's own for its kernel against its oracle: rtol =
atol = 2e-5 for fp32 inputs, 2e-2 for bf16 inputs (outputs in bf16).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

#: (B, H, KV, S, D, causal, window, softcap): the reference's FA_CASES
#: (tests/test_kernels.py)
FA_CASES = [
    (1, 4, 4, 128, 64, True, None, 0.0),
    (2, 8, 2, 256, 64, True, None, 0.0),
    (1, 4, 1, 256, 128, True, None, 0.0),
    (1, 4, 4, 256, 64, False, None, 0.0),
    (1, 4, 2, 512, 64, True, 128, 0.0),
    (1, 2, 1, 384, 64, True, 64, 0.0),
    (1, 4, 4, 256, 64, True, None, 50.0),
    (2, 2, 2, 1024, 32, True, 256, 0.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _draw(b, h, kv, s, t, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _close(out, ref, dtype):
    assert str(out.dtype).replace("torch.", "") == dtype
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", FA_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_interpreted_pallas_kernel_and_the_oracle(case, dtype):
    b, h, kv, s, d, causal, window, cap = case
    arrays = _draw(b, h, kv, s, s, d, seed=s + d + h)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out = flash_attention_ref(*_torch(arrays, dtype), **kw)
    assert tuple(out.shape) == (b, h, s, d)
    # blocks of 256 keep the interpreted grid short; the reference's own
    # tests show the result does not depend on the block shape
    pallas = pallas_flash_attention(*_jax(arrays, dtype), **kw, block_q=256, block_k=256,
                                    interpret=True)
    _close(out, pallas, dtype)
    _close(out, jax_ref.flash_attention_ref(*_jax(arrays, dtype), **kw), dtype)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(fa.flash_attention(*_torch(arrays, dtype), **kw), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_ops_layout_round_trip_matches_the_reference(dtype, window):
    """Model layout q (B, S, H, Dh), k / v (B, T, KV, Dh) through both
    packages' ``ops.flash_attention`` (the reference interprets its kernel
    on the CPU)."""
    q, k, v = (np.moveaxis(a, 1, 2) for a in _draw(2, 4, 2, 24, 24, 32, seed=9))
    kw = dict(causal=True, window=window, logit_softcap=30.0)
    ref = jax_ops.flash_attention(*_jax((q, k, v), dtype), **kw)
    out = ops.flash_attention(*_torch((q, k, v), dtype), **kw)
    assert tuple(out.shape) == (2, 24, 4, 32)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_one_returns_v(dtype):
    """Each query sees only its own key: the output is that key's value,
    exactly (a softmax over one logit is 1), from the KV head of its
    group."""
    q, k, v = _torch(_draw(2, 6, 3, 40, 40, 16, seed=4), dtype)
    out = fa.flash_attention(q, k, v, causal=True, window=1)
    assert torch.equal(out, v.repeat_interleave(2, dim=1))


def test_a_query_that_no_key_may_attend():
    """S > T with a window: queries at positions >= T + window - 1 see no
    key. The Pallas kernel (and the CUDA kernel) return zeros there; the
    plain versions, the reference's and the port's, the mean of v (a
    softmax over equal -1e30 logits). Elsewhere all agree."""
    arrays = _draw(1, 2, 1, 16, 4, 32, seed=5)
    kw = dict(causal=True, window=2)
    out = flash_attention_ref(*_torch(arrays, "float32"), **kw).numpy()
    oracle = np.asarray(jax_ref.flash_attention_ref(*_jax(arrays, "float32"), **kw))
    pallas = np.asarray(pallas_flash_attention(*_jax(arrays, "float32"), **kw, block_q=8,
                                               block_k=4, interpret=True))
    np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)
    dead = slice(5, None)  # 4 keys, window 2: query 5 on sees none
    assert (pallas[:, :, dead] == 0).all()
    np.testing.assert_allclose(out[:, :, dead], np.broadcast_to(
        arrays[2].mean(axis=2, keepdims=True), out[:, :, dead].shape), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[:, :, :5], pallas[:, :, :5], rtol=2e-5, atol=2e-5)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _torch(_draw(1, 3, 2, 8, 8, 16, seed=1), "float32")
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v)
    q, k, v = _torch(_draw(1, 4, 2, 8, 8, 16, seed=1), "float32")
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(*(x.to("meta") for x in (q, k, v)))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before  # the plain version launches nothing


@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_bf16_heads_that_tma_can_describe_take_the_tensor_core_kernel(D):
    assert fa._route(torch.bfloat16, D) == fa.TENSOR_CORES


@pytest.mark.parametrize("dtype, D", [(torch.float32, d) for d in (32, 64, 96, 128, 256)]
                         + [(torch.bfloat16, 20), (torch.bfloat16, 4)])
def test_fp32_and_other_bf16_heads_take_the_cuda_core_kernel(dtype, D):
    """fp32 stays on the CUDA-core kernel at the reference's 2e-5 limit;
    a bf16 head of D % 8 != 0 has rows TMA cannot stride over."""
    assert fa._route(dtype, D) == fa.CUDA_CORES


def test_tma_operands_keep_the_model_layout_and_copy_what_tma_cannot_read():
    """The model layout's (B, S, H, D) -> (B, H, S, D) view is read as it is;
    a head dim that is not a multiple of 8, or data 16-byte misaligned,
    gets a contiguous copy."""
    x = torch.zeros((2, 24, 4, 64), dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert fa._tma_operand(view) is view
    odd = torch.zeros((2, 24, 4, 20), dtype=torch.bfloat16).transpose(1, 2)
    got = fa._tma_operand(odd)
    assert got.is_contiguous() and torch.equal(got, odd)
    flat = torch.zeros(2 * 4 * 24 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 4, 24, 64)  # 2 bytes past an aligned start
    got = fa._tma_operand(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)


@pytest.mark.parametrize("shapes, match", [
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), "expected q"),
    (((4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), "expected q"),
    (((1, 4, 8, 16), (2, 2, 8, 16), (2, 2, 8, 16)), "does not match"),
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), "not divisible"),
], ids=["v-shape", "q-rank", "batch", "groups"])
def test_the_wrapper_refuses_inconsistent_shapes_on_any_device(shapes, match):
    """Shapes are checked before the route is chosen, so the CPU path
    refuses what the kernels would."""
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16) for s in shapes)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


@pytest.mark.gpu
def test_the_kernel_refuses_head_dims_above_256():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel runs only on the card)")
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 4, 288), device="cuda", dtype=dtype)
        with pytest.raises(ValueError, match="head dims up to 256"):
            fa.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros((1, 2, 4, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.flash_attention(q, q[:, :1], q[:, :1])
