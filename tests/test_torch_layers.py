"""The port's shared layers against the reference's ``models/layers.py``.

Inputs are drawn with numpy from a seed and handed to both frameworks. The
reference is compiled with ``xla_allow_excess_precision`` off, so that it
rounds a bf16 intermediate wherever its source rounds (with XLA's default
the CPU compiler may keep a fused bf16 intermediate in fp32).

Tolerances:
- gelu on bf16: at most 0.5% of the values differ, each by at most one
  bf16 ulp (the port's ``tanh`` and XLA's round a few values the other
  way); on fp32: within 1e-6 (two ``tanh`` implementations).
- silu on bf16: bit for bit (``F.silu``, which rounds once, differs in
  over a third of the values); on fp32: within 1e-6 (two ``exp``
  implementations).
- rope: within one bf16 ulp of the output (sin / cos / pow in fp32 from two
  libraries).
- attention outputs (bf16): atol 2e-2.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers as L

_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
ATTN_ATOL = 2e-2


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_follows_the_reference_op_by_op(dtype):
    x = (3.0 * np.random.RandomState(0).standard_normal(3 * 65536)).astype(np.float32)
    ref = _f32(_strict_jit(lambda v: jax.nn.gelu(v, approximate=True))(
        jnp.asarray(x, getattr(jnp, dtype))))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = L.activation(xt, "gelu")
    assert out.dtype == xt.dtype
    out = _f32(out)
    if dtype == "bfloat16":
        differ = out != ref
        assert differ.mean() <= 0.005, f"{differ.sum()} of {differ.size} values differ"
        assert (np.abs(out - ref) <= _bf16_ulp(ref))[differ].all()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_follows_the_reference_op_by_op(dtype):
    x = (4.0 * np.random.RandomState(2).standard_normal(200_000)).astype(np.float32)
    ref = _f32(_strict_jit(jax.nn.silu)(jnp.asarray(x, getattr(jnp, dtype))))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = L.activation(xt, "silu")
    assert out.dtype == xt.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(out), ref)
        # the fused silu rounds once and lies far outside that limit
        assert (_f32(torch.nn.functional.silu(xt)) != ref).mean() > 0.3
    else:
        np.testing.assert_allclose(_f32(out), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_the_reference(theta):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 40, 3, 32)).astype(np.float32)
    positions = np.arange(3000, 3040, dtype=np.int32)  # past the window of 2048
    ref = _f32(_strict_jit(lambda v, p: ref_layers.rope(v, p, theta))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(positions)))
    out = L.rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(positions), theta)
    assert out.dtype == torch.bfloat16
    assert (np.abs(_f32(out) - ref) <= _bf16_ulp(ref)).all()


def _qkv(b, s, t, h, kv, dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, t, kv, dh), (b, t, kv, dh))]


ATTN_CASES = {
    # name: (B, S, T, H, KV, Dh, window, q positions, k positions)
    "causal_gqa_kv1": (2, 16, 16, 4, 1, 32, None, np.arange(16), np.arange(16)),
    "windowed_kv2": (1, 20, 20, 4, 2, 16, 6, np.arange(20), np.arange(20)),
    # a rolling decode cache: one query, some slots unwritten (-1)
    "rolling_cache": (2, 1, 8, 2, 1, 32, 8, np.array([11]),
                      np.array([8, 9, 10, 11, 4, 5, 6, 7])),
    "partly_written_cache": (1, 1, 8, 4, 1, 16, 8, np.array([2]),
                             np.array([0, 1, 2, -1, -1, -1, -1, -1])),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_scores_matches_the_reference(name):
    b, s, t, h, kv, dh, window, qp, kp = ATTN_CASES[name]
    q, k, v = _qkv(b, s, t, h, kv, dh, seed=len(name))
    win = None if window is None else jnp.int32(window)
    ref = _strict_jit(lambda q, k, v, qp, kp: ref_layers.attention_scores(
        q, k, v, qp, kp, causal=True, window=win))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(qp, jnp.int32), jnp.asarray(kp, jnp.int32))
    out = L.attention_scores(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                             torch.from_numpy(qp), torch.from_numpy(kp),
                             causal=True, window=window)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, s, h, dh)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_scores_with_a_logit_softcap_matches_the_reference(name):
    """A softcap of 50 on logits of up to ~80 (q scaled by 8), so that the
    tanh bends them; the same cases as above."""
    b, s, t, h, kv, dh, window, qp, kp = ATTN_CASES[name]
    q, k, v = _qkv(b, s, t, h, kv, dh, seed=3 + len(name))
    q = 8.0 * q
    win = None if window is None else jnp.int32(window)
    ref = _strict_jit(lambda q, k, v, qp, kp: ref_layers.attention_scores(
        q, k, v, qp, kp, causal=True, window=win, logit_softcap=50.0))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(qp, jnp.int32), jnp.asarray(kp, jnp.int32))
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = L.attention_scores(*args, torch.from_numpy(qp), torch.from_numpy(kp),
                             causal=True, window=window, logit_softcap=50.0)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=ATTN_ATOL)
    uncapped = L.attention_scores(*args, torch.from_numpy(qp), torch.from_numpy(kp),
                                  causal=True, window=window)
    assert not torch.equal(out, uncapped)  # the cap bends the logits


@pytest.mark.parametrize("s, threshold, window", [(24, 8, 5), (24, 8, None), (20, 8, 5)],
                         ids=["chunked_windowed", "chunked_causal", "chunk_does_not_divide"])
def test_attend_matches_the_reference(s, threshold, window):
    """With S > chunk_threshold the query-chunked branch runs (chunks of
    q_chunk = 1024 in both; here S is small, so the reference's own
    ``attention_chunked`` is called with a small chunk too)."""
    q, k, v = _qkv(2, s, s, 4, 1, 32, seed=s)
    pos = np.arange(s)
    win = None if window is None else jnp.int32(window)
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(pos, jnp.int32)] * 2
    args_t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [torch.from_numpy(pos)] * 2
    ref = _strict_jit(lambda q, k, v, qp, kp: ref_layers.attend(
        q, k, v, qp, kp, causal=True, window=win, chunk_threshold=threshold))(*args_j)
    out = L.attend(*args_t, causal=True, window=window, chunk_threshold=threshold)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=ATTN_ATOL)
    chunk = 8 if s % 8 == 0 else 7
    ref_c = _strict_jit(lambda q, k, v, qp, kp: ref_layers.attention_chunked(
        q, k, v, qp, kp, causal=True, window=win, q_chunk=chunk))(*args_j)
    out_c = L.attention_chunked(*args_t, causal=True, window=window, q_chunk=chunk)
    np.testing.assert_allclose(_f32(out_c), _f32(ref_c), rtol=0, atol=ATTN_ATOL)
    dense = L.attention_scores(*args_t, causal=True, window=window)
    assert torch.equal(out_c, dense)  # chunking does not change the math


def test_ffn_apply_matches_the_reference():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    params = {"w_up": rng.standard_normal((64, 128)) / 8, "w_down": rng.standard_normal((128, 64)) / 11,
              "w_gate": rng.standard_normal((64, 128)) / 8}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    ref = _strict_jit(lambda p, x: ref_layers.ffn_apply(p, x, "gelu", True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x, jnp.bfloat16))

    class P:
        pass

    p = P()
    for k, v in params.items():
        setattr(p, k, torch.from_numpy(v))
    out = L.ffn_apply(p, torch.from_numpy(x).to(torch.bfloat16), "gelu", True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-2, atol=ATTN_ATOL)
