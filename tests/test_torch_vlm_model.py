"""The port's VLM path (``LM`` with a batch's ``prefix_embed``) against the
reference, on the CPU.

``reduce_for_smoke(paligemma-3b)``: 2 'G' layers, 2 query heads and 1 KV
head, GeGLU, and 8 prefix rows (the SigLIP tower is a stub: the rows are
precomputed patch embeddings, here numpy draws from a seed). The prefix
goes before the text at positions 0..7, ``forward`` leaves it out of its
logits, the prefill's cache holds its keys, and ``generate`` with
``extra_batch={"prefix_embed": ...}`` sizes the cache for it and decodes at
positions 8 + S + i, as the reference's does.

As ``tests/test_torch_dense_model.py``: the reference compiled with
``xla_allow_excess_precision`` off; logits within atol 2e-2, bf16 caches
and block outputs within rtol = atol = 1e-2; each block held layer by
layer on the reference layer's input (a one-layer reference ``LM`` with
identity embedding and head).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_L
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_shapes as ref_param_shapes
from repro.train.serve_step import generate as ref_generate
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (LM, build_model, count_active_params, count_params,
                                      param_shapes, tree_leaves)
from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

LOGITS_ATOL = 2e-2
BF16_TOL = 1e-2
ARCH = "paligemma-3b"
B, S, NEW, DECODE = 2, 12, 5, 4
_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close(port, ref, where, tol=BF16_TOL):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol, err_msg=where)


def _close_logits(port, ref):
    assert tuple(port.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=0, atol=LOGITS_ATOL)


@pytest.fixture(scope="module")
def case():
    ref_cfg = ref_reduce_for_smoke(ref_get_config(ARCH))
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    port = params_from_jax(build_model(reduce_for_smoke(get_config(ARCH)), device="cpu"), tree)
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = rng.randn(B, ref_cfg.num_prefix_tokens, ref_cfg.d_model).astype(np.float32)
    forced = rng.randint(0, ref_cfg.vocab_size, (DECODE, B)).astype(np.int32)
    return {"ref_cfg": ref_cfg, "tree": tree, "port": port, "prompt": prompt,
            "prefix": prefix, "forced": forced, "P": ref_cfg.num_prefix_tokens}


def _port_batch(case):
    return {"tokens": torch.from_numpy(case["prompt"]).long(),
            "prefix_embed": torch.from_numpy(case["prefix"])}


@pytest.fixture(scope="module")
def port_run(case):
    m, P = case["port"], case["P"]
    batch = _port_batch(case)
    with torch.no_grad():
        fwd = m(batch)
    logits, cache = make_prefill(m)(batch, m.init_cache(B, P + S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        with torch.inference_mode():
            lg, c = m.decode_step(torch.from_numpy(tok).long(), c, P + S + i)
        steps.append((lg, c))
    gen = generate(m, batch["tokens"], NEW, extra_batch={"prefix_embed": case["prefix"]})
    return {"forward": fwd, "prefill": (logits, cache), "decode": steps, "generate": gen}


@pytest.fixture(scope="module")
def ref_run(case):
    cfg, P = case["ref_cfg"], case["P"]
    m = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["tree"])
    batch = {"tokens": jnp.asarray(case["prompt"]), "prefix_embed": jnp.asarray(case["prefix"])}
    fwd = _strict_jit(m.forward)(params, batch)
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    logits, cache = prefill(params, batch, m.init_cache(B, P + S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(P + S + i))
        steps.append((lg, c))

    one = ref_build_model(dataclasses.replace(cfg, num_layers=1))
    one._embed = lambda params, h: h
    one._logits = lambda params, h: h
    one_fwd, one_prefill, one_decode = (_strict_jit(one.forward), _strict_jit(one.prefill),
                                        _strict_jit(one.decode_step))
    layer_params = [{"embed": params["embed"],
                     "layers": jax.tree.map(lambda x, i=i: x[i:i + 1], params["layers"])}
                    for i in range(cfg.num_layers)]
    embed = _strict_jit(m._embed)
    # the first layer's input: the prefix rows (bf16), then the text
    h = jnp.concatenate([ref_L.cast(batch["prefix_embed"]),
                         embed(params["embed"], batch["tokens"])], axis=1)
    calls = []
    for lp in layer_params:
        out, _ = one_fwd(lp, {"tokens": h})
        _, kv = one_prefill(lp, {"tokens": h}, one.init_cache(B, P + S + DECODE))
        calls.append((h, out, kv))
        h = out
    layer_calls = [calls]
    before = cache
    for i, tok in enumerate(case["forced"]):
        h, calls = embed(params["embed"], jnp.asarray(tok)[:, None])[:, 0], []
        for li, lp in enumerate(layer_params):
            kv_in = {n: before[n][li:li + 1] for n in ("k", "v")}
            out, kv = one_decode(lp, h, kv_in, jnp.int32(P + S + i))
            calls.append((h, kv_in, out, kv))
            h = out
        layer_calls.append(calls)
        before = steps[i][1]
    gen = ref_generate(m, params, batch["tokens"], NEW,
                       extra_batch={"prefix_embed": batch["prefix_embed"]})
    return {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache),
            "decode": steps, "layers": layer_calls, "generate": np.asarray(gen)}


def test_forward_logits_leave_the_prefix_out(case, port_run, ref_run):
    logits, aux = port_run["forward"]
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (B, S, case["ref_cfg"].vocab_size)
    _close_logits(logits, ref_run["forward"][0])
    assert float(aux) == 0.0 == float(ref_run["forward"][1])


def test_prefill_logits_and_cache_hold_the_prefix(case, port_run, ref_run):
    logits, cache = port_run["prefill"]
    rlogits, rcache = ref_run["prefill"]
    _close_logits(logits, rlogits)
    P = case["P"]
    assert cache.keys() == rcache.keys() == {"k", "v"}
    for name in cache:
        assert cache[name].dtype == torch.bfloat16
        assert tuple(cache[name].shape) == rcache[name].shape == (
            2, B, P + S + DECODE, 1, case["ref_cfg"].head_dim)
        _close(cache[name], rcache[name], name)
        assert cache[name][:, :, :P + S].any() and not cache[name][:, :, P + S:].any()


def test_prefill_layer_by_layer(case, ref_run):
    """Each port block on the reference layer's input (prefix rows and text
    at positions 0..P+S-1): output and keys and values within the bf16
    limit."""
    m, n = case["port"], case["P"] + S
    positions = torch.arange(n)
    for i, (h, out, kv) in enumerate(ref_run["layers"][0]):
        with torch.inference_mode():
            got, st = m.layers[i](_to_torch(h), positions)
        _close(got, out, f"layer {i} output")
        for name in ("k", "v"):
            _close(st[name], kv[name][0, :, :n], f"layer {i} {name}")


def test_teacher_forced_decode_steps(case, port_run, ref_run):
    for i, ((lg, c), (rlg, rc)) in enumerate(zip(port_run["decode"], ref_run["decode"])):
        _close_logits(lg, rlg)
        for name in ("k", "v"):
            _close(c[name], rc[name], f"step {i} {name}")


def test_decode_steps_layer_by_layer(case, ref_run):
    m = case["port"]
    for step, calls in enumerate(ref_run["layers"][1:]):
        pos = case["P"] + S + step
        for i, (h, kv_in, out, kv) in enumerate(calls):
            state = {n: _to_torch(kv_in[n][0]) for n in ("k", "v")}
            with torch.inference_mode():
                got, st = m.layers[i](_to_torch(h)[:, None], torch.tensor([pos]), state, pos)
            _close(got[:, 0], out, f"step {step} layer {i} output")
            for name in ("k", "v"):
                _close(st[name], kv[name][0], f"step {step} layer {i} {name}")


def test_greedy_generate_with_the_prefix(case, port_run, ref_run):
    """``generate(..., extra_batch={"prefix_embed": ...})`` gives the
    reference's greedy tokens."""
    np.testing.assert_array_equal(port_run["generate"].numpy(), ref_run["generate"])


def test_generate_sizes_the_cache_for_the_prefix(case, monkeypatch):
    """The cache holds max_len + P slots, and decode step i runs at
    position P + S + i."""
    m, P = case["port"], case["P"]
    sizes, positions = [], []
    init_cache, decode_step = m.init_cache, m.decode_step
    monkeypatch.setattr(m, "init_cache", lambda b, n: sizes.append(n) or init_cache(b, n))
    monkeypatch.setattr(m, "decode_step",
                        lambda t, c, pos: positions.append(pos) or decode_step(t, c, pos))
    batch = _port_batch(case)
    generate(m, batch["tokens"], 3, extra_batch={"prefix_embed": batch["prefix_embed"]})
    generate(m, batch["tokens"], 3, max_len=20, extra_batch={"prefix_embed": case["prefix"]})
    assert sizes == [P + S + 3, P + 20]
    assert positions == [P + S, P + S + 1] * 2


def test_prefill_calls_the_flash_wrapper_once_a_layer(case, monkeypatch):
    """Each layer's prefill attention goes through ``flash_attention`` over
    the P + S prefix and text rows; decode steps do not call it."""
    m, calls = case["port"], []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    cfg, n = case["ref_cfg"], case["P"] + S
    _, cache = make_prefill(m)(_port_batch(case), m.init_cache(B, n + 1))
    want = ((B, cfg.num_heads, n, cfg.head_dim), (B, cfg.num_kv_heads, n, cfg.head_dim),
            {"causal": True, "window": None, "logit_softcap": 0.0})
    assert calls == [want] * cfg.num_layers
    make_decode_step(m)(torch.from_numpy(case["prompt"][:, -1]).long(), cache, n)
    assert len(calls) == cfg.num_layers


def test_param_shapes_counts_and_cache_layout_match_the_reference_at_full_width():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref = jax.tree.map(lambda x: tuple(x.shape), ref_param_shapes(ref_model))
    assert tree_leaves(param_shapes(ARCH), lambda n: isinstance(n, tuple)) == \
        tree_leaves(ref, lambda n: isinstance(n, tuple))
    assert count_params(ARCH) == count_active_params(ARCH) == 2_508_662_784
    model = build_model(ARCH, device="meta")
    assert isinstance(model, LM)
    cache = model.init_cache(8, 256 + 544)
    want = jax.eval_shape(lambda: ref_model.init_cache(8, 256 + 544))
    assert cache.keys() == want.keys()
    for name, w in want.items():
        assert tuple(cache[name].shape) == tuple(w.shape), name
        assert cache[name].dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name


def test_params_from_jax_rejects_a_wrong_tree(case):
    model = build_model(reduce_for_smoke(get_config(ARCH)), device="cpu")
    tree = case["tree"]
    layers = {**tree["layers"], "w_gate": tree["layers"]["w_gate"][:, :1]}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, {**tree, "layers": layers})
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "enc_norm": tree["embed"]["final_norm"]})
    params_from_jax(model, tree)
    np.testing.assert_array_equal(model.layers[1].w_up.numpy(), tree["layers"]["w_up"][1])


def test_init_is_seeded_and_serves_on_the_cpu():
    cfg = reduce_for_smoke(get_config(ARCH))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    prefix = torch.randn((2, cfg.num_prefix_tokens, cfg.d_model), generator=torch.Generator().manual_seed(4))
    out = generate(a, torch.zeros((2, 10), dtype=torch.int64), 4, extra_batch={"prefix_embed": prefix})
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
