"""The port's encoder-decoder (``EncDecLM``, whisper) against the reference
``EncDecLM``, on the CPU.

``reduce_for_smoke(whisper-base)``: 2 encoder and 2 decoder layers, 2
heads of 32, a plain gelu FFN, 16 encoder frames (the conv frontend is a
stub: the frames are numpy draws from a seed). The encoder attends without
rope and without a mask, then ``enc_norm``; each decoder layer attends
causally with rope over the tokens, then without a mask over the encoder's
output (cross attention, no rope). In the prefill all three attentions go
through the flash kernel's wrapper; a decode step attends over the cache
with the plain attention and computes the cross keys and values from the
cached ``enc_out``.

As ``tests/test_torch_dense_model.py``: the reference compiled with
``xla_allow_excess_precision`` off; logits within atol 2e-2, bf16 caches,
encoder outputs and block outputs within rtol = atol = 1e-2. Layer by
layer: each encoder block on the reference layer's input (the reference's
encoder layer, its scan body written out with the reference's own layer
functions), each decoder block through the reference's ``_dec_block`` on
the same hidden state and encoder output, in the prefill and in each
teacher-forced decode step.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_L
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import EncDecLM as RefEncDecLM
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_shapes as ref_param_shapes
from repro.train.serve_step import generate as ref_generate
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (EncDecLM, build_model, count_active_params, count_params,
                                      param_shapes, tree_leaves)
from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

LOGITS_ATOL = 2e-2
BF16_TOL = 1e-2
ARCH = "whisper-base"
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


def _same_cache(port, ref, where):
    assert port.keys() == ref.keys() == {"k", "v", "enc_out"}, where
    for name, r in ref.items():
        assert tuple(port[name].shape) == tuple(r.shape), f"{where} {name}"
        assert port[name].dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, f"{where} {name}"
        _close(port[name], r, f"{where} {name}")


@pytest.fixture(scope="module")
def case():
    ref_cfg = ref_reduce_for_smoke(ref_get_config(ARCH))
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    port = params_from_jax(build_model(reduce_for_smoke(get_config(ARCH)), device="cpu"), tree)
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.randn(B, ref_cfg.encoder_seq, ref_cfg.d_model).astype(np.float32)
    forced = rng.randint(0, ref_cfg.vocab_size, (DECODE, B)).astype(np.int32)
    return {"ref_cfg": ref_cfg, "tree": tree, "port": port, "prompt": prompt,
            "frames": frames, "forced": forced}


def _port_batch(case):
    return {"tokens": torch.from_numpy(case["prompt"]).long(),
            "frames": torch.from_numpy(case["frames"])}


@pytest.fixture(scope="module")
def port_run(case):
    m = case["port"]
    batch = _port_batch(case)
    with torch.no_grad():
        fwd = m(batch)
    logits, cache = make_prefill(m)(batch, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        with torch.inference_mode():
            lg, c = m.decode_step(torch.from_numpy(tok).long(), c, S + i)
        steps.append((lg, c))
    gen = generate(m, batch["tokens"], NEW, extra_batch={"frames": case["frames"]})
    return {"forward": fwd, "prefill": (logits, cache), "decode": steps, "generate": gen}


def _ref_encoder_layer(m: RefEncDecLM):
    """One reference encoder layer: the body of ``EncDecLM._encode``'s scan,
    written out with the reference's layer functions."""
    cfg = m.cfg

    def layer(lp, h):
        positions = jnp.arange(h.shape[1], dtype=jnp.int32)
        x = ref_L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = ref_L.attn_qkv(lp, x, m.dims)
        o = ref_L.attend(q, k, v, positions, positions, causal=False)
        h = h + ref_L.attn_out(lp, o)
        x = ref_L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        return h + ref_L.ffn_apply(lp, x, cfg.act, cfg.glu)

    return _strict_jit(layer)


@pytest.fixture(scope="module")
def ref_run(case):
    cfg = case["ref_cfg"]
    m = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["tree"])
    batch = {"tokens": jnp.asarray(case["prompt"]), "frames": jnp.asarray(case["frames"])}
    fwd = _strict_jit(m.forward)(params, batch)
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    logits, cache = prefill(params, batch, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(S + i))
        steps.append((lg, c))

    # the encoder, layer by layer: (h in, h out)
    enc_layer = _ref_encoder_layer(m)
    h, enc_calls = ref_L.cast(batch["frames"]), []
    for i in range(cfg.encoder_layers):
        lp = jax.tree.map(lambda x, i=i: x[i], params["encoder"])
        out = enc_layer(lp, h)
        enc_calls.append((h, out))
        h = out
    enc_out = _strict_jit(m._encode)(params, batch["frames"])
    # the decoder, layer by layer, on the reference's encoder output
    dec_block = _strict_jit(m._dec_block)
    embed = _strict_jit(m._embed)
    dec = [jax.tree.map(lambda x, i=i: x[i], params["decoder"]) for i in range(cfg.num_layers)]
    positions = jnp.arange(S, dtype=jnp.int32)
    h, calls = embed(params["embed"], batch["tokens"]), []
    for lp in dec:
        out, (k, v) = dec_block(lp, h, enc_out, positions)
        calls.append((h, out, {"k": k, "v": v}))
        h = out
    layer_calls = [calls]
    before = cache
    for i, tok in enumerate(case["forced"]):
        h, calls = embed(params["embed"], jnp.asarray(tok)[:, None]), []
        pos = jnp.int32(S + i)
        for li, lp in enumerate(dec):
            kv_in = {n: before[n][li] for n in ("k", "v")}
            out, (k, v) = dec_block(lp, h, enc_out, pos[None], kv_in["k"], kv_in["v"], pos)
            calls.append((h, kv_in, out, {"k": k, "v": v}))
            h = out
        layer_calls.append(calls)
        before = steps[i][1]
    gen = ref_generate(m, params, batch["tokens"], NEW, extra_batch={"frames": batch["frames"]})
    return {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache),
            "decode": steps, "encoder": enc_calls, "enc_out": enc_out, "layers": layer_calls,
            "generate": np.asarray(gen)}


def test_forward_logits(case, port_run, ref_run):
    logits, aux = port_run["forward"]
    assert logits.dtype == torch.bfloat16
    _close_logits(logits, ref_run["forward"][0])
    assert float(aux) == 0.0


def test_prefill_logits_and_cache(case, port_run, ref_run):
    logits, cache = port_run["prefill"]
    assert tuple(logits.shape) == (B, 1, case["ref_cfg"].vocab_size)
    _close_logits(logits, ref_run["prefill"][0])
    _same_cache(cache, ref_run["prefill"][1], "prefill")
    assert not cache["k"][:, :, S:].any()


def test_encoder_layer_by_layer(case, ref_run):
    """Each port encoder block on the reference layer's input, and the
    encoder's output (after ``enc_norm``), within the bf16 limit."""
    m = case["port"]
    with torch.inference_mode():
        for i, (h, out) in enumerate(ref_run["encoder"]):
            _close(m.encoder[i](_to_torch(h)), out, f"encoder layer {i}")
        enc_out = m.encode(torch.from_numpy(case["frames"]))
    assert enc_out.dtype == torch.bfloat16
    _close(enc_out, ref_run["enc_out"], "encoder output")


def test_decoder_prefill_layer_by_layer(case, ref_run):
    """Each port decoder block on the reference layer's input and the
    reference's encoder output: output and keys and values within the bf16
    limit."""
    m, enc_out = case["port"], _to_torch(ref_run["enc_out"])
    positions = torch.arange(S)
    for i, (h, out, kv) in enumerate(ref_run["layers"][0]):
        with torch.inference_mode():
            got, st = m.decoder[i](_to_torch(h), enc_out, positions)
        _close(got, out, f"layer {i} output")
        for name in ("k", "v"):
            assert st[name].dtype == torch.bfloat16
            _close(st[name], kv[name], f"layer {i} {name}")


def test_teacher_forced_decode_steps(case, port_run, ref_run):
    for i, ((lg, c), (rlg, rc)) in enumerate(zip(port_run["decode"], ref_run["decode"])):
        _close_logits(lg, rlg)
        _same_cache(c, rc, f"step {i}")
        # the encoder's output rides along unchanged
        assert torch.equal(c["enc_out"], port_run["prefill"][1]["enc_out"])


def test_decode_steps_layer_by_layer(case, ref_run):
    """Each port decoder block of each forced step on the reference layer's
    input, cache and encoder output: output and new cache within the bf16
    limit; the cache it was given is unchanged."""
    m, enc_out = case["port"], _to_torch(ref_run["enc_out"])
    for step, calls in enumerate(ref_run["layers"][1:]):
        pos = S + step
        for i, (h, kv_in, out, kv) in enumerate(calls):
            state = {n: _to_torch(kv_in[n]) for n in ("k", "v")}
            with torch.inference_mode():
                got, st = m.decoder[i](_to_torch(h), enc_out, torch.tensor([pos]), state, pos)
            _close(got, out, f"step {step} layer {i} output")
            for name in ("k", "v"):
                _close(st[name], kv[name], f"step {step} layer {i} {name}")
            assert torch.equal(state["k"], _to_torch(kv_in["k"]))


def test_greedy_generate_with_frames(case, port_run, ref_run):
    """``generate(..., extra_batch={"frames": ...})`` gives the reference's
    greedy tokens."""
    np.testing.assert_array_equal(port_run["generate"].numpy(), ref_run["generate"])


def test_prefill_calls_the_flash_wrapper_for_every_attention(case, monkeypatch):
    """The prefill attends through ``flash_attention``: each encoder layer
    without a mask over the F frames, then each decoder layer causally over
    the S tokens and without a mask from the S tokens over the F frames;
    decode steps do not call it."""
    m, calls = case["port"], []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))  # (B, H, S, D)
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    cfg = case["ref_cfg"]
    F = cfg.encoder_seq
    _, cache = make_prefill(m)(_port_batch(case), m.init_cache(B, S + 1))
    want = [(F, F, False)] * cfg.encoder_layers + [(S, S, True), (S, F, False)] * cfg.num_layers
    assert calls == want
    make_decode_step(m)(torch.from_numpy(case["prompt"][:, -1]).long(), cache, S)
    assert len(calls) == len(want)


def test_param_shapes_counts_and_cache_layout_match_the_reference_at_full_width():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref = jax.tree.map(lambda x: tuple(x.shape), ref_param_shapes(ref_model))
    ours = param_shapes(ARCH)
    assert tree_leaves(ours, lambda n: isinstance(n, tuple)) == \
        tree_leaves(ref, lambda n: isinstance(n, tuple))
    assert ours["encoder"]["wq"] == (6, 512, 512) and ours["decoder"]["x_wk"] == (6, 512, 512)
    assert ours["enc_norm"] == (512,) and "w_gate" not in ours["decoder"]
    assert count_params(ARCH) == count_active_params(ARCH) == 70_611_456
    model = build_model(ARCH, device="meta")
    assert isinstance(model, EncDecLM)
    cache = model.init_cache(8, 96)
    want = jax.eval_shape(lambda: ref_model.init_cache(8, 96))
    assert cache.keys() == want.keys() == {"k", "v", "enc_out"}
    for name, w in want.items():
        assert tuple(cache[name].shape) == tuple(w.shape), name
        assert cache[name].dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name


def test_params_from_jax_takes_the_encdec_tree(case):
    model = build_model(reduce_for_smoke(get_config(ARCH)), device="cpu")
    tree = case["tree"]
    dec = {**tree["decoder"], "x_wq": tree["decoder"]["x_wq"][:, :1]}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, {**tree, "decoder": dec})
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {k: v for k, v in tree.items() if k != "enc_norm"})
    enc = {k: v for k, v in tree["encoder"].items() if k != "wo"}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "encoder": enc})
    params_from_jax(model, tree)
    np.testing.assert_array_equal(model.enc_norm.numpy(), tree["enc_norm"])
    for i, block in enumerate(model.decoder):
        np.testing.assert_array_equal(block.x_wv.numpy(), tree["decoder"]["x_wv"][i])
    for i, block in enumerate(model.encoder):
        np.testing.assert_array_equal(block.w_down.numpy(), tree["encoder"]["w_down"][i])


def test_init_is_seeded_and_serves_on_the_cpu():
    cfg = reduce_for_smoke(get_config(ARCH))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.enc_norm.abs().sum()) == 0.0
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=torch.Generator().manual_seed(4))
    out = generate(a, torch.zeros((2, 10), dtype=torch.int64), 4, extra_batch={"frames": frames})
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
