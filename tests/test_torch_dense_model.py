"""The port's dense decoder (``LM``) against the reference ``LM``, on the CPU.

The reference's ``init`` parameters (numpy) are carried over with
``params_from_jax``; both models then see the same tokens, drawn with numpy
from a seed. Two configurations:

- ``reduce_for_smoke(gemma3-1b)``: 6 layers "LLLLLG" (window 8, rope theta
  10k local / 1M global), 2 query heads and 1 KV head, GeGLU. The 12-token
  prompt is longer than the window, so the 'L' layers' window masks in the
  prefill (the flash kernel's plain version) and in each decode step.
- ``reduce_for_smoke(llama3.2-3b)``: 2 'G' layers, 2 KV heads, SwiGLU, so
  the bf16 silu (``layers.silu``) is on the path.

The reference is compiled with ``xla_allow_excess_precision`` off, so that
it rounds each bf16 intermediate where its source rounds, as the port does
(see ``tests/test_torch_rwkv_model.py``). ``generate`` is the reference's
own, compiled with XLA's defaults.

Tolerances: logits (bf16 in both) within atol 2e-2; bf16 caches and block
outputs within rtol = atol = 1e-2.

Layer by layer: the prefill and each teacher-forced decode step of the
reference are also run one layer at a time, through a one-layer reference
``LM`` of the layer's type whose embedding and output head are the
identity (its own ``forward``, ``prefill`` and ``decode_step``), on the
hidden state the previous reference layer produced. Every port block is held
to that layer's output and cache on the same input, so a bf16 rounding flip
in one layer (a bf16 x bf16 product sums in another order in PyTorch than in
XLA) is not carried into the next.
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
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_shapes as ref_param_shapes
from repro.train.serve_step import generate as ref_generate
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import LM, build_model, count_params, param_shapes, tree_leaves
from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

LOGITS_ATOL = 2e-2
BF16_TOL = 1e-2
B, S, NEW, DECODE = 2, 12, 5, 4
#: the reference compiled with the bf16 roundings its source makes
_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
ARCHS = ["gemma3-1b", "llama3.2-3b"]


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


def _same_cache(port: dict, ref: dict, where: str):
    """The port's cache has the reference's keys, shapes and dtypes, and
    its values within the bf16 limit."""
    assert port.keys() == ref.keys() == {"k", "v"}, where
    for name, r in ref.items():
        assert tuple(port[name].shape) == tuple(r.shape), f"{where} {name}"
        assert port[name].dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, f"{where} {name}"
        _close(port[name], r, f"{where} {name}")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's init (seed 0) carried into the port, the prompt and
    the teacher-forced decode tokens."""
    arch = request.param
    ref_cfg = ref_reduce_for_smoke(ref_get_config(arch))
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    port = params_from_jax(build_model(reduce_for_smoke(get_config(arch)), device="cpu"), tree)
    rng = np.random.RandomState(len(arch))
    prompt = rng.randint(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.randint(0, ref_cfg.vocab_size, (DECODE, B)).astype(np.int32)
    return {"arch": arch, "ref_cfg": ref_cfg, "tree": tree, "port": port,
            "prompt": prompt, "forced": forced}


@pytest.fixture(scope="module")
def port_run(case):
    """The port's forward, prefill, teacher-forced decode and generate."""
    m = case["port"]
    prompt = torch.from_numpy(case["prompt"]).long()
    with torch.no_grad():
        fwd, _ = m({"tokens": prompt})
    logits, cache = make_prefill(m)({"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        with torch.inference_mode():
            lg, c = m.decode_step(torch.from_numpy(tok).long(), c, S + i)
        steps.append((lg, c))
    return {"forward": fwd, "prefill": (logits, cache), "decode": steps,
            "generate": generate(m, prompt, NEW)}


def _one_layer(ref_cfg, ltype):
    """A one-layer reference ``LM`` of type ``ltype`` whose embedding and
    output head are the identity: its ``forward`` maps a hidden state
    (B, S, D) to the layer's output, its ``prefill`` to the layer's cache,
    its ``decode_step`` a hidden state (B, D) to the layer's output and
    cache."""
    m = ref_build_model(dataclasses.replace(ref_cfg, num_layers=1, layer_pattern=ltype))
    m._embed = lambda params, h: h
    m._logits = lambda params, h: h
    return {"forward": _strict_jit(m.forward), "prefill": _strict_jit(m.prefill),
            "decode": _strict_jit(m.decode_step)}


@pytest.fixture(scope="module")
def ref_run(case):
    """The reference's runs, whole and layer by layer."""
    m = ref_build_model(case["ref_cfg"])
    cfg = case["ref_cfg"]
    params = jax.tree.map(jnp.asarray, case["tree"])
    prompt = jnp.asarray(case["prompt"])
    fwd, _ = _strict_jit(m.forward)(params, {"tokens": prompt})
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    logits, cache = prefill(params, {"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(S + i))
        steps.append((lg, c))

    one = {t: _one_layer(cfg, t) for t in set(cfg.layer_types())}
    embed = _strict_jit(m._embed)
    layer_params = [{"embed": params["embed"],
                     "layers": jax.tree.map(lambda x, i=i: x[i:i + 1], params["layers"])}
                    for i in range(cfg.num_layers)]
    # the prefill: (h in, h out, k, v) per layer
    h, calls = embed(params["embed"], prompt), []
    for lp, t in zip(layer_params, cfg.layer_types()):
        out, _ = one[t]["forward"](lp, {"tokens": h})
        _, kv = one[t]["prefill"](lp, {"tokens": h}, m.init_cache(B, S + DECODE))
        calls.append((h, out, kv))
        h = out
    layer_calls = [calls]
    # each forced step from the cache the reference's previous call left:
    # (h in, cache in, h out, cache out) per layer
    before = cache
    for i, tok in enumerate(case["forced"]):
        h, calls = embed(params["embed"], jnp.asarray(tok)[:, None])[:, 0], []
        for li, (lp, t) in enumerate(zip(layer_params, cfg.layer_types())):
            kv_in = {n: before[n][li:li + 1] for n in ("k", "v")}
            out, kv = one[t]["decode"](lp, h, kv_in, jnp.int32(S + i))
            calls.append((h, kv_in, out, kv))
            h = out
        layer_calls.append(calls)
        before = steps[i][1]
    return {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache),
            "decode": steps, "layers": layer_calls,
            "generate": np.asarray(ref_generate(m, params, prompt, NEW))}


def test_forward_logits(case, port_run, ref_run):
    assert port_run["forward"].dtype == torch.bfloat16
    _close_logits(port_run["forward"], ref_run["forward"])


def test_prefill_logits_and_cache(case, port_run, ref_run):
    logits, cache = port_run["prefill"]
    assert tuple(logits.shape) == (B, 1, case["ref_cfg"].vocab_size)
    _close_logits(logits, ref_run["prefill"][0])
    _same_cache(cache, ref_run["prefill"][1], "prefill")
    assert not cache["k"][:, :, S:].any()  # the slots after the prompt stay zero


def test_prefill_layer_by_layer(case, ref_run):
    """Each port block on the reference layer's input: its output and its
    keys and values within the bf16 limit. The prefill runs each block's
    attention through the flash kernel's wrapper (its plain version here)."""
    m = case["port"]
    positions = torch.arange(S)
    for i, (h, out, kv) in enumerate(ref_run["layers"][0]):
        with torch.inference_mode():
            got, st = m.layers[i](_to_torch(h), positions)
        _close(got, out, f"layer {i} output")
        for name in ("k", "v"):
            assert st[name].dtype == torch.bfloat16
            _close(st[name], kv[name][0, :, :S], f"layer {i} {name}")


def test_teacher_forced_decode_steps(case, port_run, ref_run):
    for i, ((lg, c), (rlg, rc)) in enumerate(zip(port_run["decode"], ref_run["decode"])):
        _close_logits(lg, rlg)
        _same_cache(c, rc, f"step {i}")


def test_decode_steps_layer_by_layer(case, ref_run):
    """Each port block of each forced step on the reference layer's input
    and cache: output and new cache within the bf16 limit."""
    m = case["port"]
    for step, calls in enumerate(ref_run["layers"][1:]):
        pos = S + step
        for i, (h, kv_in, out, kv) in enumerate(calls):
            state = {n: _to_torch(kv_in[n][0]) for n in ("k", "v")}
            with torch.inference_mode():
                got, st = m.layers[i](_to_torch(h)[:, None], torch.tensor([pos]), state, pos)
            _close(got[:, 0], out, f"step {step} layer {i} output")
            for name in ("k", "v"):
                _close(st[name], kv[name][0], f"step {step} layer {i} {name}")
            # the block writes a copy: the cache it was given is unchanged
            assert torch.equal(state["k"], _to_torch(kv_in["k"][0]))


def test_greedy_generate(case, port_run, ref_run):
    """Greedy tokens agree; where they first differ, the reference's two
    best logits at that step must be a tie within the logits tolerance."""
    out, want = port_run["generate"].numpy(), ref_run["generate"]
    assert out.shape == want.shape == (B, NEW)
    diff = np.argwhere(out != want)
    if diff.size == 0:
        return
    step = int(diff[:, 1].min())
    params, m = ref_run["params"], ref_run["model"]
    logits, c = jax.jit(m.prefill)(params, {"tokens": jnp.asarray(case["prompt"])},
                                   m.init_cache(B, S + NEW))
    logits = logits[:, -1, :]
    for i in range(step):
        logits, c = jax.jit(m.decode_step)(params, jnp.asarray(want[:, i]), c, jnp.int32(S + i))
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
    rows = diff[diff[:, 1] == step, 0]
    gaps = top2[rows, 1] - top2[rows, 0]
    assert (gaps <= LOGITS_ATOL).all(), f"step {step}: top-2 gaps {gaps} are no tie"


def test_prefill_calls_the_flash_wrapper_once_a_layer(case, monkeypatch):
    """Every layer's prefill attention goes through ``flash_attention``
    with the layer's window (None on 'G' layers) and the config's softcap;
    decode steps do not call it."""
    m, calls = case["port"], []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    prompt = torch.from_numpy(case["prompt"]).long()
    _, cache = make_prefill(m)({"tokens": prompt}, m.init_cache(B, S + 1))
    cfg = case["ref_cfg"]
    want = [{"causal": True, "window": cfg.window_size if t == "L" else None,
             "logit_softcap": cfg.logit_softcap} for t in cfg.layer_types()]
    assert calls == want
    make_decode_step(m)(prompt[:, -1], cache, S)
    assert len(calls) == cfg.num_layers


def test_decode_step_takes_an_int_or_a_0d_tensor(case, port_run):
    m = case["port"]
    _, cache = port_run["prefill"]
    tok = torch.from_numpy(case["forced"][0]).long()
    with torch.inference_mode():
        a = m.decode_step(tok, cache, S)
        b = m.decode_step(tok, cache, torch.tensor(S, dtype=torch.int32))
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], port_run["decode"][0][0])
    for name in ("k", "v"):
        assert torch.equal(a[1][name], b[1][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_cache_layout_match_the_reference_at_full_width(arch):
    ref_model = ref_build_model(ref_get_config(arch))
    ref = jax.tree.map(lambda x: tuple(x.shape), ref_param_shapes(ref_model))
    ours = param_shapes(arch)
    assert tree_leaves(ours, lambda n: isinstance(n, tuple)) == \
        tree_leaves(ref, lambda n: isinstance(n, tuple))
    model = build_model(arch, device="meta")
    assert isinstance(model, LM)
    cache = model.init_cache(8, 544)
    want = jax.eval_shape(lambda: ref_model.init_cache(8, 544))
    assert cache.keys() == want.keys()
    for name, w in want.items():
        assert tuple(cache[name].shape) == tuple(w.shape), name
        assert cache[name].dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name


def test_count_params_of_gemma3_1b():
    assert count_params("gemma3-1b") == 999_812_736
    # 26 layers stacked on axis 0, as the reference lays them out
    shapes = param_shapes("gemma3-1b")
    assert shapes["layers"]["wq"] == (26, 1152, 1024)
    assert shapes["layers"]["w_gate"] == (26, 1152, 6912)
    assert shapes["embed"]["tok"] == (262144, 1152) and "head" not in shapes["embed"]


def test_params_from_jax_rejects_a_wrong_tree(case):
    model = build_model(reduce_for_smoke(get_config(case["arch"])), device="cpu")
    tree = case["tree"]
    layers = {**tree["layers"], "wq": tree["layers"]["wq"][:, :1]}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, {**tree, "layers": layers})
    layers = {k: v for k, v in tree["layers"].items() if k != "w_gate"}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "layers": layers})
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "tail": [{"wq": tree["layers"]["wq"][0]}]})
    params_from_jax(model, tree)
    for i, block in enumerate(model.layers):
        np.testing.assert_array_equal(block.wq.detach().numpy(), tree["layers"]["wq"][i])
        np.testing.assert_array_equal(block.w_down.detach().numpy(), tree["layers"]["w_down"][i])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b", "paligemma-3b",
                                  "whisper-base"])
def test_moe_vlm_and_encdec_configs_still_raise(arch):
    """These configurations once raised ``NotImplementedError``; each now
    builds the reference's class: ``EncDecLM`` for whisper, ``LM`` for the
    MoE and VLM ones."""
    want = type(ref_build_model(ref_get_config(arch))).__name__
    assert want == ("EncDecLM" if arch == "whisper-base" else "LM")
    assert type(build_model(arch, device="meta")).__name__ == want


def test_init_is_seeded_and_serves_on_the_cpu():
    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.layers[0].attn_norm.abs().sum()) == 0.0
    assert [blk.window for blk in a.layers] == [8] * 5 + [None]
    assert [blk.theta for blk in a.layers] == [10_000.0] * 5 + [1_000_000.0]
    out = generate(a, torch.zeros((2, 10), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
