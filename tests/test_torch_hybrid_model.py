"""The port's recurrentgemma (``HybridLM``) against the reference
``HybridLM``, on the CPU.

The reference's ``init`` parameters (numpy) are carried over with
``params_from_jax``; both models then see the same tokens, drawn with numpy
from a seed. Each comparison runs against the reference with its Pallas
RG-LRU kernel (interpreted) and with its associative scan. Two
configurations: ``reduce_for_smoke(recurrentgemma-9b)`` (3 layers "RRL",
one stacked period, window 8) and a 5-layer variant (one "RRL" period plus
an "RR" tail). The 12-token prompt is longer than the window, so the
prefill rolls the attention cache and the decode steps overwrite its
slots.

The reference is compiled with ``xla_allow_excess_precision`` off, so that
it rounds each bf16 intermediate where its source rounds, as the port does
(see ``tests/test_torch_rwkv_model.py``). ``generate`` is the reference's
own, compiled with XLA's defaults.

Tolerances: logits (bf16 in both) within atol 2e-2; fp32 states (``h``,
``conv``) within rtol = atol = 1e-3; bf16 caches (``k``, ``v``) within
rtol = atol = 1e-2; cache positions exact.

Where the states are compared: layer by layer, on the reference's inputs.
The free-running runs meet bf16 rounding flips here: a bf16 x bf16 matrix
product (q, for one) sums in another order in PyTorch than in XLA, so now
and then an fp32 result rounds to the neighbouring bf16 value. That ulp
enters the bf16 residual stream, and the next R layer's ``conv`` state (the
fp32 product of the normed stream with ``w_in``) then differs by up to
~6e-3 in the 5-layer model's tail, beyond the fp32 state limit, though the
logits stay within theirs. So the prefill and each decode step of the
reference are run layer by layer (its own ``_layer``, in the order its
``_run_serving`` applies them), and every port block is held to the
reference's output and state on the reference's input. The free-running
logits, the cache layout, the dtypes and the positions are compared as
they come.
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
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (HybridLM, build_model, count_params, param_shapes,
                                      tree_leaves)
from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

LOGITS_ATOL = 2e-2
TOL = {"float32": 1e-3, "bfloat16": 1e-2}
B, S, NEW, DECODE = 2, 12, 5, 4
#: the reference compiled with the bf16 roundings its source makes
_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
ARCH = "recurrentgemma-9b"


def _config(reduce, get, name):
    cfg = reduce(get(ARCH))
    return cfg if name == "smoke" else dataclasses.replace(cfg, name=f"{ARCH}-5l", num_layers=5)


def _np_leaves(tree) -> dict:
    """path -> fp32 / int32 numpy of a reference (jax) or port (torch) tree."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.numpy() if x.dtype == torch.int32 else x.float().numpy()
        x = np.asarray(x)
        return x if x.dtype == np.int32 else x.astype(np.float32)
    return {p: conv(x) for p, x in
            tree_leaves(tree, lambda n: not isinstance(n, (dict, list))).items()}


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == np.int32:
        return torch.from_numpy(a.copy())
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close_state(port: dict, ref: dict, where: str):
    assert port.keys() == ref.keys(), where
    for name, r in ref.items():
        p = port[name]
        assert _dtype_name(p) == str(np.asarray(r).dtype), f"{where} {name}"
        if str(np.asarray(r).dtype) == "int32":
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f"{where} {name}")
        else:
            tol = TOL[_dtype_name(p)]
            np.testing.assert_allclose(p.float().numpy(), np.asarray(r, np.float32), rtol=tol,
                                       atol=tol, err_msg=f"{where} {name}")


def _close_logits(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=LOGITS_ATOL)


def _same_layout(port_cache, ref_cache):
    """The port's cache has the reference's tree, shapes and dtypes, and
    equal positions."""
    port = tree_leaves(port_cache, lambda n: isinstance(n, torch.Tensor))
    ref = tree_leaves(ref_cache, lambda n: not isinstance(n, (dict, list)))
    assert port.keys() == ref.keys()
    for path, r in ref.items():
        assert tuple(port[path].shape) == tuple(np.shape(r)), path
        assert _dtype_name(port[path]) == str(np.asarray(r).dtype), path
        if path[-1] == "pos":
            np.testing.assert_array_equal(port[path].numpy(), np.asarray(r), err_msg=str(path))


@pytest.fixture(scope="module", params=["smoke", "five"])
def case(request):
    """The reference's init (seed 0) carried into the port, the prompt and
    the teacher-forced decode tokens."""
    ref_cfg = _config(ref_reduce_for_smoke, ref_get_config, request.param)
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    port = params_from_jax(
        build_model(_config(reduce_for_smoke, get_config, request.param), device="cpu"), tree)
    rng = np.random.RandomState(len(request.param))
    prompt = rng.randint(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.randint(0, ref_cfg.vocab_size, (DECODE, B)).astype(np.int32)
    return {"name": request.param, "ref_cfg": ref_cfg, "tree": tree, "port": port,
            "prompt": prompt, "forced": forced, "ref": {}}


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


def _per_layer(tree, n_full, period):
    """A stacked reference tree ({"periods", "tail"}) -> one dict per layer."""
    out = [jax.tree.map(lambda x: x[i], tree["periods"][f"l{j}"])
           for i in range(n_full) for j in range(period)]
    return out + list(tree["tail"])


def _ref_layer_calls(run, tokens, cache, pos):
    """The reference's serving pass over ``tokens`` (B, S) from ``cache``,
    layer by layer: [(h in, state in, h out, state out)] per layer."""
    m, params = run["model"], run["params"]
    cfg = m.cfg
    period, n_full = len(cfg.layer_pattern), cfg.num_layers // len(cfg.layer_pattern)
    h = _strict_jit(m._embed)(params["embed"], jnp.asarray(tokens))
    positions = (jnp.arange(tokens.shape[1], dtype=jnp.int32) if tokens.shape[1] > 1
                 else jnp.int32(pos)[None])
    calls = []
    for lp, t, st in zip(_per_layer(params, n_full, period), cfg.layer_types(),
                         _per_layer(cache, n_full, period)):
        h_out, st_out = run["layer"][t](lp, h, positions, st, jnp.int32(pos))
        calls.append((h, st, h_out, st_out))
        h = h_out
    return calls


def _ref_run(case, use_kernels):
    """The reference's runs, computed once per (case, use_kernels)."""
    if use_kernels in case["ref"]:
        return case["ref"][use_kernels]
    m = ref_build_model(case["ref_cfg"], use_kernels=use_kernels)
    params = jax.tree.map(jnp.asarray, case["tree"])
    prompt = jnp.asarray(case["prompt"])
    fwd, _ = _strict_jit(m.forward)(params, {"tokens": prompt})
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    cache0 = m.init_cache(B, S + DECODE)
    logits, cache = prefill(params, {"tokens": prompt}, cache0)
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(S + i))
        steps.append((lg, c))
    run = {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache),
           "decode": steps, "generate": np.asarray(ref_generate(m, params, prompt, NEW)),
           "layer": {t: _strict_jit(lambda lp, h, p, st, pos, t=t: m._layer(lp, t, h, p, st, pos))
                     for t in set(case["ref_cfg"].layer_types())}}
    # each layer's inputs and outputs: the prefill from the empty cache, then
    # each forced step from the cache the reference's previous call left
    run["calls"] = [_ref_layer_calls(run, case["prompt"], cache0, 0)]
    before = cache
    for i, tok in enumerate(case["forced"]):
        run["calls"].append(_ref_layer_calls(run, tok[:, None], before, S + i))
        before = steps[i][1]
    case["ref"][use_kernels] = run
    return run


def _hold_layers_to_the_reference(port: HybridLM, calls, pos):
    """Every port block on the reference's input: output within the bf16
    limit, new state within the state limits."""
    for i, (h, st, h_out, st_out) in enumerate(calls):
        s = np.shape(h)[1]
        positions = torch.arange(s) if s > 1 else torch.tensor([pos])
        with torch.inference_mode():
            got_h, got_st = port.layers[i](_to_torch(h), positions,
                                           {k: _to_torch(v) for k, v in st.items()}, pos)
        np.testing.assert_allclose(got_h.float().numpy(), np.asarray(h_out, np.float32),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"],
                                   err_msg=f"layer {i} output")
        _close_state(got_st, st_out, f"layer {i}")


KERNELS = pytest.mark.parametrize("use_kernels", [True, False], ids=["pallas", "plain"])


@KERNELS
def test_forward_logits(case, port_run, use_kernels):
    ref = _ref_run(case, use_kernels)
    assert port_run["forward"].dtype == torch.bfloat16
    _close_logits(port_run["forward"], ref["forward"])


@KERNELS
def test_prefill_logits_and_cache(case, port_run, use_kernels):
    ref = _ref_run(case, use_kernels)
    logits, cache = port_run["prefill"]
    assert tuple(logits.shape) == (B, 1, case["ref_cfg"].vocab_size)
    _close_logits(logits, ref["prefill"][0])
    _same_layout(cache, ref["prefill"][1])
    _hold_layers_to_the_reference(case["port"], ref["calls"][0], 0)


@KERNELS
def test_teacher_forced_decode_steps(case, port_run, use_kernels):
    ref = _ref_run(case, use_kernels)
    for i, ((lg, c), (rlg, rc)) in enumerate(zip(port_run["decode"], ref["decode"])):
        _close_logits(lg, rlg)
        _same_layout(c, rc)
        _hold_layers_to_the_reference(case["port"], ref["calls"][1 + i], S + i)


@KERNELS
def test_greedy_generate(case, port_run, use_kernels):
    """Greedy tokens agree; where they first differ, the reference's two
    best logits at that step must be a tie within the logits tolerance."""
    ref = _ref_run(case, use_kernels)
    out, want = port_run["generate"].numpy(), ref["generate"]
    assert out.shape == want.shape == (B, NEW)
    diff = np.argwhere(out != want)
    if diff.size == 0:
        return
    step = int(diff[:, 1].min())
    params, m = ref["params"], ref["model"]
    logits, c = jax.jit(m.prefill)(params, {"tokens": jnp.asarray(case["prompt"])},
                                   m.init_cache(B, S + NEW))
    logits = logits[:, -1, :]
    for i in range(step):
        logits, c = jax.jit(m.decode_step)(params, jnp.asarray(want[:, i]), c, jnp.int32(S + i))
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
    rows = diff[diff[:, 1] == step, 0]
    gaps = top2[rows, 1] - top2[rows, 0]
    assert (gaps <= LOGITS_ATOL).all(), f"step {step}: top-2 gaps {gaps} are no tie"


def test_prefill_rolls_the_window_cache(case, port_run):
    """After 12 prompt tokens in a window of 8, the attention cache holds
    positions 4..11 at slots position % 8; a decode step overwrites one."""
    _, cache = port_run["prefill"]
    pos = cache["periods"]["l2"]["pos"][0, 0]
    assert pos.tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    _, after = port_run["decode"][0]
    assert after["periods"]["l2"]["pos"][0, 0].tolist() == [8, 9, 10, 11, 12, 5, 6, 7]


def test_decode_step_takes_an_int_or_a_0d_tensor(case, port_run):
    m = case["port"]
    _, cache = port_run["prefill"]
    tok = torch.from_numpy(case["forced"][0]).long()
    with torch.inference_mode():
        a = m.decode_step(tok, cache, S)
        b = m.decode_step(tok, cache, torch.tensor(S, dtype=torch.int32))
    assert torch.equal(a[0], b[0])
    for x, y in zip(_np_leaves(a[1]).values(), _np_leaves(b[1]).values()):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a[0], port_run["decode"][0][0])


def test_one_token_prompt_takes_the_decode_branch(case):
    """A prompt of one token writes one slot (position 0), as the
    reference's prefill does."""
    m = case["port"]
    ref = ref_build_model(case["ref_cfg"])
    params = jax.tree.map(jnp.asarray, case["tree"])
    tok = case["prompt"][:, :1]
    rl, rc = _strict_jit(ref.prefill)(params, {"tokens": jnp.asarray(tok)}, ref.init_cache(B, 4))
    lg, c = make_prefill(m)({"tokens": torch.from_numpy(tok).long()}, m.init_cache(B, 4))
    _close_logits(lg, rl)
    _same_layout(c, rc)
    assert c["periods"]["l2"]["pos"][0, 0].tolist() == [0] + [-1] * 7


def test_param_shapes_and_cache_layout_match_the_reference_at_full_width():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref = jax.tree.map(lambda x: tuple(x.shape), ref_param_shapes(ref_model))
    ours = param_shapes(ARCH)
    assert tree_leaves(ours, lambda n: isinstance(n, tuple)) == \
        tree_leaves(ref, lambda n: isinstance(n, tuple))
    assert count_params(ARCH) == 9_396_408_320
    # 12 stacked periods and a 2-layer tail, as the reference lays them out
    assert ours["periods"]["l0"]["w_in"] == (12, 4096, 4096) and len(ours["tail"]) == 2
    model = build_model(ARCH, device="meta")
    assert isinstance(model, HybridLM)
    cache = model.init_cache(8, 544)
    want = jax.eval_shape(lambda: ref_model.init_cache(8, 544))
    got = tree_leaves(cache, lambda n: isinstance(n, torch.Tensor))
    want = tree_leaves(want, lambda n: not isinstance(n, (dict, list)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert _dtype_name(got[path]) == str(w.dtype), path


def test_params_from_jax_rejects_a_wrong_tree(case):
    model = build_model(_config(reduce_for_smoke, get_config, case["name"]), device="cpu")
    tree = case["tree"]
    periods = {**tree["periods"], "l0": {**tree["periods"]["l0"],
                                         "w_in": tree["periods"]["l0"]["w_in"][:, :1]}}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, {**tree, "periods": periods})
    periods = {**tree["periods"], "l1": {k: v for k, v in tree["periods"]["l1"].items()
                                         if k != "lam"}}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "periods": periods})
    extra = {k: v[0] for k, v in tree["periods"]["l0"].items()}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "tail": tree["tail"] + [extra]})
    params_from_jax(model, tree)
    np.testing.assert_array_equal(model.layers[2].wq.detach().numpy(),
                                  tree["periods"]["l2"]["wq"][0])
    for i, lp in enumerate(tree["tail"], start=3):
        np.testing.assert_array_equal(model.layers[i].w_out.detach().numpy(), lp["w_out"])


def test_init_is_seeded_and_serves_on_the_cpu():
    cfg = _config(reduce_for_smoke, get_config, "five")
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.layers[0].conv_b.abs().sum()) == 0.0
    assert float(a.embed["final_norm"].abs().sum()) == 0.0
    out = generate(a, torch.zeros((2, 10), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
    nxt, _ = make_decode_step(a)(out[:, -1], a.init_cache(2, 4), 0)
    assert nxt.shape == (2,)
