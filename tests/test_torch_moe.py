"""The port's MoE FFN (``repro_torch.models.moe``) and MoE models (``LM``
with experts) against the reference, on the CPU.

``moe_ffn`` alone: the same numpy-seeded parameters and inputs go through
the reference's ``repro.models.moe.moe_ffn`` (run eagerly, so that each
operation rounds at its own output, and spied on: ``lax.top_k``'s expert
ids and the (G, Tg, E, C) combine tensor it shards) and the port's. The
output is held within the bf16 limit, the aux loss within 1e-6 relative,
and the routing exactly: the expert ids, each choice's position in its
expert (the reference's cumulative count over its ids), the ``keep`` mask
and which (token, expert, slot) entries of the bf16 combine tensor are set;
their bf16 gates within one bf16 rounding (the fp32 softmax sums in
another order, and a gate can round the other way). One case biases the router
so that one expert is chosen by more tokens of a group than its capacity.
The reference's own MoE cases (``tests/test_data_and_moe.py``) are ported
beside them.

The models: ``reduce_for_smoke`` of deepseek-moe-16b (4 experts, 1 shared,
top-2) and phi3.5-moe-42b (4 experts, top-2), as
``tests/test_torch_dense_model.py`` holds the dense ones: the reference
compiled with ``xla_allow_excess_precision`` off, forward, prefill,
teacher-forced decode steps and greedy tokens equal, and each block held
layer by layer on the reference layer's input (a one-layer reference
``LM`` with identity embedding and head). Logits within atol 2e-2, bf16
caches and block outputs within rtol = atol = 1e-2.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro.models.model import count_active_params as ref_count_active_params
from repro.models.model import param_shapes as ref_param_shapes
from repro.train.serve_step import generate as ref_generate
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import moe
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (LM, build_model, count_active_params, count_params,
                                      param_shapes, tree_leaves)
from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

LOGITS_ATOL = 2e-2
BF16_TOL = 1e-2
AUX_RTOL = 1e-6
_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close(port, ref, where, tol=BF16_TOL):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol, err_msg=where)


# ------------------------------------------------------------------ #
# moe_ffn alone
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class MoeCase:
    e: int
    k: int
    d: int
    f: int
    shared: int
    glu: bool
    act: str
    cf: float
    b: int
    s: int
    #: added to the router's column of expert 0 on the input's first
    #: feature, which every token carries at +1: expert 0 overflows
    bias: float = 0.0


MOE_CASES = {
    # deepseek-like: fine-grained experts, top-3, shared experts; 96 tokens
    # in 32 groups of 3
    "shared-top3": MoeCase(8, 3, 32, 16, 2, True, "silu", 1.25, 2, 48),
    # phi3.5-like: top-2, no shared expert; 40 tokens in 20 groups of 2
    "top2": MoeCase(4, 2, 32, 24, 0, True, "silu", 1.25, 1, 40),
    # a plain (non-GLU) gelu FFN, top-1
    "gelu-top1": MoeCase(4, 1, 16, 32, 0, False, "gelu", 1.0, 2, 8),
    # 1,280 tokens in 32 groups of 40 (capacity 32): expert 0 is every
    # token's first choice and drops 8 a group
    "overflow": MoeCase(4, 2, 32, 16, 1, True, "silu", 1.25, 2, 640, bias=8.0),
}


def _moe_inputs(case: MoeCase, seed: int):
    """numpy parameters (the reference's names) and x (B, S, D) bf16."""
    rng = np.random.RandomState(seed)
    shapes = moe.moe_param_shapes(case.d, case.e, case.f, case.shared, case.glu)
    params = {n: (rng.randn(*s) / np.sqrt(s[-2])).astype(np.float32) for n, s in shapes.items()}
    params["router"] *= 0.5
    x = rng.randn(case.b, case.s, case.d).astype(np.float32) * 0.5
    if case.bias:
        x[..., 0] = 1.0
        params["router"][0, 0] += case.bias
    return params, np.asarray(jnp.asarray(x, jnp.bfloat16))


def _port_moe(case: MoeCase, params) -> moe.MoE:
    m = moe.MoE(case.d, case.e, case.f, case.shared, case.k, case.cf, case.act, case.glu, "cpu")
    with torch.no_grad():
        for name, value in params.items():
            getattr(m, name).copy_(torch.from_numpy(value))
    return m


def _ref_moe(case: MoeCase, params, x, monkeypatch):
    """The reference's moe_ffn, eagerly: (y, aux, ids, combine)."""
    seen = {}
    real_top_k, real_shard = jax.lax.top_k, ref_moe.shard

    def top_k(probs, k):
        out = real_top_k(probs, k)
        seen["ids"] = np.asarray(out[1])
        return out

    def shard(arr, *axes):
        if axes == ("batch", None, "expert", "cap"):
            seen["combine"] = np.asarray(arr)
        return real_shard(arr, *axes)

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", top_k)
        mp.setattr(ref_moe, "shard", shard)
        y, aux = ref_moe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                 num_experts=case.e, top_k=case.k,
                                 capacity_factor=case.cf, act=case.act, glu=case.glu)
    return np.asarray(y), float(aux), seen["ids"], seen["combine"]


def _positions(ids: np.ndarray, e: int) -> np.ndarray:
    """The reference's positions: the cumulative count of each expert over
    a group's (Tg K) choices in token-major order, less one."""
    g, tg, k = ids.shape
    one_hot = np.eye(e, dtype=np.int64)[ids].reshape(g, tg * k, e)
    pos = (np.cumsum(one_hot, axis=1) - 1).reshape(g, tg, k, e)
    return np.take_along_axis(pos, ids[..., None], axis=-1)[..., 0]


@functools.lru_cache(maxsize=None)
def _moe_pair(name: str) -> dict:
    """The port's (y, aux, routing, combine) and the reference's (y, aux,
    ids, combine) of MOE_CASES[name]."""
    case = MOE_CASES[name]
    params, x = _moe_inputs(case, seed=len(name))
    m = _port_moe(case, params)
    xt = _to_torch(x)
    with torch.no_grad():
        y, aux = m(xt)
        r = m.route(xt)
        combine = moe.combine_tensor(r, case.e)
    with pytest.MonkeyPatch.context() as mp:
        ref = _ref_moe(case, params, x, mp)
    return {"case": case, "port": (y, float(aux), r, combine), "ref": ref}


@pytest.fixture(params=sorted(MOE_CASES))
def moe_pair(request):
    return _moe_pair(request.param)


def test_moe_ffn_output_and_aux_match_the_reference(moe_pair):
    (y, aux, _, _), (ry, raux, _, _) = moe_pair["port"], moe_pair["ref"]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == ry.shape
    _close(y, ry, "moe output")
    assert abs(aux - raux) <= AUX_RTOL * abs(raux), (aux, raux)


def test_moe_ffn_routing_is_exact(moe_pair):
    """Expert ids, positions, keep and the combine tensor's pattern equal
    the reference's."""
    case = moe_pair["case"]
    _, _, r, combine = moe_pair["port"]
    _, _, ids, ref_combine = moe_pair["ref"]
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    pos = _positions(ids, case.e)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    capacity = ref_moe.capacity_for(ids.shape[1], case.e, case.k, case.cf)
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.keep.numpy(), pos < capacity)
    # the dispatch pattern exactly; the gates, whose fp32 softmax sums in
    # another order, within one bf16 rounding
    assert combine.dtype == torch.bfloat16 and tuple(combine.shape) == ref_combine.shape
    np.testing.assert_array_equal(_f32(combine) > 0, _f32(ref_combine) > 0)
    np.testing.assert_allclose(_f32(combine), _f32(ref_combine), rtol=2.0 ** -7, atol=0)


def test_moe_overflow_case_drops_tokens():
    """The biased router sends every token of a group to expert 0 first,
    past its capacity: the port's combine keeps exactly ``capacity`` of
    them (and the reference's the same, test_moe_ffn_routing_is_exact)."""
    _, _, r, combine = _moe_pair("overflow")["port"]
    assert bool((r.ids[..., 0] == 0).all())
    kept = (combine[:, :, 0] > 0).sum(dim=(1, 2))
    assert kept.tolist() == [r.capacity] * r.ids.shape[0]
    assert int((~r.keep).sum()) == r.ids.shape[0] * (r.ids.shape[1] - r.capacity)


def test_moe_ffn_reads_nothing_back_to_the_host():
    """moe_ffn runs on the ``meta`` device, which has no values: no shape
    or branch of it comes from data."""
    m = moe.MoE(16, 4, 32, 1, 2, 1.25, "silu", True, "meta")
    y, aux = m(torch.empty((2, 40, 16), dtype=torch.bfloat16, device="meta"))
    assert y.shape == (2, 40, 16) and y.dtype == torch.bfloat16 and aux.shape == ()


def test_top_k_takes_the_lower_expert_first_on_a_tie():
    """Equal probabilities (a zero router) rank the lower expert id first,
    as ``lax.top_k`` does."""
    r = moe.route(torch.zeros(8, 6), torch.randn(2, 5, 8), num_experts=6, top_k=3,
                  capacity_factor=1.0)
    assert r.ids.tolist() == [[[0, 1, 2]] * 5] * 2
    assert torch.equal(r.gates, torch.full((2, 5, 3), 1 / 3))


@pytest.mark.parametrize("tokens,e,k,cf", list(itertools.product(
    (1, 3, 40, 128, 4096), (4, 16, 64), (1, 2, 6), (0.1, 1.0, 1.25))))
def test_capacity_for_matches_the_reference(tokens, e, k, cf):
    assert moe.capacity_for(tokens, e, k, cf) == ref_moe.capacity_for(tokens, e, k, cf)


# ---- the reference's MoE cases (tests/test_data_and_moe.py), ported ----


def _setup(e=4, k=2, d=16, f=32, shared=0, glu=True, act="silu", cf=1.25, b=2, s=8, seed=0):
    case = MoeCase(e, k, d, f, shared, glu, act, cf, b, s)
    params, x = _moe_inputs(case, seed)
    return case, params, x


def test_moe_output_shape_and_finite():
    case, params, x = _setup()
    y, aux = _port_moe(case, params)(_to_torch(x))
    assert y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())
    assert float(aux) > 0  # the Switch aux loss is positive


def test_moe_aux_loss_near_one_for_uniform_router(monkeypatch):
    """With uniform routing, E sum(f_e P_e) ~ 1; equal to the reference's."""
    case, params, x = _setup()
    params["router"] = np.zeros_like(params["router"])
    _, aux = _port_moe(case, params)(_to_torch(x))
    assert 0.5 < float(aux) < 2.0
    _, raux, _, _ = _ref_moe(case, params, x, monkeypatch)
    assert abs(float(aux) - raux) <= AUX_RTOL * raux


def test_moe_group_count_divides_tokens():
    for t in (1, 2, 31, 32, 64, 100, 4096, 128 * 4096):
        g = moe._num_groups(t)
        assert t % g == 0
        assert 1 <= g <= max(moe.DISPATCH_GROUPS, 1)
        assert g == ref_moe._num_groups(t)


def test_moe_group_target_knob(monkeypatch):
    monkeypatch.setattr(moe, "DISPATCH_TARGET_TG", 2048)
    monkeypatch.setattr(ref_moe, "DISPATCH_TARGET_TG", 2048)
    t = 1024 * 1024
    g = moe._num_groups(t)
    assert t % g == 0
    assert t // g <= 2048 * 2  # group size near the target
    assert g == ref_moe._num_groups(t)


def test_moe_capacity_drops_overflow_gracefully():
    """With capacity factor << 1, outputs shrink toward zero but stay
    finite (dropped tokens contribute nothing)."""
    case, params, x = _setup(cf=2.0)
    y_full, _ = _port_moe(case, params)(_to_torch(x))
    case, params, x = _setup(cf=0.1)
    y_tight, _ = _port_moe(case, params)(_to_torch(x))
    assert bool(torch.isfinite(y_tight.float()).all())
    assert float(y_tight.float().norm()) <= float(y_full.float().norm())


def test_moe_shared_experts_add_dense_path():
    case, params, x = _setup(shared=2, b=1, s=4, seed=3)
    y, _ = _port_moe(case, params)(_to_torch(x))
    # zero the routed experts: the shared path must still produce signal
    for name in ("we_up", "we_down", "we_gate"):
        params[name] = np.zeros_like(params[name])
    y_shared, _ = _port_moe(case, params)(_to_torch(x))
    assert float(y_shared.float().norm()) > 0
    assert not torch.equal(y, y_shared)


@pytest.mark.parametrize("t,e,k", list(itertools.product((8, 16, 64), (2, 4, 8), (1, 2))))
def test_moe_finite_everywhere_and_equal_to_the_reference(t, e, k, monkeypatch):
    """The reference's property case (plain gelu FFN, capacity factor 1) over
    its whole domain, each held to the reference."""
    case, params, x = _setup(e=e, k=k, d=8, f=16, glu=False, act="gelu", cf=1.0, b=1, s=t,
                             seed=t * e + k)
    y, aux = _port_moe(case, params)(_to_torch(x))
    assert y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(aux))
    ry, raux, _, _ = _ref_moe(case, params, x, monkeypatch)
    _close(y, ry, "moe output")
    assert abs(float(aux) - raux) <= AUX_RTOL * abs(raux)


# ------------------------------------------------------------------ #
# MoE models (LM with experts)
# ------------------------------------------------------------------ #

B, S, NEW, DECODE = 2, 12, 5, 4
ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
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
    m = case["port"]
    prompt = torch.from_numpy(case["prompt"]).long()
    with torch.no_grad():
        fwd = m({"tokens": prompt})
    logits, cache = make_prefill(m)({"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        with torch.inference_mode():
            lg, c = m.decode_step(torch.from_numpy(tok).long(), c, S + i)
        steps.append((lg, c))
    return {"forward": fwd, "prefill": (logits, cache), "decode": steps,
            "generate": generate(m, prompt, NEW)}


def _one_layer(ref_cfg):
    """A one-layer reference ``LM`` whose embedding and head are the
    identity."""
    m = ref_build_model(dataclasses.replace(ref_cfg, num_layers=1))
    m._embed = lambda params, h: h
    m._logits = lambda params, h: h
    return {"forward": _strict_jit(m.forward), "prefill": _strict_jit(m.prefill),
            "decode": _strict_jit(m.decode_step)}


@pytest.fixture(scope="module")
def ref_run(case):
    m = ref_build_model(case["ref_cfg"])
    cfg = case["ref_cfg"]
    params = jax.tree.map(jnp.asarray, case["tree"])
    prompt = jnp.asarray(case["prompt"])
    fwd = _strict_jit(m.forward)(params, {"tokens": prompt})
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    logits, cache = prefill(params, {"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps, c = [], cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(S + i))
        steps.append((lg, c))

    one = _one_layer(cfg)
    embed = _strict_jit(m._embed)
    layer_params = [{"embed": params["embed"],
                     "layers": jax.tree.map(lambda x, i=i: x[i:i + 1], params["layers"])}
                    for i in range(cfg.num_layers)]
    h, calls = embed(params["embed"], prompt), []
    for lp in layer_params:
        out, _ = one["forward"](lp, {"tokens": h})
        _, kv = one["prefill"](lp, {"tokens": h}, m.init_cache(B, S + DECODE))
        calls.append((h, out, kv))
        h = out
    layer_calls = [calls]
    before = cache
    for i, tok in enumerate(case["forced"]):
        h, calls = embed(params["embed"], jnp.asarray(tok)[:, None])[:, 0], []
        for li, lp in enumerate(layer_params):
            kv_in = {n: before[n][li:li + 1] for n in ("k", "v")}
            out, kv = one["decode"](lp, h, kv_in, jnp.int32(S + i))
            calls.append((h, kv_in, out, kv))
            h = out
        layer_calls.append(calls)
        before = steps[i][1]
    return {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache),
            "decode": steps, "layers": layer_calls,
            "generate": np.asarray(ref_generate(m, params, prompt, NEW))}


def test_forward_logits_and_aux_loss(case, port_run, ref_run):
    """Logits within atol 2e-2; the aux loss (the layers' mean) within 1e-3
    relative: the layers' bf16 inputs differ by roundings, which move the
    router's mean probabilities a little."""
    (logits, aux), (rlogits, raux) = port_run["forward"], ref_run["forward"]
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == rlogits.shape
    np.testing.assert_allclose(_f32(logits), _f32(rlogits), rtol=0, atol=LOGITS_ATOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-3)


def test_prefill_logits_and_cache(case, port_run, ref_run):
    logits, cache = port_run["prefill"]
    rlogits, rcache = ref_run["prefill"]
    np.testing.assert_allclose(_f32(logits), _f32(rlogits), rtol=0, atol=LOGITS_ATOL)
    assert cache.keys() == rcache.keys() == {"k", "v"}
    for name in cache:
        assert cache[name].dtype == torch.bfloat16 and tuple(cache[name].shape) == rcache[name].shape
        _close(cache[name], rcache[name], name)


def test_prefill_layer_by_layer(case, ref_run):
    """Each port block (attention and MoE) on the reference layer's input:
    output and keys and values within the bf16 limit."""
    m = case["port"]
    positions = torch.arange(S)
    for i, (h, out, kv) in enumerate(ref_run["layers"][0]):
        with torch.inference_mode():
            got, st = m.layers[i](_to_torch(h), positions)
        _close(got, out, f"layer {i} output")
        for name in ("k", "v"):
            _close(st[name], kv[name][0, :, :S], f"layer {i} {name}")


def test_teacher_forced_decode_steps(case, port_run, ref_run):
    for i, ((lg, c), (rlg, rc)) in enumerate(zip(port_run["decode"], ref_run["decode"])):
        np.testing.assert_allclose(_f32(lg), _f32(rlg), rtol=0, atol=LOGITS_ATOL)
        for name in ("k", "v"):
            _close(c[name], rc[name], f"step {i} {name}")


def test_decode_steps_layer_by_layer(case, ref_run):
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
    m, calls = case["port"], []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    prompt = torch.from_numpy(case["prompt"]).long()
    _, cache = make_prefill(m)({"tokens": prompt}, m.init_cache(B, S + 1))
    cfg = case["ref_cfg"]
    assert calls == [{"causal": True, "window": None, "logit_softcap": 0.0}] * cfg.num_layers
    make_decode_step(m)(prompt[:, -1], cache, S)
    assert len(calls) == cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_counts_and_cache_layout_match_the_reference_at_full_width(arch):
    ref_model = ref_build_model(ref_get_config(arch))
    ref = jax.tree.map(lambda x: tuple(x.shape), ref_param_shapes(ref_model))
    assert tree_leaves(param_shapes(arch), lambda n: isinstance(n, tuple)) == \
        tree_leaves(ref, lambda n: isinstance(n, tuple))
    assert count_active_params(arch) == ref_count_active_params(ref_model)
    model = build_model(arch, device="meta")
    assert isinstance(model, LM) and all(b.moe is not None for b in model.layers)
    cache = model.init_cache(8, 544)
    want = jax.eval_shape(lambda: ref_model.init_cache(8, 544))
    assert cache.keys() == want.keys()
    for name, w in want.items():
        assert tuple(cache[name].shape) == tuple(w.shape), name
        assert cache[name].dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name


def test_counts_of_the_moe_models():
    assert count_params("deepseek-moe-16b") == 16_879_568_896
    assert count_active_params("deepseek-moe-16b") == 2_830_747_648
    assert count_params("phi3.5-moe-42b") == 41_872_527_360
    assert count_active_params("phi3.5-moe-42b") == 6_640_373_760
    shapes = param_shapes("deepseek-moe-16b")["layers"]["moe"]
    assert shapes["we_up"] == (28, 64, 2048, 1408)
    assert shapes["w_gate"] == (28, 2048, 2 * 1408)
    assert "w_up" not in param_shapes("phi3.5-moe-42b")["layers"]["moe"]


def test_params_from_jax_takes_the_moe_subtree(case):
    model = build_model(reduce_for_smoke(get_config(case["arch"])), device="cpu")
    tree = case["tree"]
    bad = {**tree["layers"]["moe"], "we_up": tree["layers"]["moe"]["we_up"][:, :1]}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, {**tree, "layers": {**tree["layers"], "moe": bad}})
    bad = {k: v for k, v in tree["layers"]["moe"].items() if k != "router"}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "layers": {**tree["layers"], "moe": bad}})
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, {**tree, "layers": {**tree["layers"],
                                                   "w_up": tree["layers"]["moe"]["we_up"]}})
    params_from_jax(model, tree)
    for i, block in enumerate(model.layers):
        np.testing.assert_array_equal(block.moe.we_down.numpy(), tree["layers"]["moe"]["we_down"][i])
        np.testing.assert_array_equal(block.moe.router.numpy(), tree["layers"]["moe"]["router"][i])


def test_init_is_seeded_and_serves_on_the_cpu():
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b"))
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert {n for n, _ in a.layers[0].moe.named_parameters()} == {
        "router", "we_up", "we_gate", "we_down", "w_up", "w_gate", "w_down"}
    out = generate(a, torch.zeros((2, 10), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
