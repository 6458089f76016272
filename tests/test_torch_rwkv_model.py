"""The port's RWKV-6 model against the reference ``RwkvLM``, on the CPU.

The reference's ``RwkvLM.init`` parameters (numpy) are carried over with
``params_from_jax``; both models then see the same tokens, drawn with numpy
from a seed. Each comparison runs against the reference with its Pallas WKV
kernel (interpreted) and with its plain scan.

The reference's forward, prefill and decode steps are compiled with
``xla_allow_excess_precision`` off. With XLA's default (on), the CPU
compiler may keep a fused bf16 intermediate in fp32 (the residual add ahead
of a norm, for one) and so skip a rounding that the reference's source
makes; the token-shift states are bf16 values, and one skipped rounding
moves many of them by a bf16 ulp (0.4-0.8%, beyond the cache tolerance).
The port rounds where the source rounds, as XLA does with the flag off.
``generate`` is the reference's own, compiled with XLA's defaults.

Tolerances: logits (bf16 in both) within atol 2e-2; caches (fp32 state)
within rtol = atol = 1e-3: room for the fp32 summation order of the scan.
The cache limit is below one bf16 ulp of the token-shift states. Where an
fp32 difference in the last bit (another summation order) rounds a bf16
residual value the other way, the next layer carries that ulp into its
state and the cache comparison fails, though the logits stay close. With
the reference's init at seed 0 no value rounds the other way here; other
draws of the weights (a jitted init differs in the last bit) can meet such
a rounding.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_shapes as ref_param_shapes
from repro.train.serve_step import generate as ref_generate
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, count_params, param_shapes
from repro_torch.train.serve_step import generate, make_prefill

LOGITS_ATOL = 2e-2
CACHE_TOL = 1e-3
B, S, NEW, DECODE = 2, 12, 5, 4
#: the reference compiled with the bf16 roundings its source makes
_strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _ref_config(name):
    cfg = ref_reduce_for_smoke(ref_get_config("rwkv6-3b"))
    if name == "narrow64":  # full head dim of rwkv6-3b at a narrow width
        cfg = dataclasses.replace(cfg, name="rwkv6-narrow64", d_model=128,
                                  num_heads=2, num_kv_heads=2, head_dim=64)
    return cfg


def _port_config(name):
    cfg = reduce_for_smoke(get_config("rwkv6-3b"))
    if name == "narrow64":
        cfg = dataclasses.replace(cfg, name="rwkv6-narrow64", d_model=128,
                                  num_heads=2, num_kv_heads=2, head_dim=64)
    return cfg


def _f32(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close_cache(port, ref):
    assert port.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(_f32(port[name]), _f32(ref[name]), rtol=CACHE_TOL,
                                   atol=CACHE_TOL, err_msg=name)


def _close_logits(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=0, atol=LOGITS_ATOL)


@pytest.fixture(scope="module", params=["smoke", "narrow64"])
def case(request):
    """The reference's init (seed 0) carried into the port, the prompt and
    the teacher-forced decode tokens."""
    ref_cfg = _ref_config(request.param)
    tree = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, tree)
    port = params_from_jax(build_model(_port_config(request.param), device="cpu"), tree)
    rng = np.random.RandomState(len(request.param))
    prompt = rng.randint(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.randint(0, ref_cfg.vocab_size, (DECODE, B)).astype(np.int32)
    return {"name": request.param, "ref_cfg": ref_cfg, "tree": tree, "port": port, "prompt": prompt,
            "forced": forced, "ref": {}}


@pytest.fixture(scope="module")
def port_run(case):
    """The port's forward, prefill, teacher-forced decode and generate."""
    m = case["port"]
    prompt = torch.from_numpy(case["prompt"]).long()
    with torch.no_grad():
        fwd, _ = m({"tokens": prompt})
    logits, cache = make_prefill(m)({"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps = []
    c = cache
    for i, tok in enumerate(case["forced"]):
        lg, c = m.decode_step(torch.from_numpy(tok).long(), c, S + i)
        steps.append((lg, c))
    return {"forward": fwd, "prefill": (logits, cache), "decode": steps,
            "generate": generate(m, prompt, NEW)}


def _ref_run(case, use_kernels):
    """The reference's runs, computed once per (case, use_kernels)."""
    if use_kernels in case["ref"]:
        return case["ref"][use_kernels]
    m = ref_build_model(case["ref_cfg"], use_kernels=use_kernels)
    params = jax.tree.map(jnp.asarray, case["tree"])
    prompt = jnp.asarray(case["prompt"])
    fwd, _ = _strict_jit(m.forward)(params, {"tokens": prompt})
    prefill, decode = _strict_jit(m.prefill), _strict_jit(m.decode_step)
    logits, cache = prefill(params, {"tokens": prompt}, m.init_cache(B, S + DECODE))
    steps = []
    c = cache
    for i, tok in enumerate(case["forced"]):
        lg, c = decode(params, jnp.asarray(tok), c, jnp.int32(S + i))
        steps.append((lg, c))
    run = {"model": m, "params": params, "forward": fwd, "prefill": (logits, cache), "decode": steps,
           "generate": np.asarray(ref_generate(m, params, prompt, NEW))}
    case["ref"][use_kernels] = run
    return run


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
    _close_cache(cache, ref["prefill"][1])


@KERNELS
def test_teacher_forced_decode_steps(case, port_run, use_kernels):
    ref = _ref_run(case, use_kernels)
    for (lg, c), (rlg, rc) in zip(port_run["decode"], ref["decode"]):
        _close_logits(lg, rlg)
        _close_cache(c, rc)


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
    # the reference's logits at ``step``, following its own tokens, compiled
    # as its ``generate`` compiles them
    params, m = ref["params"], ref["model"]
    logits, c = jax.jit(m.prefill)(params, {"tokens": jnp.asarray(case["prompt"])},
                                   m.init_cache(B, S + NEW))
    logits = logits[:, -1, :]
    for i in range(step):
        logits, c = jax.jit(m.decode_step)(params, jnp.asarray(want[:, i]), c, jnp.int32(S + i))
    top2 = np.sort(_f32(logits), axis=-1)[:, -2:]
    rows = diff[diff[:, 1] == step, 0]
    gaps = top2[rows, 1] - top2[rows, 0]
    assert (gaps <= LOGITS_ATOL).all(), f"step {step}: top-2 gaps {gaps} are no tie"


def test_param_shapes_match_the_reference_at_full_width():
    ref = jax.tree.map(lambda x: tuple(x.shape),
                       ref_param_shapes(ref_build_model(ref_get_config("rwkv6-3b"))))
    ref = {g: dict(leaves) for g, leaves in ref.items()}
    assert param_shapes("rwkv6-3b") == ref
    assert count_params("rwkv6-3b") == 2_727_201_280


def test_registry_matches_the_reference():
    assert ARCHS.keys() == REF_ARCHS.keys()
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        assert cfg.layer_types() == REF_ARCHS[name].layer_types()
        assert dataclasses.asdict(reduce_for_smoke(cfg)) == \
            dataclasses.asdict(ref_reduce_for_smoke(REF_ARCHS[name]))


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - {"rwkv6-3b", "recurrentgemma-9b"}))
def test_other_families_are_not_ported_yet(arch):
    """Every other family is ported too: each configuration builds the
    reference's class (``LM`` for the dense, MoE and VLM families,
    ``EncDecLM`` for whisper)."""
    want = type(ref_build_model(REF_ARCHS[arch])).__name__
    assert want == ("EncDecLM" if get_config(arch).is_encdec else "LM")
    assert type(build_model(arch, device="meta")).__name__ == want


def test_hybrid_is_ported():
    model = build_model("recurrentgemma-9b", device="meta")
    assert type(model).__name__ == "HybridLM" and len(model.layers) == 38


def test_params_from_jax_checks_names_and_shapes(case):
    model = build_model(_port_config(case["name"]), device="cpu")
    tree = case["tree"]
    bad = {"embed": tree["embed"], "layers": {**tree["layers"], "w_r": tree["layers"]["w_r"][:, :1]}}
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_jax(model, bad)
    missing = {"embed": tree["embed"], "layers": {k: v for k, v in tree["layers"].items() if k != "u"}}
    with pytest.raises(ValueError, match="names differ"):
        params_from_jax(model, missing)
    params_from_jax(model, tree)
    np.testing.assert_array_equal(model.layers[1].w_o.detach().numpy(), tree["layers"]["w_o"][1])


def test_init_is_seeded_and_temperature_sampling_needs_a_generator():
    cfg = _port_config("smoke")
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.layers[0].decay_base[0]) == -6.0 and float(a.embed["final_norm"].abs().sum()) == 0.0
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="Generator"):
        generate(a, prompt, 3, temperature=1.0)
    out = [generate(a, prompt, 4, temperature=1.0, generator=torch.Generator().manual_seed(5))
           for _ in range(2)]
    assert torch.equal(out[0], out[1]) and out[0].shape == (1, 4)
