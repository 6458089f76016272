"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on identical seeded trees: the learning-rate
schedules at every step, the global norm and clipping within rtol 1e-6
element by element, and three updates with each parameter, first and
second moment leaf within 1e-6 of the reference's normwise.

The updates are held normwise because XLA's CPU compiler contracts the
source's multiply-adds (m = b1 m + (1 - b1) g, p - lr step) into fused
multiply-adds: where the two terms nearly cancel, the reference's value
carries one rounding fewer than the source's two products and a sum, and
an element can part from the port's by far more than 1e-6 of itself
(while its error against the terms' size stays at one rounding). The port
evaluates the source as written; that order is held bit for bit on the
first moment.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref
from repro_torch.optim import adamw as port

RTOL = 1e-6
SHAPES = {"tok": (64, 16), "w_up": (3, 16, 24), "norm": (16,), "u": (2, 8)}
CONFIGS = [
    dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0),
    dict(lr=1e-3, warmup_steps=3, total_steps=40, weight_decay=0.1, schedule="linear"),
    dict(lr=2e-4, warmup_steps=0, total_steps=30, schedule="constant", clip_norm=0.0),
    dict(lr=5e-3, warmup_steps=2, total_steps=10, clip_norm=1e3, b1=0.8, b2=0.99, eps=1e-6),
]


def _configs(kw):
    return ref.AdamWConfig(**kw), port.AdamWConfig(**kw)


def _trees(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    tree = {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in SHAPES.items()}
    return ({k: jnp.asarray(x) for k, x in tree.items()},
            {k: torch.from_numpy(x.copy()) for k, x in tree.items()})


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=0, err_msg=what)


def test_the_config_mirrors_the_reference():
    assert ([f.name for f in dataclasses.fields(port.AdamWConfig)]
            == [f.name for f in dataclasses.fields(ref.AdamWConfig)])
    assert port.AdamWConfig() == port.AdamWConfig(**dataclasses.asdict(ref.AdamWConfig()))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: kw.get("schedule", "cosine"))
def test_lr_schedule_at_every_step(kw):
    rcfg, pcfg = _configs(kw)
    steps = np.arange(0, pcfg.total_steps + 3)
    want = np.asarray(jax.jit(lambda s: ref.lr_at(rcfg, s))(jnp.asarray(steps, jnp.int32)))
    got = port.lr_at(pcfg, torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "lr_at")
    for s in (0, pcfg.warmup_steps, pcfg.total_steps):
        _close(port.lr_at(pcfg, s).numpy(), want[s], f"lr_at({s})")


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_global_norm_and_clipping(max_norm):
    jt, tt = _trees(1, scale=0.3)
    _close(port.global_norm(tt).numpy(), ref.global_norm(jt), "global_norm")
    (want, want_norm), (got, got_norm) = ref.clip_by_global_norm(jt, max_norm), \
        port.clip_by_global_norm(tt, max_norm)
    _close(got_norm.numpy(), want_norm, "norm")
    for name in SHAPES:
        _close(got[name].numpy(), want[name], f"clipped {name}")


def test_init_opt_state():
    _, tt = _trees(2)
    st = port.init_opt_state(tt)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    for part in ("m", "v"):
        assert st[part].keys() == tt.keys()
        assert all(x.dtype == torch.float32 and not x.any() for x in st[part].values())


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: kw.get("schedule", "cosine"))
def test_three_updates_match_the_reference(kw):
    rcfg, pcfg = _configs(kw)
    jp, tp = _trees(3)
    jst, tst = ref.init_opt_state(jp), port.init_opt_state(tp)
    update = jax.jit(lambda p, g, s: ref.adamw_update(rcfg, p, g, s))
    for i in range(3):
        jg, tg = _trees(10 + i, scale=0.05 * (i + 1))
        m_prev = {k: x.clone() for k, x in tst["m"].items()}
        clipped = port.clip_by_global_norm(tg, pcfg.clip_norm)[0] if pcfg.clip_norm else tg
        jp, jst, jm = update(jp, jg, jst)
        tp2, tst, tm = port.adamw_update(pcfg, tp, tg, tst)
        assert tp2 is tp  # the parameters are written in place
        assert int(tst["count"]) == int(jst["count"]) == i + 1
        for name in ("grad_norm", "lr"):
            _close(tm[name].numpy(), jm[name], f"step {i} {name}")
        for name in SHAPES:
            for part, got, want in (("param", tp[name], jp[name]), ("m", tst["m"][name], jst["m"][name]),
                                    ("v", tst["v"][name], jst["v"][name])):
                want = np.asarray(want, np.float64)
                err = np.linalg.norm(got.numpy().astype(np.float64) - want) / np.linalg.norm(want)
                assert err <= RTOL, f"step {i} {part} {name}: {err:.3g}"
            # the source's order: two fp32 products, then their sum
            terms = (np.float32(pcfg.b1) * m_prev[name].numpy(),
                     np.float32(1 - pcfg.b1) * clipped[name].numpy())
            assert np.array_equal(tst["m"][name].numpy(), terms[0] + terms[1]), f"step {i} m {name}"
