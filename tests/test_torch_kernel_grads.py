"""Gradients through the kernels: each backward of
``repro_torch.kernels.backward`` against ``torch.autograd.grad`` through
the kernel's plain version (``repro_torch.kernels.ref``), in fp32 within
rtol 1e-5 and atol 1e-6, called directly and through the
``torch.autograd.Function``s of ``repro_torch.kernels.ops`` in the model
layouts. On the CPU the Functions' forwards are the plain versions, so
their outputs are the wrappers' bit for bit, and no kernel launches.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import backward as bwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref, rwkv6_scan_ref

RTOL, ATOL = 1e-5, 1e-6

#: (B, H, KV, S, T, D, causal, window, softcap)
FLASH_CASES = [
    (2, 4, 4, 16, 16, 8, True, None, 0.0),     # causal, MHA
    (2, 4, 1, 24, 24, 16, True, None, 0.0),    # GQA, 4 queries a KV head
    (1, 6, 2, 20, 20, 8, True, 5, 0.0),        # window
    (2, 4, 2, 16, 16, 8, True, None, 30.0),    # softcap
    (1, 4, 2, 18, 18, 8, True, 4, 20.0),       # window and softcap
    (2, 4, 2, 12, 30, 8, False, None, 0.0),    # S != T, no mask (cross attention)
    (2, 4, 4, 30, 30, 8, False, None, 0.0),    # no mask (an encoder)
    (1, 2, 1, 10, 6, 8, True, None, 0.0),      # S > T causal
]


def _close(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=what)


def _draw(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _flash_inputs(case, seed):
    b, h, kv, s, t, d = case[:6]
    gen = torch.Generator().manual_seed(seed)
    q, k, v = _draw(gen, b, h, s, d), _draw(gen, b, kv, t, d), _draw(gen, b, kv, t, d)
    return q, k, v, _draw(gen, b, h, s, d)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_autograd_of_the_plain_version(case):
    q, k, v, do = _flash_inputs(case, sum(case[:6]))
    kw = dict(causal=case[6], window=case[7], logit_softcap=case[8])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, do)
    got = bwd.flash_attention_bwd(q, k, v, do, **kw)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


def test_flash_backward_blocks_do_not_change_the_gradient(monkeypatch):
    case = (3, 4, 2, 16, 16, 8, True, 6, 10.0)
    q, k, v, do = _flash_inputs(case, 7)
    kw = dict(causal=True, window=6, logit_softcap=10.0)
    whole = bwd.flash_attention_bwd(q, k, v, do, **kw)
    monkeypatch.setattr(bwd, "FLASH_BWD_BLOCK", 1)  # one (batch, KV group) row a block
    for g, w in zip(bwd.flash_attention_bwd(q, k, v, do, **kw), whole):
        assert torch.equal(g, w)


def test_flash_backward_keeps_the_input_dtypes():
    case = (1, 4, 1, 16, 16, 8, True, None, 0.0)
    q, k, v, do = (x.to(torch.bfloat16) for x in _flash_inputs(case, 3))
    got = bwd.flash_attention_bwd(q, k, v, do)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    want = bwd.flash_attention_bwd(*(x.float() for x in (q, k, v, do)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=2 ** -8, atol=1e-6)
    zero = bwd.flash_attention_bwd(q, k, v, None)
    assert all(not g.any() for g in zero)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_function_in_the_model_layout(dtype):
    """ops.flash_attention on (B, S, H, D) views: the wrapper's forward bit
    for bit, the plain version's gradients, no launch on the CPU."""
    case = (2, 4, 2, 12, 12, 8, True, 5, 0.0)
    q, k, v, do = (x.transpose(1, 2).to(dtype) for x in _flash_inputs(case, 11))
    kw = dict(causal=True, window=5, logit_softcap=0.0)
    before = fa.flash_attention.launches
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    plain = fa.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)), **kw).transpose(1, 2)
    assert torch.equal(out, plain)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.clone().float().requires_grad_() for x in (q, k, v)]
    ref_out = flash_attention_ref(*(x.transpose(1, 2) for x in ref_leaves), **kw).transpose(1, 2)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            _close(g, w, f"d{name}")
    assert fa.flash_attention.launches == before


def _wkv_inputs(b, h, t, d, seed):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (_draw(gen, b, h, t, d, scale=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(_draw(gen, b, h, t, d, scale=0.5)))
    u = _draw(gen, h, d, scale=0.5)
    s0 = _draw(gen, b, h, d, d, scale=0.1)
    dy, ds = _draw(gen, b, h, t, d), _draw(gen, b, h, d, d)
    return (r, k, v, w, u, s0), dy, ds


@pytest.mark.parametrize("final", [True, False], ids=["final-state-grad", "no-final-grad"])
@pytest.mark.parametrize("t", [1, 9, 70], ids=lambda t: f"T{t}")
def test_wkv_backward_matches_autograd_of_the_plain_version(t, final):
    args, dy, ds = _wkv_inputs(2, 3, t, 8, t)
    leaves = [x.clone().requires_grad_() for x in args]
    y, s_last = rwkv6_scan_ref(*leaves)
    want = torch.autograd.grad((y, s_last) if final else (y,), leaves,
                               (dy, ds) if final else (dy,), allow_unused=True)
    # at T = 1 without the final state's gradient, w reaches nothing
    want = [torch.zeros_like(x) if g is None else g for x, g in zip(args, want)]
    got = bwd.rwkv6_scan_bwd(*args, dy, ds if final else None)
    for name, g, w in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        _close(g, w, f"d{name}")


def test_wkv_backward_chunks_do_not_change_the_gradient(monkeypatch):
    args, dy, ds = _wkv_inputs(1, 2, 23, 4, 5)
    whole = bwd.rwkv6_scan_bwd(*args, dy, ds)
    monkeypatch.setattr(bwd, "WKV_BWD_CHUNK", 5)
    for g, w in zip(bwd.rwkv6_scan_bwd(*args, dy, ds), whole):
        _close(g, w, "chunked")


def test_wkv_function_in_the_model_layout():
    """ops.rwkv6_scan on (B, T, H, D) tensors; only y used (the final
    state's gradient is None, counted as zero)."""
    args, dy, _ = _wkv_inputs(2, 3, 12, 8, 2)
    seq = [x.transpose(1, 2).contiguous() for x in args[:4]]
    before = wk.rwkv6_scan.launches
    leaves = [x.clone().requires_grad_() for x in (*seq, *args[4:])]
    y, s_last = ops.rwkv6_scan(*leaves)
    want_y, want_s = rwkv6_scan_ref(*args)
    assert torch.equal(y.transpose(1, 2), want_y) and torch.equal(s_last, want_s)
    got = torch.autograd.grad(y, leaves, dy.transpose(1, 2))
    ref_leaves = [x.clone().requires_grad_() for x in args]
    want = torch.autograd.grad(rwkv6_scan_ref(*ref_leaves)[0], ref_leaves, dy)
    for i, (name, g, w) in enumerate(zip(("r", "k", "v", "w", "u", "s0"), got, want)):
        _close(g.transpose(1, 2) if i < 4 else g, w, f"d{name}")
    assert wk.rwkv6_scan.launches == before


def _rglru_inputs(b, t, w, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(_draw(gen, b, t, w) + 2.0)  # decays near 1
    x, h0 = _draw(gen, b, t, w, scale=0.5), _draw(gen, b, w, scale=0.5)
    return (a, x, h0), _draw(gen, b, t, w), _draw(gen, b, w)


@pytest.mark.parametrize("final", [True, False], ids=["final-state-grad", "no-final-grad"])
@pytest.mark.parametrize("t", [1, 33], ids=lambda t: f"T{t}")
def test_rglru_backward_matches_autograd_of_the_plain_version(t, final):
    args, dh, dl = _rglru_inputs(2, t, 16, t)
    leaves = [x.clone().requires_grad_() for x in args]
    h, h_last = rglru_scan_ref(*leaves)
    want = torch.autograd.grad((h, h_last) if final else (h,), leaves,
                               (dh, dl) if final else (dh,))
    got = bwd.rglru_scan_bwd(args[0], args[2], h.detach(), dh, dl if final else None)
    for name, g, w in zip(("a", "x", "h0"), got, want):
        _close(g, w, f"d{name}")


def test_rglru_function_only_the_final_state_used():
    """ops.rglru_scan with only h_T in the loss (h's gradient None)."""
    args, _, dl = _rglru_inputs(3, 20, 8, 4)
    before = rg.rglru_scan.launches
    leaves = [x.clone().requires_grad_() for x in args]
    h, h_last = ops.rglru_scan(*leaves)
    assert [torch.equal(a, b) for a, b in zip((h, h_last), rglru_scan_ref(*args))] == [True] * 2
    got = torch.autograd.grad(h_last, leaves, dl)
    ref_leaves = [x.clone().requires_grad_() for x in args]
    want = torch.autograd.grad(rglru_scan_ref(*ref_leaves)[1], ref_leaves, dl)
    for name, g, w in zip(("a", "x", "h0"), got, want):
        _close(g, w, f"d{name}")
    assert rg.rglru_scan.launches == before


def test_functions_serve_without_a_graph():
    """Inputs that take no gradient give outputs without one, as the
    serving path calls them (under inference mode too)."""
    args, _, _ = _rglru_inputs(1, 4, 8, 0)
    q, k, v, _ = _flash_inputs((1, 2, 1, 4, 4, 8), 0)
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None
        assert ops.rglru_scan(*args)[0].grad_fn is None
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    assert np.isfinite(out.numpy()).all()
