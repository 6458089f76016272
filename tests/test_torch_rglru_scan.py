"""The RG-LRU scan's plain PyTorch version against the Pallas kernel it ports
(interpreted on the CPU), the reference's plain version, and the reference
model's associative scan.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances, as in the reference's own kernel tests: rtol = atol = 1e-5 for
fp32 inputs, 5e-2 for bf16 inputs (both sides upcast the same bf16 values
to fp32, but the limit is the reference's); 1e-4 against the associative
scan, which sums in another order."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro.models.rglru import rglru_scan_ref as assoc_scan
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels.ref import rglru_scan_chunked_plain, rglru_scan_ref
from repro_torch.models.rglru import C_FACTOR, rglru_param_init

#: (B, T, W): the reference's RG_CASES (tests/test_kernels.py)
RG_CASES = [(1, 64, 128), (2, 128, 256), (1, 96, 512), (3, 100, 64)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
#: (B, T, W) around the kernel's time staging (a ring of 32-step stages
#: above T = 16, straight loads at or below): T a multiple of the stage,
#: not one, under one stage, at and just above 16, T = 1; odd widths and
#: widths that leave a warp of columns part empty
STAGED_CASES = [(2, 64, 128), (3, 100, 64), (1, 97, 40), (2, 17, 33), (2, 16, 96),
                (2, 10, 33), (2, 1, 128), (1, 77, 1001)]
#: the kernel's limit against the plain version (chip_smoke.py's RG_TOL)
KERNEL_TOL = 1e-6


def _model_inputs(b, t, w, rng, trained):
    """a, x, h0 = 0 as RG-LRU blocks of the port's model make them from an
    input z of unit scale, with the block's initial weights. ``trained``:
    lam per channel so that a^8 is uniform in (0.9, 0.999) at r = 1, the
    range Griffin (section 2.4) starts from and a trained model keeps; else
    the model's own initial lam (a^8 = 0.97)."""
    p = rglru_param_init(torch.Generator().manual_seed(int(rng.randint(1 << 30))), w, w, 4)
    if trained:
        a8 = torch.from_numpy(rng.uniform(0.9, 0.999, size=w))
        p["lam"] = torch.log(torch.expm1(-torch.log(a8) / C_FACTOR)).float()
    z = torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32))
    r = torch.sigmoid(z @ p["w_a"] + p["gate_b"][0])
    i = torch.sigmoid(z @ p["w_x"] + p["gate_b"][1])
    log_a = -C_FACTOR * torch.nn.functional.softplus(p["lam"]) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return torch.exp(log_a).numpy(), (beta * i * z).numpy(), np.zeros((b, w))


def _draw(b, t, w, seed, decay="sigmoid"):
    """a in (0, 1), x, h0 as fp32 numpy. ``decay``: a = sigmoid(normal), or
    uniform in (0, 1e-3) ("near0") or in (1 - 1e-3, 1) ("near1"), or as the
    model makes them ("model", "trained": :func:`_model_inputs`)."""
    rng = np.random.RandomState(seed)
    if decay in ("model", "trained"):
        return [v.astype(np.float32) for v in _model_inputs(b, t, w, rng, decay == "trained")]
    if decay == "sigmoid":
        a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, w))))
    elif decay == "near0":
        a = 1e-3 * rng.uniform(size=(b, t, w))
    else:
        a = 1.0 - 1e-3 * rng.uniform(size=(b, t, w))
    x = 0.5 * rng.standard_normal((b, t, w))
    h0 = 0.5 * rng.standard_normal((b, w))
    return [v.astype(np.float32) for v in (a, x, h0)]


def _jax(arrays, dtype):
    """a and x in ``dtype``; h0 stays fp32, as in the reference's tests."""
    jd = getattr(jnp, dtype)
    return [jnp.asarray(arrays[0], jd), jnp.asarray(arrays[1], jd), jnp.asarray(arrays[2])]


def _torch(arrays, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(arrays[0]).to(td), torch.from_numpy(arrays[1]).to(td),
            torch.from_numpy(arrays[2])]


def _close(out, ref, tol):
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", RG_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_ops_match_the_interpreted_pallas_kernel(case, dtype):
    arrays = _draw(*case, seed=sum(case))
    ref = pallas_rglru_scan(*_jax(arrays, dtype), chunk=32, block_w=64, interpret=True)
    _close(rglru_scan_ref(*_torch(arrays, dtype)), ref, TOL[dtype])
    _close(ops.rglru_scan(*_torch(arrays, dtype)), ref, TOL[dtype])


@pytest.mark.parametrize("case", RG_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_reference_plain_version(case, dtype):
    arrays = _draw(*case, seed=100 + sum(case))
    ref = jax_ref.rglru_scan_ref(*_jax(arrays, dtype))
    _close(rglru_scan_ref(*_torch(arrays, dtype)), ref, TOL[dtype])


@pytest.mark.parametrize("case", [(2, 64, 128), (3, 100, 64)], ids=str)
def test_plain_matches_the_models_associative_scan(case):
    arrays = _draw(*case, seed=7 + sum(case))
    ref = assoc_scan(*_jax(arrays, "float32"))
    _close(rglru_scan_ref(*_torch(arrays, "float32")), ref, 1e-4)


def test_state_carries_over_between_calls():
    """The first part, then the rest from its final state, equals the whole
    sequence in one call; the split point divides no chunk size."""
    a, x, h0 = _torch(_draw(2, 80, 96, seed=11), "float32")
    h, h_fin = rglru_scan_ref(a, x, h0)
    cut = 33
    h1, mid = rglru_scan_ref(a[:, :cut], x[:, :cut], h0)
    h2, end = rglru_scan_ref(a[:, cut:], x[:, cut:], mid)
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    assert torch.equal(end, h_fin)
    torch.testing.assert_close(h_fin, h[:, -1])


@pytest.mark.parametrize("case", [(2, 1, 128), (3, 97, 40)], ids=["decode_T1", "prime_T97_odd_W"])
def test_decode_step_and_a_length_no_chunk_divides(case):
    """T = 1 (a decode step) and T = 97 with W = 40, which the Pallas
    kernel's chunk of 32 and lane block of 64 do not divide; the port's
    kernel has no chunk."""
    arrays = _draw(*case, seed=3)
    ref = pallas_rglru_scan(*_jax(arrays, "float32"), chunk=32, block_w=64, interpret=True)
    out = rglru_scan_ref(*_torch(arrays, "float32"))
    _close(out, ref, TOL["float32"])
    assert tuple(out[0].shape) == case and tuple(out[1].shape) == (case[0], case[2])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = rg.rglru_scan.launches
    args = _torch(_draw(2, 16, 32, seed=5), "float32")
    out = rg.rglru_scan(*args)
    assert rg.rglru_scan.launches == before
    for o, r in zip(out, rglru_scan_ref(*args)):
        assert torch.equal(o, r)


def test_wrapper_refuses_other_devices_and_bad_ranks():
    a = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rg.rglru_scan(a, a, torch.empty((1, 16), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, T, W\)"):
        rg.rglru_scan(torch.zeros(4, 16), torch.zeros(4, 16), torch.zeros(16))


@pytest.mark.parametrize("case", STAGED_CASES, ids=str)
@pytest.mark.parametrize("decay", ["sigmoid", "near0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_interpreted_pallas_kernel_at_the_kernels_limit(case, decay, dtype):
    """The plain version, which the kernel equals bit for bit on the card, is
    held to the interpreted Pallas kernel at the kernel's limit of 1e-6 (not
    only the reference's 1e-5 / 5e-2), on the kernel's staging cases, with
    decays that contract and bf16 inputs (both sides upcast the same bf16
    values)."""
    arrays = _draw(*case, seed=7 * case[1] + case[2], decay=decay)
    ref = pallas_rglru_scan(*_jax(arrays, dtype), chunk=32, block_w=64, interpret=True)
    out = rglru_scan_ref(*_torch(arrays, dtype))
    assert out[0].shape == case and out[1].shape == (case[0], case[2])
    _close(out, ref, KERNEL_TOL)


def _fused_walk(a, x, h0):
    """h <- a h + x with one rounding a step (the product exact in float64)."""
    h, hs = h0.astype(np.float64), []
    for t in range(a.shape[1]):
        h = (a[:, t].astype(np.float64) * h + x[:, t]).astype(np.float32).astype(np.float64)
        hs.append(h)
    return np.stack(hs, axis=1).astype(np.float32), hs[-1].astype(np.float32)


@pytest.mark.parametrize("case", STAGED_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decays_near_one_part_the_plain_walk_from_the_pallas_kernels_fused_one(case, dtype):
    """With decays near 1 nothing contracts, and walks that round
    differently drift apart. The interpreted Pallas kernel (XLA on the CPU
    fuses a h + x into one rounding) walks as ``_fused_walk`` does, within
    1e-6; the plain version rounds the product and the sum apart, as the
    kernel does, and is held to the Pallas kernel at the reference's fp32
    limit of 1e-5 (at 1e-6 the fp32 cases of 64 steps or more fail: the
    two roundings drift apart). That is why the kernel keeps the plain
    version's order and roundings, and so its limit of 1e-6."""
    arrays = _draw(*case, seed=7 * case[1] + case[2], decay="near1")
    ref = pallas_rglru_scan(*_jax(arrays, dtype), chunk=32, block_w=64, interpret=True)
    upcast = [t.float().numpy() for t in _torch(arrays, dtype)]
    _close([torch.from_numpy(v) for v in _fused_walk(*upcast)], ref, KERNEL_TOL)
    _close(rglru_scan_ref(*_torch(arrays, dtype)), ref, TOL["float32"])


#: (B, T, W, chunk) for the chunked scan's plain mirror: chunks that divide
#: T and that do not, T under one chunk, T = 1, odd widths
CHUNKED_CASES = [(2, 64, 128, 16), (3, 100, 64, 32), (1, 97, 40, 16), (2, 20, 33, 32),
                 (2, 1, 128, 16), (1, 77, 1001, 8)]


def _excess(out, want, tol=KERNEL_TOL):
    """How far ``out`` lies past rtol = atol = ``tol`` of ``want``: > 0 is
    outside."""
    return ((out.double() - want.double()).abs() - tol * want.double().abs()).max().item() - tol


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
@pytest.mark.parametrize("decay", ["sigmoid", "near0", "model"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_holds_the_kernels_limit_where_decays_contract(case, decay, dtype):
    """A scan chunked over time (chunk maps, carries, a rescan from each
    carry) against the plain walk and the interpreted Pallas kernel at the
    kernel's limit of 1e-6: it holds where the decays contract within a few
    steps, the model's initial ones among them. Under one chunk it is the
    plain walk."""
    b, t, w, chunk = case
    arrays = _draw(b, t, w, seed=5 * t + w, decay=decay)
    args = _torch(arrays, dtype)
    out = rglru_scan_chunked_plain(*args, chunk)
    want = rglru_scan_ref(*args)
    assert out[0].shape == (b, t, w) and out[1].shape == (b, w)
    _close(out, want, KERNEL_TOL)
    _close(out, pallas_rglru_scan(*_jax(arrays, dtype), chunk=32, block_w=64, interpret=True),
           KERNEL_TOL)
    if t <= chunk:
        assert all(torch.equal(o, r) for o, r in zip(out, want))


def _exact_walk(a, x, h0):
    """The recurrence in float64: the answer both fp32 orders round."""
    h, hs = h0.double(), []
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + x[:, t].double()
        hs.append(h)
    return torch.stack(hs, dim=1)


@pytest.mark.parametrize("decay,case,chunks", [("near1", (2, 64, 128), (8, 16)),
                                               ("trained", (1, 3072, 4096), (16, 32, 64, 128))],
                         ids=["near1_T64", "trained_1x3072x4096"])
def test_chunked_scan_strays_past_the_kernels_limit_with_slow_decays(decay, case, chunks, capsys):
    """Why the kernel walks time serially. With decays near 1 over 64 steps,
    and with a trained model's decays over recurrentgemma-9b's 3,072-token
    prompt at full width, the chunked scan lies outside rtol = atol = 1e-6
    of the plain walk at every chunk size, though it is no further from the
    exact (float64) recurrence than the plain walk, which is itself outside
    1e-6 of it: the limit is below the plain version's own rounding, and
    only the serial order meets it. ``pytest -s`` prints the numbers."""
    args = _torch(_draw(*case, seed=19, decay=decay), "float32")
    want = rglru_scan_ref(*args)[0]
    exact = _exact_walk(*args)
    walk_err = (want.double() - exact).abs().max().item()
    with capsys.disabled():
        print(f"\n{decay} {case}: plain walk past 1e-6 of float64 by {_excess(want, exact):.3g}, "
              f"max error {walk_err:.3g}")
    assert _excess(want, exact) > 0
    for chunk in chunks:
        out = rglru_scan_chunked_plain(*args, chunk)[0]
        chunk_err = (out.double() - exact).abs().max().item()
        with capsys.disabled():
            print(f"{decay} {case} chunk {chunk}: past 1e-6 of the plain walk by "
                  f"{_excess(out, want):.3g}; max error against float64 {chunk_err:.3g}")
        assert _excess(out, want) > 0
        assert chunk_err <= walk_err
