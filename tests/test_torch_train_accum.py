"""The port's train step beyond one plain step, on the CPU: gradient
accumulation against the reference's (``accum_steps=2``), the eval step,
the train state, and the loss falling over 40 steps by the reference's bar
(``tests/test_train_and_ckpt.py::test_loss_decreases``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.train.train_step import make_eval_step as ref_make_eval_step
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (StepConfig, init_train_state, loss_and_grads,
                                          make_eval_step, make_train_step, to_device_batch,
                                          train_state)
from test_torch_train_step import LOSS_ATOL, check_train_steps, setup, strict_jit


@pytest.fixture(scope="module")
def case():
    return setup("gemma3-1b")


def test_accumulated_steps_match_the_reference(case):
    check_train_steps(case, accum_steps=2)


def test_accumulation_sums_the_microbatches_then_divides(case):
    """accum_steps=2 takes rows 0-1 and 2-3 as its microbatches: its
    gradient is the two halves' sum over 2, its loss their mean."""
    port = case["port"]
    batch = to_device_batch(case["batches"][0], "cpu")
    params = train_state(port)["params"]
    halves = [loss_and_grads(port, params, {k: x[i:i + 2] for k, x in batch.items()})
              for i in (0, 2)]
    saved = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamWConfig(lr=0.0, weight_decay=0.0)  # the update leaves the weights as they are
    state, metrics = make_train_step(port, StepConfig(optimizer=opt, accum_steps=2))(
        train_state(port), batch)
    assert all(torch.equal(p, saved[n]) for n, p in state["params"].items())
    assert torch.equal(metrics["loss"], (halves[0][0] + halves[1][0]) / 2)
    assert torch.equal(metrics["xent"], (halves[0][1]["xent"] + halves[1][1]["xent"]) / 2)
    for name, m in state["opt"]["m"].items():
        g = (halves[0][2][name] + halves[1][2][name]) / 2
        # the first moment after one update is (1 - b1) times the (clipped) gradient
        scale = min(1.0, opt.clip_norm / float(metrics["grad_norm"]))
        torch.testing.assert_close(m, np.float32(1 - opt.b1) * (g * scale), rtol=1e-6, atol=0,
                                   msg=name)


def test_eval_step_matches_the_reference(case):
    want = strict_jit(ref_make_eval_step(case["ref_model"]))(case["tree"], case["ref_batches"][1])
    port = case["port"]
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    got = make_eval_step(port)(case["batches"][1])
    assert got.keys() == want.keys() == {"loss", "xent", "aux"}
    for name in want:
        assert not got[name].requires_grad
        assert abs(float(got[name]) - float(want[name])) <= LOSS_ATOL, name
    assert all(torch.equal(p, before[n]) for n, p in port.named_parameters())


def test_init_train_state():
    model = build_model(reduce_for_smoke(get_config("llama3.2-3b")), device="cpu")
    state = init_train_state(model)
    again = init_train_state(build_model(model.cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    assert state["params"].keys() == dict(model.named_parameters()).keys()
    assert all(p.requires_grad and p is dict(model.named_parameters())[n]
               for n, p in state["params"].items())
    assert all(torch.equal(p, again["params"][n]) for n, p in state["params"].items())
    assert int(state["step"]) == 0 and int(state["opt"]["count"]) == 0
    assert all(not m.any() for part in ("m", "v") for m in state["opt"][part].values())


def test_loss_decreases():
    """The reference's own training test's model, data and optimizer
    (``tests/test_train_and_ckpt._setup``), 40 plain train steps: the last
    two steps' mean loss under 0.9 x the first two's."""
    cfg = reduce_for_smoke(get_config("llama3.2-3b"))
    model = build_model(cfg, device="cpu")
    state = init_train_state(model)
    step = make_train_step(model, StepConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0)))
    losses = []
    for batch in SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=32)).batches(40):
        state, metrics = step(state, batch)
        assert set(metrics) == {"loss", "xent", "aux", "grad_norm", "lr"}
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    assert last < 0.9 * first, f"loss did not decrease: {first} -> {last}"
    assert int(state["step"]) == 40
