"""The port's training path (``BaseLM.loss``, ``repro_torch.train.
train_step``, the gradients through ``repro_torch.kernels.ops``) against
the reference's on the CPU, for the dense family (gemma3-1b's local /
global pattern with its softcap-free GeGLU, llama3.2-3b's SwiGLU). The
other families are in ``test_torch_train_families.py`` and
``test_torch_train_recurrent.py``, which use this file's helpers.

The reference's ``init`` (seed 0) is carried over with ``params_from_jax``;
both sides see the synthetic stream's batches (equal bit for bit,
``test_torch_synthetic.py``). The reference is compiled with
``xla_allow_excess_precision`` off, so that it rounds each bf16
intermediate where its source rounds, as the port does.

Limits: the loss and ``xent`` (and the MoE ``aux``) within atol 1e-2;
each gradient leaf within 2^-5 of the reference's normwise; over three
train steps of ``make_train_step`` on both sides each loss within atol
2e-2 and each parameter's change within 2^-4 normwise of the reference's.
The batch (4 x 32 tokens) is the reference training test's
(``tests/test_train_and_ckpt._setup``), the optimizer the reference's
defaults (lr 3e-4 after 100 warm-up steps, weight decay 0.1).

The bf16 activations' roundings set these limits' scale (``python
tests/test_torch_train_step.py`` prints it). The reference compiled with
XLA's default excess precision parts from itself compiled without it by
2.2-4.2% normwise in its worst gradient leaf and by 7.0-8.4% in its worst
parameter change over these three steps (gemma3-1b, rwkv6-3b,
recurrentgemma-9b): Adam's first steps move most elements by about lr
whatever the gradient's size, so an element whose gradient is near zero
moves either way. The port parts from the strict compile by at most 1.3%
and 5.4%. With the reference training test's optimizer (lr 3e-3 after 5
steps) rwkv6-3b's trajectories part by the third step (the reference from
itself by 37%), so the steps are held at the default rate.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.synthetic import DataConfig as RefDataConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train.train_step import StepConfig as RefStepConfig
from repro.train.train_step import init_train_state as ref_init_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, is_param_leaf, tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (StepConfig, loss_and_grads, make_train_step,
                                          to_device_batch, train_state)

LOSS_ATOL, STEP_LOSS_ATOL = 1e-2, 2e-2
GRAD_NORMWISE, CHANGE_NORMWISE = 2.0 ** -5, 2.0 ** -4
#: batch rows and tokens of the comparisons (the reference's own training
#: test's, ``tests/test_train_and_ckpt._setup``); train steps compared
B, S, STEPS = 4, 32, 3
#: the optimizer of the compared steps: the reference's defaults (lr 3e-4
#: after 100 warm-up steps, weight decay 0.1, clipping at 1)
OPT = {}
#: the reference compiled with the bf16 roundings its source makes
strict_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def setup(arch, batch=B, seq=S, n_batches=STEPS):
    """The reference's smoke model and init tree (numpy), the port's model
    on the CPU with that tree, and ``n_batches`` batches of each side's
    synthetic stream."""
    ref_cfg = ref_reduce_for_smoke(ref_get_config(arch))
    ref_model = ref_build_model(ref_cfg)
    tree = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    port = params_from_jax(build_model(reduce_for_smoke(get_config(arch)), device="cpu"), tree)
    data = dict(global_batch=batch, seq_len=seq)
    return {
        "ref_model": ref_model, "tree": tree, "port": port,
        "ref_batches": list(RefSyntheticLM(ref_cfg, RefDataConfig(**data)).batches(n_batches)),
        "batches": list(SyntheticLM(port.cfg, DataConfig(**data)).batches(n_batches)),
    }


def port_leaves(port, values=None) -> dict:
    """{reference tree path: numpy array} of the port's parameters (or of
    ``values``, {parameter name: tensor}), stacked leaves stacked."""
    names = {id(p): n for n, p in port.named_parameters()}

    def get(p):
        t = p if values is None else values[names[id(p)]]
        return t.detach().float().numpy().copy()

    return {path: np.stack([get(p) for p in leaf]) if isinstance(leaf, list) else get(leaf)
            for path, leaf in tree_leaves(port.param_tree(), is_param_leaf).items()}


def ref_leaves(tree) -> dict:
    return {path: np.asarray(x, np.float32) for path, x in
            tree_leaves(jax.tree.map(np.asarray, tree),
                        lambda n: not isinstance(n, (dict, list))).items()}


def normwise(got, want) -> float:
    """||got - want|| / ||want|| in float64 (0 where both are zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return 0.0 if num == 0.0 else (num / den if den else np.inf)


def check_loss_and_grads(case):
    """The port's loss, metrics and gradients on the first batch against
    ``jax.value_and_grad`` of the reference's ``model.loss``."""
    ref_model, port = case["ref_model"], case["port"]
    (loss, metrics), grads = strict_jit(jax.value_and_grad(
        lambda p, b: ref_model.loss(p, b), has_aux=True))(case["tree"], case["ref_batches"][0])
    state = train_state(port)
    got_loss, got_metrics, got_grads = loss_and_grads(
        port, state["params"], to_device_batch(case["batches"][0], "cpu"))
    assert got_loss.dtype == torch.float32 and got_loss.dim() == 0
    assert abs(float(got_loss) - float(loss)) <= LOSS_ATOL
    assert got_metrics.keys() == metrics.keys() == {"xent", "aux"}
    for name in metrics:
        assert abs(float(got_metrics[name]) - float(metrics[name])) <= LOSS_ATOL, name
    want, got = ref_leaves(grads), port_leaves(port, got_grads)
    assert want.keys() == got.keys()
    worst = {path: normwise(got[path], w) for path, w in want.items()}
    bad = {path: e for path, e in worst.items() if not e <= GRAD_NORMWISE}
    assert not bad, f"gradient leaves past 2^-5 normwise: {bad}"
    # every leaf the batch reaches has a gradient (none cut at a kernel)
    assert all(np.abs(g).sum() > 0 for g in got.values())
    return max(worst.values())


def check_train_steps(case, accum_steps=1, opt=None):
    """A train step a batch on both sides from the same weights (a fresh
    port model, the reference's init): each step's loss and learning rate,
    then each parameter's change over the steps."""
    opt = OPT if opt is None else opt
    ref_model = case["ref_model"]
    port = params_from_jax(build_model(case["port"].cfg, device="cpu"), case["tree"])
    ref_step = strict_jit(ref_make_train_step(ref_model, RefStepConfig(
        optimizer=RefAdamWConfig(**opt), accum_steps=accum_steps)))
    ref_state = ref_init_train_state(ref_model, jax.random.PRNGKey(0))
    step = make_train_step(port, StepConfig(optimizer=AdamWConfig(**opt),
                                            accum_steps=accum_steps))
    state = train_state(port)
    before = port_leaves(port)
    for i, (rb, pb) in enumerate(zip(case["ref_batches"], case["batches"])):
        ref_state, ref_metrics = ref_step(ref_state, rb)
        state, metrics = step(state, pb)
        assert metrics.keys() == ref_metrics.keys()
        assert abs(float(metrics["loss"]) - float(ref_metrics["loss"])) <= STEP_LOSS_ATOL, i
        assert abs(float(metrics["lr"]) - float(ref_metrics["lr"])) <= 1e-6 * float(ref_metrics["lr"])
    assert int(state["step"]) == int(ref_state["step"]) == len(case["batches"])
    after, want = port_leaves(port), ref_leaves(ref_state["params"])
    worst = {path: normwise(after[path] - before[path], want[path] - before[path]) for path in want}
    bad = {path: e for path, e in worst.items() if not e <= CHANGE_NORMWISE}
    assert not bad, f"parameter changes past 2^-4 normwise: {bad}"
    return max(worst.values())


@pytest.fixture(scope="module", params=["gemma3-1b", "llama3.2-3b"])
def case(request):
    return setup(request.param)


def test_loss_and_gradients_match_the_reference(case):
    check_loss_and_grads(case)


def test_train_steps_match_the_reference(case):
    check_train_steps(case)


def reference_spread(arch, opt):
    """The reference against itself: its strict compile against XLA's
    default (excess precision on), worst leaf normwise of the first batch's
    gradient and of the parameters' change over the three steps with
    ``opt``; then the port's against the strict compile."""
    case = setup(arch)
    ref_model = case["ref_model"]
    grad_fn = jax.value_and_grad(lambda p, b: ref_model.loss(p, b), has_aux=True)
    step_fn = ref_make_train_step(ref_model, RefStepConfig(optimizer=RefAdamWConfig(**opt)))
    grads, changes = [], []
    for jit in (strict_jit, jax.jit):
        grads.append(ref_leaves(jit(grad_fn)(case["tree"], case["ref_batches"][0])[1]))
        state, step = ref_init_train_state(ref_model, jax.random.PRNGKey(0)), jit(step_fn)
        for batch in case["ref_batches"]:
            state, _ = step(state, batch)
        tree = ref_leaves(case["tree"])
        changes.append({p: x - tree[p] for p, x in ref_leaves(state["params"]).items()})
    spread = [max(normwise(b[p], a[p]) for p in a) for a, b in (grads, changes)]
    port = (check_loss_and_grads(case), check_train_steps(case, opt=opt)) if opt == OPT else None
    return spread, port


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_step.py [arch ...]
    # prints the spreads this file's docstring cites (~1 min an architecture)
    import sys

    for arch in sys.argv[1:] or ["gemma3-1b", "rwkv6-3b", "recurrentgemma-9b"]:
        for name, opt in (("the reference's defaults", OPT),
                          ("the reference training test's", dict(
                              lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0))):
            (grad, change), port = reference_spread(arch, opt)
            print(f"{arch}, {name} optimizer: the reference against itself, worst leaf normwise: "
                  f"gradient {grad:.4f}, 3-step change {change:.4f}"
                  + (f"; the port against the strict reference: gradient {port[0]:.4f}, "
                     f"change {port[1]:.4f}" if port else "")
                  + (" (the port's steps are not held at this optimizer)" if not port else ""),
                  flush=True)
