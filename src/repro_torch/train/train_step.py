"""Train step: loss -> gradients -> (chunk-scheduled sync between ranks)
-> AdamW, the reference's ``train/train_step.py``.

On one device (no group, or a group of one rank) it is the reference's
single-pod path. Over a ``torch.distributed`` group of P > 1 ranks it is
its multi-pod path: each rank holds the whole model (the reference's
pod-level replication), takes its block of the global batch
(:func:`repro_torch.distributed.pods.local_rows`), computes its loss and
gradients, and syncs them with :func:`repro_torch.distributed.grad_sync.
naive_sync` or the paper-scheduled plan of :func:`~repro_torch.
distributed.grad_sync.apply_sync`; the loss and metrics are averaged over
the ranks before AdamW, so every rank takes the same update.

The train state is ``{"params": {name: the model's nn.Parameter}, "opt":
{"m", "v", "count"}, "step": int32 0-d}``: the parameters are the model's
own tensors, which :func:`repro_torch.optim.adamw.adamw_update` writes in
place. Everything runs on the model's device: a batch of numpy arrays or
tensors is moved there. :func:`state_tree` gives the state in the
reference's layout (what a checkpoint holds), :func:`put_state_tree` puts
such a tree back. Gradients pass the kernels through the
``torch.autograd.Function``s of :mod:`repro_torch.kernels.ops` (the
kernels forward, their gradients in torch ops).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import grad_sync
from repro_torch.distributed.pods import group_size, local_rows
from repro_torch.models.convert import put_tree
from repro_torch.models.model import BaseLM, is_stacked, leaf_paths, map_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The reference's step options, but ``gather_once`` (FSDP within a
    pod) and the plan's ``sync_max_cc`` / ``sync_num_chunks``, which keep
    the reference's defaults (``build_sync_plan``'s: 8 and 2). The sync
    options take effect over a group of more than one rank."""
    optimizer: AdamWConfig = AdamWConfig()
    sync_algorithm: str = "promc"  # sc | mc | promc | naive
    compress: bool = True  # per-class compression (beyond-paper)
    #: codec for the bandwidth-bound (Medium+) chunk classes: "bf16" or
    #: "int8" (int8 travels as all-gather + local dequant-sum)
    compress_codec: str = "bf16"
    #: gradient-accumulation microbatches per step (1 = off)
    accum_steps: int = 1


def to_device_batch(batch: Mapping, device) -> Batch:
    """A batch of numpy arrays or tensors as tensors on ``device``: integer
    entries (tokens, targets) int64, float entries fp32."""
    out = {}
    for name, x in batch.items():
        t = torch.as_tensor(x)
        dtype = torch.float32 if t.is_floating_point() else torch.int64
        out[name] = t.to(device=device, dtype=dtype)
    return out


def train_state(model: BaseLM) -> Dict:
    """The train state of the model's current parameters (after ``init``,
    ``load_state_dict`` or ``params_from_jax``): every parameter set to
    take a gradient, zero AdamW moments, step 0."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def state_tree(model: BaseLM, state: Dict) -> Dict:
    """The train state in the reference's layout, the tree its
    ``init_train_state`` gives and its checkpoints hold: ``{"params":
    model.param_tree(), "opt": {"m", "v": the same layout, "count"},
    "step"}``. A stacked leaf is the list of the per-layer tensors (see
    :mod:`repro_torch.checkpoint.ckpt`); the tensors are the state's own,
    not copies."""
    opt = state["opt"]
    return {"params": model.param_tree(),
            "opt": {"m": tree_of(model, opt["m"]), "v": tree_of(model, opt["v"]),
                    "count": opt["count"]},
            "step": state["step"]}


def tree_of(model: BaseLM, values: Mapping[str, torch.Tensor]):
    """``values`` ({parameter name: tensor}) in the layout of
    ``model.param_tree()``: a stacked leaf the list of its layers'
    tensors."""
    names = {id(p): n for n, p in model.named_parameters()}
    return map_leaves(lambda _, leaf: [values[names[id(p)]] for p in leaf] if is_stacked(leaf)
                      else values[names[id(leaf)]], model.param_tree())


def named_of(model: BaseLM, tree) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`tree_of`: {parameter name: tensor}."""
    names = {id(p): n for n, p in model.named_parameters()}
    values = dict(leaf_paths(tree))
    out = {}
    for path, leaf in leaf_paths(model.param_tree()):
        for p, t in zip(leaf, values[path]) if is_stacked(leaf) else ((leaf, values[path]),):
            out[names[id(p)]] = t
    return out


def put_state_tree(model: BaseLM, state: Dict, tree: Mapping) -> Dict:
    """The inverse of :func:`state_tree` (the reference's ``_tree_put``):
    write a tree in the reference's layout (numpy arrays, a restored
    checkpoint's) into ``state`` in place, each leaf in the dtype of the
    tensor it replaces: the model's parameters (names and shapes checked,
    as ``params_from_jax`` does), the AdamW moments, ``count`` and
    ``step``. Returns ``state``."""
    template = state_tree(model, state)
    put_tree(model, tree["params"], template["params"])
    for part in ("m", "v"):
        put_tree(model, tree["opt"][part], template["opt"][part])
    with torch.no_grad():
        for t, value in ((state["opt"]["count"], tree["opt"]["count"]),
                         (state["step"], tree["step"])):
            if np.shape(value) != tuple(t.shape):
                raise ValueError(f"a counter of shape {np.shape(value)}, expected {tuple(t.shape)}")
            t.copy_(torch.as_tensor(np.asarray(value)))
    return state


def init_train_state(model: BaseLM, generator: Optional[torch.Generator] = None) -> Dict:
    """``model.init(generator)`` (default: seed 0 on the model's device),
    then :func:`train_state`."""
    model.init(generator)
    return train_state(model)


def loss_and_grads(model: BaseLM, params: Dict[str, torch.Tensor],
                   batch: Batch) -> Tuple[torch.Tensor, Metrics, Dict[str, torch.Tensor]]:
    """``model.loss(batch)`` and its gradient with respect to ``params``
    (the model's parameters): (loss, {"xent", "aux"}, {name: gradient}),
    fp32; a parameter the loss does not reach gets zeros."""
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(params.items(), grads)}
    return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads


def make_train_step(model: BaseLM, cfg: StepConfig,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Callable[[Dict, Mapping], Tuple[Dict, Metrics]]:
    """Returns step(state, batch) -> (state, metrics): the loss and its
    gradients, then one AdamW update. With ``accum_steps`` = k > 1 the
    batch splits into k microbatches on axis 0 (rows i B/k .. (i+1) B/k - 1
    in the i-th); their fp32 gradients, losses and metrics are summed in
    order, then divided by k. metrics: ``loss``, ``xent``, ``aux``,
    ``grad_norm`` (before clipping) and ``lr``, 0-d fp32 tensors on the
    model's device.

    With a ``group`` of P > 1 ranks each rank takes the global batch's
    rows of its rank (:func:`~repro_torch.distributed.pods.local_rows`),
    then syncs the gradients before the update: ``naive_sync`` for
    ``sync_algorithm="naive"``, else the plan of ``build_sync_plan`` (made
    at the first step, the reference's choice of per-class codecs) run by
    ``apply_sync``; loss and metrics are averaged over the ranks. The
    step's ``last_sync`` is then the last sync's
    :class:`~repro_torch.distributed.grad_sync.SyncReport`."""
    world = group_size(group)
    rank = dist.get_rank(group) if world > 1 else 0
    plan = None

    def sync(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nonlocal plan
        tree, report = tree_of(model, grads), grad_sync.SyncReport()
        if cfg.sync_algorithm == "naive":
            tree = grad_sync.naive_sync(tree, group=group, report=report)
        else:
            if plan is None:
                plan = grad_sync.build_sync_plan(
                    tree, algorithm=cfg.sync_algorithm,
                    compress_by_class=grad_sync.compress_table(cfg.compress, cfg.compress_codec))
            tree, _ = grad_sync.apply_sync(plan, tree, group=group, report=report)
        step.last_sync = report
        return named_of(model, tree)

    def mean_over_ranks(loss: torch.Tensor, metrics: Metrics) -> Tuple[torch.Tensor, Metrics]:
        both = torch.stack([loss, *metrics.values()])
        dist.all_reduce(both, group=group)
        both = both / world
        return both[0], dict(zip(metrics, both[1:]))

    def step(state: Dict, batch: Mapping) -> Tuple[Dict, Metrics]:
        params = state["params"]
        if world > 1:
            batch = local_rows(batch, rank, world)
        batch = to_device_batch(batch, model.device)
        k = cfg.accum_steps
        if k <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            for i in range(k):
                micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                         for name, x in batch.items()}
                l, m, g = loss_and_grads(model, params, micro)
                if i == 0:
                    loss, metrics, grads = l, m, g
                    continue
                loss = loss + l
                metrics = {name: metrics[name] + m[name] for name in metrics}
                grads = {name: grads[name] + g[name] for name in grads}
                del g
            loss = loss / k
            metrics = {name: m / k for name, m in metrics.items()}
            grads = {name: g / k for name, g in grads.items()}
        if world > 1:
            grads = sync(grads)
            loss, metrics = mean_over_ranks(loss, metrics)
        _, opt, opt_metrics = adamw_update(cfg.optimizer, params, grads, state["opt"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    step.last_sync = None
    return step


def make_eval_step(model: BaseLM) -> Callable[[Mapping], Metrics]:
    """Returns step(batch) -> {"loss", "xent", "aux"} of ``model.loss``,
    without a graph."""

    def step(batch: Mapping) -> Metrics:
        with torch.no_grad():
            loss, metrics = model.loss(to_device_batch(batch, model.device))
        return {"loss": loss, **metrics}

    return step
