"""Carry a reference parameter tree over into the port's modules."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.model import BaseLM, is_param_leaf, tree_leaves


@torch.no_grad()
def params_from_jax(model: BaseLM, tree: Mapping) -> BaseLM:
    """Load the reference's ``init`` tree of the same model, given as numpy
    arrays, into ``model``: ``{"embed": {...}, "layers": {name: stacked on
    axis 0}}`` for ``LM`` (an MoE block's ``{"moe": {name: stacked}}`` among
    them) and ``RwkvLM`` (entry i of a stacked leaf goes to
    ``model.layers[i]``); ``{"embed": {...}, "periods": {"l<j>": {name:
    stacked on axis 0}}, "tail": [{name: array}, ...]}`` for ``HybridLM``;
    ``{"embed": {...}, "enc_norm": array, "encoder": {name: stacked},
    "decoder": {name: stacked}}`` for ``EncDecLM``.
    Every name and shape must match the model's; a missing, extra or
    misshapen leaf raises ``ValueError``. Returns the model."""
    put_tree(model, tree, model.param_tree())
    return model


def _matched_leaves(model: BaseLM, tree: Mapping) -> dict:
    """{path: leaf} of a tree in the model's init-tree layout, after checking
    that its names and shapes are the model's (``ValueError`` if not)."""
    want = tree_leaves(model.param_shapes(), lambda n: isinstance(n, tuple))
    got = tree_leaves(tree, lambda n: not isinstance(n, (dict, list)))
    if want.keys() != got.keys():
        raise ValueError(
            f"parameter names differ: missing {sorted(want.keys() - got.keys(), key=str)}, "
            f"unexpected {sorted(got.keys() - want.keys(), key=str)}")
    bad = {key: (np.shape(got[key]), want[key]) for key in want
           if np.shape(got[key]) != want[key]}
    if bad:
        raise ValueError(f"parameter shapes differ (given, expected): {bad}")
    return got


@torch.no_grad()
def put_tree(model: BaseLM, tree: Mapping, targets: Mapping) -> None:
    """Copy a tree in the model's init-tree layout (numpy arrays, checked as
    :func:`_matched_leaves` does) into ``targets``, a tree of tensors in the
    layout of ``model.param_tree()`` (entry i of a stacked leaf into the
    i-th tensor of the target's list), each cast to its target's dtype
    first."""
    got = _matched_leaves(model, tree)
    for path, target in tree_leaves(targets, is_param_leaf).items():
        first = target[0] if isinstance(target, list) else target
        value = np.asarray(got[path], dtype=torch.empty(0, dtype=first.dtype).numpy().dtype)
        if isinstance(target, list):
            for t, v in zip(target, value):
                t.copy_(_tensor(v))
        else:
            target.copy_(_tensor(value))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor, sharing its memory where torch can (a C-ordered,
    writable array; a restored checkpoint's), else a copy."""
    if a.flags.c_contiguous and a.flags.writeable:
        return torch.from_numpy(a)
    return torch.from_numpy(np.array(a))
