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

    for path, target in tree_leaves(model.param_tree(), is_param_leaf).items():
        value = np.asarray(got[path], dtype=np.float32)
        if isinstance(target, list):
            for param, v in zip(target, value):
                param.copy_(torch.from_numpy(np.array(v)))
        else:
            target.copy_(torch.from_numpy(np.array(value)))
    return model
