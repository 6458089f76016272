"""Carry a reference parameter tree over into the port's modules."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.model import RwkvLM


def _flat(tree: Mapping, shape_of) -> dict:
    return {(group, name): shape_of(leaf)
            for group, leaves in tree.items() for name, leaf in leaves.items()}


@torch.no_grad()
def params_from_jax(model: RwkvLM, tree: Mapping) -> RwkvLM:
    """Load the reference's ``RwkvLM.init`` tree, given as numpy arrays
    (``{"embed": {"tok", "final_norm"}, "layers": {name: stacked on axis
    0}}``), into ``model``. Every name and shape must match the model's;
    a missing, extra or misshapen leaf raises ``ValueError``. Returns the
    model."""
    want = _flat(model.param_shapes(), tuple)
    got = _flat(tree, np.shape)
    if want.keys() != got.keys():
        raise ValueError(
            f"parameter names differ: missing {sorted(want.keys() - got.keys())}, "
            f"unexpected {sorted(got.keys() - want.keys())}")
    bad = {key: (got[key], want[key]) for key in want if got[key] != want[key]}
    if bad:
        raise ValueError(f"parameter shapes differ (given, expected): {bad}")

    def load(param: torch.Tensor, value) -> None:
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))

    for name, value in tree["embed"].items():
        load(model.embed[name], value)
    for name, value in tree["layers"].items():
        stacked = np.asarray(value)
        for i, block in enumerate(model.layers):
            load(getattr(block, name), stacked[i])
    return model
