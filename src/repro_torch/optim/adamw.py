"""AdamW with decoupled weight decay, global-norm clipping and learning-rate
schedules, on ``{name: tensor}`` dicts: the reference's ``optim/adamw.py``.

The schedule and the bias corrections are computed in fp32 tensors, as the
reference computes them in float32 (``b1 ** count``, ``cos(pi frac)``):
Python floats would compute them in float64 and part in the last bits.
Python constants enter each fp32 operation as the reference's weakly typed
constants do, rounded to fp32 once, and each expression keeps the
reference's order of operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step`` (an int, or an integer tensor of any
    shape, elementwise): linear warm-up over ``warmup_steps``, then the
    schedule's decay to ``min_lr_ratio`` at ``total_steps``. fp32, on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - frac)
    else:
        decay = torch.ones((), dtype=torch.float32, device=step.device)
    return cfg.lr * warm * decay


def init_opt_state(params: Tree) -> Dict:
    """fp32 zero moments ``m`` and ``v`` beside each parameter, and the
    int32 update count ``count`` (0-d), on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares (fp32)."""
    leaves = [torch.sum(x.float() ** 2) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """The gradients scaled by min(1, max_norm / norm), and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: Dict) -> Tuple[Tree, Dict, Dict[str, torch.Tensor]]:
    """One AdamW update of ``params`` by ``grads`` (the same names). The
    parameters are written in place (the returned dict holds the same
    tensors) and the new moments and count are returned in a new state;
    weight decay applies to every leaf, as in the reference. Returns
    (params, state, {"grad_norm": the norm before clipping, "lr"})."""
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state["count"] + 1
    lr = lr_at(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    new_m, new_v = {}, {}
    for name, p in params.items():
        gf = grads[name].float()
        m = cfg.b1 * state["m"][name] + (1 - cfg.b1) * gf
        v = cfg.b2 * state["v"][name] + (1 - cfg.b2) * gf * gf
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        new_m[name], new_v[name] = m, v
    return params, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
