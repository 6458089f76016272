"""Mixture-of-Experts FFN (deepseek-moe's fine-grained experts, phi3.5-moe's
top-2) on torch tensors: the reference's dense-dispatch formulation, step
for step.

Tokens are cut into G groups (the largest divisor of B S that is at most
:data:`DISPATCH_GROUPS`); each expert takes at most ``capacity`` tokens of
a group, counted in token-major order over the (Tg K, E) one-hots, and the
overflow contributes nothing. Routing runs in fp32 (softmax, top-k with the
lower expert first on a tie, renormalised gates, the Switch aux loss). The
tokens reach the experts through a (G, Tg, E, C) bf16 combine tensor built
from one-hots, one choice at a time, and the dispatch, expert and combine
products are bf16 with fp32 sums: plain products, which the reference
leaves to XLA outside any kernel, so they stay ``torch.matmul``. The
shared experts (deepseek) are a dense FFN over every token.

Which tokens are dropped depends on G and on the order of the cumulative
count, so both are the reference's. Nothing here reads a value back to
the host: every shape comes from the input's shape.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.models.layers import activation, cast, dense_init

#: token groups of the local-capacity dispatch (the reference's production
#: batch sharding: per-group counting is per-shard counting there)
DISPATCH_GROUPS = 32

#: when set, groups aim at about this many tokens (the reference's knob;
#: unset, as there)
DISPATCH_TARGET_TG = None


def moe_param_shapes(d_model: int, num_experts: int, d_ff: int, num_shared: int,
                     glu: bool) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape: the router, the stacked routed experts (``we_*``) and,
    with shared experts, one dense FFN ``num_shared * d_ff`` wide (``w_*``)."""
    shapes = {"router": (d_model, num_experts),
              "we_up": (num_experts, d_model, d_ff),
              "we_down": (num_experts, d_ff, d_model)}
    if glu:
        shapes["we_gate"] = (num_experts, d_model, d_ff)
    if num_shared:
        f_shared = num_shared * d_ff
        shapes["w_up"] = (d_model, f_shared)
        shapes["w_down"] = (f_shared, d_model)
        if glu:
            shapes["w_gate"] = (d_model, f_shared)
    return shapes


def moe_param_init(generator: torch.Generator, d_model: int, num_experts: int, d_ff: int,
                   num_shared: int, glu: bool) -> Dict[str, torch.Tensor]:
    """fp32 ``dense_init`` draws (the router at scale 0.02), on the
    generator's device."""
    shapes = moe_param_shapes(d_model, num_experts, d_ff, num_shared, glu)
    return {name: dense_init(shape, generator, 0.02 if name == "router" else None)
            for name, shape in shapes.items()}


def capacity_for(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert has in a group of ``tokens``: ceil(tokens K / E
    factor), rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(tokens * top_k / num_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _num_groups(t: int) -> int:
    """The number of groups of ``t`` tokens: the largest divisor of ``t``
    that is at most DISPATCH_GROUPS (or, with DISPATCH_TARGET_TG, near t /
    DISPATCH_TARGET_TG)."""
    if DISPATCH_TARGET_TG:
        g = min(t, max(DISPATCH_GROUPS, t // DISPATCH_TARGET_TG))
    else:
        g = min(DISPATCH_GROUPS, t)
    while t % g:
        g -= 1
    return g


def grouped(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> its B S tokens in (G, Tg, D) groups, token-major."""
    t = x.shape[0] * x.shape[1]
    g = _num_groups(t)
    return x.reshape(g, t // g, x.shape[-1])


class Routing(NamedTuple):
    """The routing of (G, Tg) grouped tokens: router probabilities (G, Tg, E)
    fp32; renormalised gates (G, Tg, K) fp32 and expert ids (G, Tg, K) int64,
    best first; each choice's slot in its expert (G, Tg, K) int64 and
    whether it fits the capacity (``keep``, bool); the capacity."""
    probs: torch.Tensor
    gates: torch.Tensor
    ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(router: torch.Tensor, xf: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float) -> Routing:
    """Route the grouped tokens ``xf`` (G, Tg, D) with ``router`` (D, E):
    fp32 logits and softmax, the top ``top_k`` experts (a stable sort: the
    lower index first among equal probabilities, as ``lax.top_k``), gates
    renormalised over them, and each choice's position in its expert: the
    cumulative count over the group's (Tg K, E) one-hots in token-major
    order, less one."""
    g, tg, _ = xf.shape
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :top_k], ids[..., :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    capacity = capacity_for(tg, num_experts, top_k, capacity_factor)
    experts = torch.arange(num_experts, device=ids.device)
    one_hot = (ids[..., None] == experts).long()  # (G, Tg, K, E)
    pos_flat = torch.cumsum(one_hot.reshape(g, tg * top_k, num_experts), dim=1) - 1
    pos = torch.gather(pos_flat.reshape(g, tg, top_k, num_experts), -1, ids[..., None])[..., 0]
    return Routing(probs, gates, ids, pos, pos < capacity, capacity)


def aux_loss(r: Routing, num_experts: int) -> torch.Tensor:
    """The Switch load-balancing loss, E sum_e density_e mean_prob_e, over
    the first choices (fp32 scalar)."""
    first = (r.ids[..., 0, None] == torch.arange(num_experts, device=r.ids.device)).float()
    density = first.mean(dim=(0, 1))
    router_mean = r.probs.mean(dim=(0, 1))
    return num_experts * torch.sum(density * router_mean)


def combine_tensor(r: Routing, num_experts: int) -> torch.Tensor:
    """(G, Tg, E, C) bf16: bf16(gate keep) at (token, expert, slot) of each
    kept choice, zeros elsewhere; built one choice at a time from one-hots
    (a position past the capacity has no slot), as the reference builds it."""
    g, tg, top_k = r.ids.shape
    experts = torch.arange(num_experts, device=r.ids.device)
    slots = torch.arange(r.capacity, device=r.ids.device)
    combine = torch.zeros((g, tg, num_experts, r.capacity), dtype=torch.bfloat16,
                          device=r.ids.device)
    for k in range(top_k):
        e_k = (r.ids[..., k, None] == experts).to(torch.bfloat16)
        c_k = (r.pos[..., k, None] == slots).to(torch.bfloat16)
        w_k = (r.gates[..., k] * r.keep[..., k]).to(torch.bfloat16)
        combine = combine + (e_k * w_k[..., None])[..., None] * c_k[:, :, None, :]
    return combine


def _expert_product(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, E, C, A) times each expert's (A, B) matrix of ``w`` (E, A, B)
    cast to bf16 -> (G, E, C, B) bf16 (fp32 sums)."""
    g, e, c, a = xe.shape
    out = torch.bmm(xe.transpose(0, 1).reshape(e, g * c, a), cast(w))
    return out.reshape(e, g, c, -1).transpose(0, 1)


def moe_ffn(p, x: torch.Tensor, *, num_experts: int, top_k: int, capacity_factor: float,
            act: str, glu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux loss (fp32 scalar)).
    ``p`` holds the parameters of :func:`moe_param_shapes` as attributes."""
    b, s, d = x.shape
    xf = grouped(x)
    g = xf.shape[0]
    r = route(p.router, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    combine = combine_tensor(r, num_experts)  # (G, Tg, E, C)
    dispatch = (combine > 0).to(torch.bfloat16)
    c = r.capacity
    # tokens to their slots: (G, E C, Tg) x (G, Tg, D)
    xe = torch.bmm(dispatch.reshape(g, -1, num_experts * c).transpose(1, 2), cast(xf))
    xe = xe.reshape(g, num_experts, c, d)
    up = _expert_product(xe, p.we_up)
    if glu:
        h = activation(_expert_product(xe, p.we_gate), act) * up
    else:
        h = activation(up, act)
    ye = _expert_product(h, p.we_down)  # (G, E, C, D)
    # slots back to their tokens, gate-weighted: (G, Tg, E C) x (G, E C, D)
    y = torch.bmm(combine.reshape(g, -1, num_experts * c), ye.reshape(g, num_experts * c, d))
    if hasattr(p, "w_up"):
        up_s = cast(xf) @ cast(p.w_up)
        if glu:
            h_s = activation(cast(xf) @ cast(p.w_gate), act) * up_s
        else:
            h_s = activation(up_s, act)
        y = y + h_s @ cast(p.w_down)
    return y.reshape(b, s, d).to(x.dtype), aux_loss(r, num_experts)


class MoE(nn.Module):
    """One layer's MoE FFN: the parameters of :func:`moe_param_shapes` under
    the reference's names, and :func:`moe_ffn` as ``forward``."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int, num_shared: int, top_k: int,
                 capacity_factor: float, act: str, glu: bool, device):
        super().__init__()
        self.dims = (d_model, num_experts, d_ff, num_shared, glu)
        self.kw = dict(num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor)
        self.act = act
        for name, shape in moe_param_shapes(*self.dims).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device), requires_grad=False))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, value in moe_param_init(generator, *self.dims).items():
            getattr(self, name).copy_(value)

    def route(self, x: torch.Tensor) -> Routing:
        """The routing ``forward`` takes for x (B, S, D), in its groups."""
        return route(self.router, grouped(x), **self.kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self, x, act=self.act, glu=self.dims[-1], **self.kw)
