"""Model assembly: ``build_model(config)`` -> an ``nn.Module`` with ``init``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``.

Four families, as in the reference:

* ``LM``, the uniform decoder of attention + FFN blocks: the dense family
  (gemma3's local / global pattern included), the MoE family (each block's
  FFN a :class:`repro_torch.models.moe.MoE`; ``forward`` returns the aux
  loss averaged over the layers) and the VLM family (paligemma: a batch's
  ``prefix_embed`` rows, precomputed patch embeddings, go before the text);
* ``RwkvLM``, the uniform RWKV-6 stack (attention-free);
* ``HybridLM``, the Griffin-style periodic stack of RG-LRU and
  local-attention blocks (recurrentgemma);
* ``EncDecLM``, whisper's encoder-decoder with cross attention; the audio
  frontend is a stub (a batch's ``frames`` are the frame embeddings).

Every prefill and train attention (self, cross, encoder) goes through
:func:`repro_torch.kernels.ops.flash_attention` (the flash kernel forward,
its gradient in torch ops); decode steps attend over the cache with the
plain attention. ``BaseLM.loss`` is the reference's training loss over
``forward``.

The residual stream is bf16, as in the reference: the embedding is cast to
bf16, each block returns its input's dtype and the residual adds run in
bf16. Parameters are fp32 ``nn.Parameter``s with the reference's names.
Each model keeps flat lists of blocks and maps them onto the reference's
init-tree layout (``param_tree``), so that :func:`param_shapes` matches the
reference's tree leaf for leaf and :mod:`repro_torch.models.convert` can
carry a reference tree over.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]


def tree_leaves(tree, is_leaf) -> Dict[Tuple, object]:
    """Path (tuple of dict keys and list indices) -> leaf of a nested tree
    of dicts and lists."""
    if is_leaf(tree):
        return {(): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {(key, *path): leaf for key, sub in items
            for path, leaf in tree_leaves(sub, is_leaf).items()}


def is_stacked(node) -> bool:
    """A non-empty list of tensors: one parameter that the reference stacks
    on a leading axis (a leaf of ``param_tree``, one file of a checkpoint
    or of a gradient sync)."""
    return (isinstance(node, list) and bool(node)
            and all(isinstance(x, torch.Tensor) for x in node))


def is_param_leaf(node) -> bool:
    """A leaf of ``param_tree``: a parameter, or a stacked list of them."""
    return isinstance(node, torch.Tensor) or is_stacked(node)


def map_leaves(fn, tree, sep: str = "/", list_key=str):
    """``tree`` (nested dicts and lists or tuples) with each leaf replaced by
    ``fn(name, leaf)``, the leaves visited in the reference's flattening
    order: dict keys sorted, list entries by index (the ``i``-th named
    ``list_key(i)``), a leaf's name its path's parts joined by ``sep``. A
    stacked list (:func:`is_stacked`) is one leaf."""
    def visit(prefix, node):
        if not isinstance(node, (dict, list, tuple)) or is_stacked(node):
            return fn(sep.join(prefix), node)
        if isinstance(node, dict):
            return {k: visit(prefix + [str(k)], node[k]) for k in sorted(node)}
        return type(node)(visit(prefix + [list_key(i)], v) for i, v in enumerate(node))
    return visit([], tree)


def leaf_paths(tree, sep: str = "/", list_key=str) -> List[Tuple[str, object]]:
    """(name, leaf) of every leaf of ``tree``, in :func:`map_leaves`' order
    and naming."""
    out: List[Tuple[str, object]] = []
    map_leaves(lambda name, leaf: out.append((name, leaf)), tree, sep, list_key)
    return out


def _params(shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, nn.Parameter]:
    """Uninitialised fp32 parameters of the given shapes. They take no
    gradient until a caller asks (``requires_grad_()``), as
    :func:`repro_torch.train.train_step.init_train_state` does: serving
    builds no graph. The kernels pass gradients through the
    ``torch.autograd.Function``s of :mod:`repro_torch.kernels.ops`."""
    return {
        name: nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()
    }


def stacked(blocks) -> dict:
    """The blocks' parameters as the reference stacks them: {name: [one per
    block]}, a submodule's parameters under its name as a nested dict (an
    ``LM`` block's ``moe``)."""
    tree: dict = {}
    for name, _ in blocks[0].named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = [b.get_parameter(name) for b in blocks]
    return tree


#: vocabulary columns of one fp32 slice of the logits product
LOGITS_SLICE = 16384


def sliced_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h`` (..., D) times ``table`` (V, D) transposed with bf16 operands:
    the products, exact in fp32, are summed in fp32 and stored bf16, a
    slice of :data:`LOGITS_SLICE` vocabulary columns at a time, so no fp32
    (..., V) tensor is made (at gemma3-1b's 262,144 vocabulary and 8 x 512
    tokens it would be 4.3 GB, the largest buffer). The sums run in fp32
    arithmetic (on the card ``resolve_device`` keeps them out of TF32): one
    bf16 product on the H100's tensor cores rounds ~6.5x as many logits
    away from the exact sum's bf16 value (``repro_torch.bench.logits_rounding``)."""
    h = L.cast(h).float()
    vocab = table.shape[0]
    out = torch.empty(h.shape[:-1] + (vocab,), dtype=torch.bfloat16, device=h.device)
    for lo in range(0, vocab, LOGITS_SLICE):
        w = L.cast(table[lo:lo + LOGITS_SLICE]).float()
        out[..., lo:lo + LOGITS_SLICE] = torch.matmul(h, w.T)
    return out


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean token NLL (fp32 scalar): logits (B, S, V) upcast to fp32,
    logsumexp less the gold logit of targets (B, S), averaged over the mask
    (B, S) with a divisor of at least 1."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


class BaseLM(nn.Module):
    """Embedding and output head shared by every family, and the training
    loss."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        shapes = {"tok": (cfg.vocab_size, cfg.d_model), "final_norm": (cfg.d_model,)}
        if not cfg.tie_embeddings:
            shapes["head"] = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.ParameterDict(_params(shapes, device))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def param_tree(self) -> dict:
        """The parameters in the reference's init-tree layout. A leaf is a
        parameter, or a list of parameters that the reference stacks on a
        leading axis. For a uniform stack (``LM``, ``RwkvLM``): ``{"embed":
        {...}, "layers": {name: [one per layer]}}``."""
        return {"embed": dict(self.embed.items()), "layers": stacked(self.layers)}

    def param_shapes(self) -> dict:
        """Shapes in the reference's init-tree layout (stacked leaves with
        their leading axis)."""
        def shape(node):
            if is_param_leaf(node):
                return (len(node), *node[0].shape) if isinstance(node, list) else tuple(node.shape)
            if isinstance(node, dict):
                return {k: shape(v) for k, v in node.items()}
            return [shape(v) for v in node]
        return shape(self.param_tree())

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "BaseLM":
        """Fill every parameter with seeded draws from ``generator`` (default:
        seed 0 on the model's device): each block of ``self.layers`` in
        order, then the embedding. Returns the model."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for block in self.layers:
            block.reset_parameters(generator)
        self._init_embed(generator)
        return self

    def _init_embed(self, generator: torch.Generator) -> None:
        values = {"tok": L.dense_init(self.embed["tok"].shape, generator, 0.02)}
        if "head" in self.embed:
            values["head"] = L.dense_init(self.embed["head"].shape, generator, 0.02)
        values["final_norm"] = torch.zeros(self.cfg.d_model)
        for name, value in values.items():
            self.embed[name].copy_(value)

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (xent + ``router_aux_weight`` aux, {"xent", "aux"}), fp32
        scalars: the forward's logits against the batch's ``targets`` under
        its ``mask`` (default: every position)."""
        logits, aux = self.forward(batch)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=logits.device)
        xent = cross_entropy(logits, batch["targets"], mask)
        total = xent + self.cfg.router_aux_weight * aux
        return total, {"xent": xent, "aux": aux}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token lookup times sqrt(d_model) in fp32, cast to bf16."""
        emb = F.embedding(tokens, self.embed["tok"])
        return L.cast(emb * math.sqrt(self.cfg.d_model))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm, then the (tied) table's product, stored bf16
        (:func:`sliced_logits`)."""
        h = L.rms_norm(h, self.embed["final_norm"], self.cfg.norm_eps)
        table = self.embed["head"] if "head" in self.embed else self.embed["tok"]
        return sliced_logits(h, table)


def self_attention(p, x: torch.Tensor, positions: torch.Tensor, state: Optional[Cache],
                   pos: int, *, theta: float, window: Optional[int] = None,
                   logit_softcap: float = 0.0) -> Tuple[torch.Tensor, Cache]:
    """Causal self-attention with rope of the block ``p`` (``wq`` .. ``wo``
    and ``dims``) on x (B, S, D) bf16 at ``positions`` -> (the projected
    output, {"k", "v"}).

    Without a state (forward, prefill) the S queries at positions 0..S-1
    attend through the flash kernel, and the new ``k``, ``v`` are this call's
    keys and values (B, S, KV, Dh) bf16. With a state (a decode step, S = 1
    at position ``pos``) the key and value go into slot ``pos`` of a copy of
    the layer's cache (B, max_len, KV, Dh), and the query attends over every
    slot, masked by slot position."""
    q, k, v = L.attn_qkv(p, x, p.dims)
    q = L.rope(q, positions, theta)
    k = L.rope(k, positions, theta)
    if state is None:
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                logit_softcap=logit_softcap)
        new = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    else:
        new = {name: state[name].clone() for name in ("k", "v")}
        new["k"][:, pos] = k[:, 0].to(torch.bfloat16)
        new["v"][:, pos] = v[:, 0].to(torch.bfloat16)
        kv_pos = torch.arange(new["k"].shape[1], device=x.device)
        o = L.attention_scores(q, new["k"], new["v"], positions, kv_pos, causal=True,
                               window=window, logit_softcap=logit_softcap)
    return L.attn_out(p, o), new


class DenseBlock(nn.Module):
    """One layer of the uniform decoder: ``attn_norm``, attention, residual
    add, ``ffn_norm``, the (GLU) FFN or, with ``cfg.num_experts``, the MoE
    FFN (the ``moe`` submodule, the reference's ``layers/moe/*`` tree),
    residual add. An ``"L"`` layer attends within ``cfg.window_size`` keys
    with rope theta ``rope_theta``; a ``"G"`` layer attends to every earlier
    key with ``rope_theta_global`` (or ``rope_theta``)."""

    def __init__(self, cfg: ModelConfig, ltype: str, device):
        super().__init__()
        self.cfg = cfg
        self.dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        self.window = cfg.window_size if ltype == "L" else None
        self.theta = cfg.rope_theta if ltype == "L" else (cfg.rope_theta_global or cfg.rope_theta)
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,)}
        shapes.update(L.attn_param_shapes(self.dims))
        if not cfg.num_experts:
            shapes.update(L.ffn_param_shapes(cfg.d_model, cfg.d_ff, cfg.glu))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)
        self.moe = moe_lib.MoE(
            cfg.d_model, cfg.num_experts, cfg.d_ff_expert, cfg.num_shared_experts, cfg.top_k,
            cfg.capacity_factor, cfg.act, cfg.glu, device) if cfg.num_experts else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        values = L.attn_param_init(generator, self.dims)
        if self.moe is None:
            values.update(L.ffn_param_init(generator, cfg.d_model, cfg.d_ff, cfg.glu))
        else:
            self.moe.reset_parameters(generator)
        values["attn_norm"] = torch.zeros(cfg.d_model)
        values["ffn_norm"] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def step(self, h: torch.Tensor, positions: torch.Tensor, state: Optional[Cache] = None,
             pos: int = 0) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """h (B, S, D) bf16 at ``positions`` -> (h, {"k", "v"}, the MoE aux
        loss, None without experts); the attention as
        :func:`self_attention` takes it."""
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        y, new = self_attention(self, x, positions, state, pos, theta=self.theta,
                                window=self.window, logit_softcap=cfg.logit_softcap)
        h = h + y
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        if self.moe is None:
            return h + L.ffn_apply(self, x, cfg.act, cfg.glu), new, None
        y, aux = self.moe(x)
        return h + y, new, aux

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                state: Optional[Cache] = None, pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """:meth:`step` without the aux loss: (h, {"k", "v"})."""
        h, new, _ = self.step(h, positions, state, pos)
        return h, new


def _with_prefix(h: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The text's embedding h (B, S, D) after a batch's ``prefix_embed``
    (B, P, D) rows cast to bf16, when it has them (the VLM family)."""
    if "prefix_embed" not in batch:
        return h
    return torch.cat([L.cast(batch["prefix_embed"]), h], dim=1)


class LM(BaseLM):
    """Uniform decoder: ``num_layers`` attention + FFN (or MoE) blocks, the
    layer pattern ("G", or gemma3's "LLLLLG") tiled over them. A batch may
    carry ``prefix_embed`` (B, P, D): those rows go before the text at
    positions 0..P-1, and ``forward`` leaves them out of its logits. The
    serving cache is ``{"k", "v"}``, each (L, B, max_len, KV, Dh) bf16, the
    reference's layout."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, t, device) for t in cfg.layer_types())

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V) bf16 of the text positions, the MoE aux loss
        summed over the layers over ``num_layers``; 0 without experts)."""
        h = _with_prefix(self._embed(batch["tokens"]), batch)
        positions = torch.arange(h.shape[1], device=h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for block in self.layers:
            h, _, a = block.step(h, positions)
            if a is not None:
                aux = aux + a
        if "prefix_embed" in batch:
            h = h[:, batch["prefix_embed"].shape[1]:, :]
        return self._logits(h), aux / self.cfg.num_layers

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero ``k``, ``v`` caches (L, B, max_len, KV, Dh) bf16."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {name: torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
                for name in ("k", "v")}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """-> (logits of the last position (B, 1, V) bf16, new cache): every
        layer's keys and values in slots 0..P+S-1 (P prefix rows, S tokens)
        of a fresh cache of the given cache's shape, zeros after."""
        h = _with_prefix(self._embed(batch["tokens"]), batch)
        s = h.shape[1]
        positions = torch.arange(s, device=h.device)
        new = {name: torch.zeros_like(c) for name, c in cache.items()}
        for i, block in enumerate(self.layers):
            h, st = block(h, positions)
            for name in new:
                new[name][i, :, :s] = st[name]
        return self._logits(h[:, -1:, :]), new

    def decode_step(self, token: torch.Tensor, cache: Cache, pos) -> Tuple[torch.Tensor, Cache]:
        """token (B,) at position ``pos`` (a Python int or a 0-d tensor) ->
        (logits (B, V) bf16, new cache). The given cache is not changed:
        each layer writes its slot in a copy."""
        pos = int(pos)
        h = self._embed(token[:, None])
        positions = torch.tensor([pos], device=h.device)
        new = {name: [] for name in cache}
        for i, block in enumerate(self.layers):
            h, st = block(h, positions, {name: c[i] for name, c in cache.items()}, pos)
            for name in new:
                new[name].append(st[name])
        return self._logits(h)[:, 0, :], {name: torch.stack(v) for name, v in new.items()}


class RwkvBlock(nn.Module):
    """One RWKV-6 layer: norm, time mix, residual, norm, channel mix,
    residual."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,)}
        shapes.update(rwkv_lib.rwkv_param_shapes(
            cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        values = rwkv_lib.rwkv_param_init(
            generator, cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff)
        values["attn_norm"] = torch.zeros(cfg.d_model)
        values["ffn_norm"] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def forward(self, h: torch.Tensor, state: Optional[Cache] = None):
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        y, tm = rwkv_lib.rwkv_time_mix(self, x, cfg.num_heads, cfg.head_dim, state)
        h = h + y
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        y, cm_shift = rwkv_lib.rwkv_channel_mix(self, x, state)
        return h + y, {"wkv": tm["wkv"], "shift_tm": tm["shift_tm"], "shift_cm": cm_shift}


class RwkvLM(BaseLM):
    """Uniform RWKV-6 stack."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(RwkvBlock(cfg, device) for _ in range(cfg.num_layers))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, T, V) bf16, aux loss 0)."""
        h = self._embed(batch["tokens"])
        for block in self.layers:
            h, _ = block(h, None)
        return self._logits(h), torch.zeros((), dtype=torch.float32, device=h.device)

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero recurrent state; ``max_len`` is unused (the state is O(1))."""
        cfg = self.cfg
        lb = (cfg.num_layers, batch_size)
        f4, dev = torch.float32, self.device
        return {
            "wkv": torch.zeros(lb + (cfg.num_heads, cfg.head_dim, cfg.head_dim),
                               dtype=f4, device=dev),
            "shift_tm": torch.zeros(lb + (cfg.d_model,), dtype=f4, device=dev),
            "shift_cm": torch.zeros(lb + (cfg.d_model,), dtype=f4, device=dev),
        }

    def _run_with_state(self, h: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new = {name: [] for name in cache}
        for i, block in enumerate(self.layers):
            h, st = block(h, {name: c[i] for name, c in cache.items()})
            for name in new:
                new[name].append(st[name])
        return h, {name: torch.stack(v) for name, v in new.items()}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """-> (logits of the last position (B, 1, V) bf16, new cache)."""
        h = self._embed(batch["tokens"])
        h, new_cache = self._run_with_state(h, cache)
        return self._logits(h[:, -1:, :]), new_cache

    def decode_step(self, token: torch.Tensor, cache: Cache, pos=None) -> Tuple[torch.Tensor, Cache]:
        """token (B,) -> (logits (B, V) bf16, new cache). ``pos`` is unused."""
        h = self._embed(token[:, None])
        h, new_cache = self._run_with_state(h, cache)
        return self._logits(h)[:, 0, :], new_cache


class HybridBlock(nn.Module):
    """One layer of the periodic stack: an RG-LRU block (``"R"``) or a
    local-attention block (``"L"``), each between ``attn_norm`` and a
    residual add, then ``ffn_norm``, the (GeGLU) FFN and a residual add."""

    def __init__(self, cfg: ModelConfig, ltype: str, device):
        super().__init__()
        self.cfg, self.ltype = cfg, ltype
        self.dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,)}
        if ltype == "R":
            shapes.update(rglru_lib.rglru_param_shapes(
                cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width))
        else:
            shapes.update(L.attn_param_shapes(self.dims))
        shapes.update(L.ffn_param_shapes(cfg.d_model, cfg.d_ff, cfg.glu))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        if self.ltype == "R":
            values = rglru_lib.rglru_param_init(
                generator, cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width)
        else:
            values = L.attn_param_init(generator, self.dims)
        values.update(L.ffn_param_init(generator, cfg.d_model, cfg.d_ff, cfg.glu))
        values["attn_norm"] = torch.zeros(cfg.d_model)
        values["ffn_norm"] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                state: Optional[Cache] = None, pos: int = 0):
        """h (B, S, D) bf16 at ``positions`` (S,) -> (h, new state or None).
        ``pos`` is the position of a decode step's token."""
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        if self.ltype == "R":
            y, new_state = rglru_lib.rglru_block(self, x, state)
        else:
            y, new_state = self._attention(x, positions, state, pos)
        h = h + y
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        return h + L.ffn_apply(self, x, cfg.act, cfg.glu), new_state

    def _attention(self, x, positions, state, pos):
        """Local attention. Without a state, or in a prefill (S > 1), the S
        queries at positions 0..S-1 attend through the flash kernel with the
        window mask; a prefill then writes the last ``window`` keys into a
        fresh rolling cache. A decode step (S = 1) writes its key into slot
        ``pos % window`` of a copy of the cache and attends over the cache,
        masked by the slots' positions."""
        cfg = self.cfg
        q, k, v = L.attn_qkv(self, x, self.dims)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        window = cfg.window_size or L.GLOBAL_WINDOW
        if state is None or q.shape[1] > 1:
            o = ops.flash_attention(q, k, v, causal=True, window=window)
            new = None if state is None else _roll_window_cache(k, v, positions,
                                                                state["k"].shape[1])
        else:
            slot = pos % state["k"].shape[1]
            new = {name: state[name].clone() for name in ("k", "v", "pos")}
            new["k"][:, slot] = k[:, 0].to(torch.bfloat16)
            new["v"][:, slot] = v[:, 0].to(torch.bfloat16)
            new["pos"][0, slot] = pos
            o = L.attention_scores(q, new["k"], new["v"], positions, new["pos"][0],
                                   causal=True, window=window)
        return L.attn_out(self, o), new


def _roll_window_cache(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                       window: int) -> Cache:
    """The last ``window`` keys and values of a prefill (bf16) at their
    rolling slots (slot = position % window); the other slots hold zeros at
    position -1."""
    b, s = k.shape[:2]
    take = min(s, window)
    pos_tail = positions[s - take:]
    slots = pos_tail % window
    out = {}
    for name, x in (("k", k), ("v", v)):
        buf = torch.zeros((b, window) + tuple(x.shape[2:]), dtype=torch.bfloat16,
                          device=x.device)
        buf[:, slots] = x[:, s - take:].to(torch.bfloat16)
        out[name] = buf
    out["pos"] = torch.full((1, window), -1, dtype=torch.int32, device=k.device)
    out["pos"][0, slots] = pos_tail.to(torch.int32)
    return out


class HybridLM(BaseLM):
    """Griffin-style periodic stack (recurrentgemma's "RRL"): ``num_layers``
    blocks of the tiled pattern, kept as one flat list. The reference's
    parameter tree and cache are ``{"periods": {"l0", "l1", ...} stacked
    over the full periods on axis 0, "tail": [the leftover layers]}``; the
    port's ``param_tree`` and cache use that layout."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(HybridBlock(cfg, t, device) for t in cfg.layer_types())

    def _split(self) -> Tuple[int, int]:
        """(pattern period, number of full periods)."""
        period = len(self.cfg.layer_pattern)
        return period, self.cfg.num_layers // period

    def _to_tree(self, per_layer: List[dict]) -> dict:
        """Per-layer dicts (leaves: tensors) -> ``{"periods": {"l<j>": {name:
        [one per period]}}, "tail": [...]}``."""
        period, n_full = self._split()
        periods = {
            f"l{j}": {name: [per_layer[i * period + j][name] for i in range(n_full)]
                      for name in per_layer[j]}
            for j in range(period)
        } if n_full else {}
        return {"periods": periods, "tail": per_layer[n_full * period:]}

    def _layer_states(self, cache: dict) -> List[Cache]:
        """The cache in reference layout -> one state dict per layer."""
        period, n_full = self._split()
        states = [{name: c[i] for name, c in cache["periods"][f"l{j}"].items()}
                  for i in range(n_full) for j in range(period)]
        return states + list(cache["tail"])

    def param_tree(self) -> dict:
        tree = self._to_tree([dict(b.named_parameters()) for b in self.layers])
        return {"embed": dict(self.embed.items()), **tree}

    def _cache_tree(self, states: List[Cache]) -> dict:
        tree = self._to_tree(states)
        tree["periods"] = {j: {name: torch.stack(v) for name, v in st.items()}
                           for j, st in tree["periods"].items()}
        return tree

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, T, V) bf16, aux loss 0)."""
        h = self._embed(batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)
        for block in self.layers:
            h, _ = block(h, positions)
        return self._logits(h), torch.zeros((), dtype=torch.float32, device=h.device)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Empty serving state; ``max_len`` is unused (the recurrent state is
        O(1) and the attention cache a rolling window). An R layer holds
        ``h`` (B, W) and ``conv`` (B, cw-1, W) fp32; an L layer ``k``, ``v``
        (B, window, KV, Dh) bf16 and ``pos`` (1, window) int32 at -1."""
        cfg, dev = self.cfg, self.device
        w, win = cfg.lru_width or cfg.d_model, cfg.window_size
        kv_shape = (batch_size, win, cfg.num_kv_heads, cfg.head_dim)

        def empty(ltype: str) -> Cache:
            if ltype == "R":
                return {"h": torch.zeros((batch_size, w), dtype=torch.float32, device=dev),
                        "conv": torch.zeros((batch_size, cfg.conv_width - 1, w),
                                            dtype=torch.float32, device=dev)}
            return {"k": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
                    "v": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
                    "pos": torch.full((1, win), -1, dtype=torch.int32, device=dev)}

        return self._cache_tree([empty(b.ltype) for b in self.layers])

    def _run_serving(self, h: torch.Tensor, cache: dict, positions: torch.Tensor,
                     pos: int) -> Tuple[torch.Tensor, dict]:
        new = []
        for block, state in zip(self.layers, self._layer_states(cache)):
            h, st = block(h, positions, state, pos)
            new.append(st)
        return h, self._cache_tree(new)

    def prefill(self, batch: Dict[str, torch.Tensor], cache: dict) -> Tuple[torch.Tensor, dict]:
        """-> (logits of the last position (B, 1, V) bf16, new cache). A
        one-token prompt takes the decode branch at position 0, as in the
        reference."""
        h = self._embed(batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)
        h, new_cache = self._run_serving(h, cache, positions, 0)
        return self._logits(h[:, -1:, :]), new_cache

    def decode_step(self, token: torch.Tensor, cache: dict, pos) -> Tuple[torch.Tensor, dict]:
        """token (B,) at position ``pos`` (a Python int or a 0-d tensor) ->
        (logits (B, V) bf16, new cache)."""
        pos = int(pos)
        h = self._embed(token[:, None])
        positions = torch.tensor([pos], device=h.device)
        h, new_cache = self._run_serving(h, cache, positions, pos)
        return self._logits(h)[:, 0, :], new_cache


class EncoderBlock(nn.Module):
    """One encoder layer of the encoder-decoder: ``attn_norm``, non-causal
    self-attention without rope (through the flash kernel), residual add,
    ``ffn_norm``, the FFN, residual add."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,)}
        shapes.update(L.attn_param_shapes(self.dims))
        shapes.update(L.ffn_param_shapes(cfg.d_model, cfg.d_ff, cfg.glu))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        values = L.attn_param_init(generator, self.dims)
        values.update(L.ffn_param_init(generator, cfg.d_model, cfg.d_ff, cfg.glu))
        values["attn_norm"] = torch.zeros(cfg.d_model)
        values["ffn_norm"] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h (B, F, D) bf16 -> the layer's output (B, F, D) bf16."""
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        q, k, v = L.attn_qkv(self, x, self.dims)
        h = h + L.attn_out(self, ops.flash_attention(q, k, v, causal=False))
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        return h + L.ffn_apply(self, x, cfg.act, cfg.glu)


class DecoderBlock(nn.Module):
    """One decoder layer of the encoder-decoder: ``attn_norm``, causal
    self-attention with rope (:func:`self_attention`), residual add,
    ``cross_norm``, cross attention (``x_wq`` .. ``x_wo``, no rope,
    non-causal) over the encoder's output, residual add, ``ffn_norm``, the
    FFN, residual add."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"attn_norm": (cfg.d_model,), "cross_norm": (cfg.d_model,),
                  "ffn_norm": (cfg.d_model,)}
        attn = L.attn_param_shapes(self.dims)
        shapes.update(attn)
        shapes.update({f"x_{k}": v for k, v in attn.items()})
        shapes.update(L.ffn_param_shapes(cfg.d_model, cfg.d_ff, cfg.glu))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        values = L.attn_param_init(generator, self.dims)
        values.update({f"x_{k}": v for k, v in L.attn_param_init(generator, self.dims).items()})
        values.update(L.ffn_param_init(generator, cfg.d_model, cfg.d_ff, cfg.glu))
        for name in ("attn_norm", "cross_norm", "ffn_norm"):
            values[name] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def forward(self, h: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor,
                state: Optional[Cache] = None, pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """h (B, S, D) bf16 at ``positions``, the encoder's output enc_out
        (B, F, D) bf16 -> (h, {"k", "v"}). The self-attention and its cache
        are :func:`self_attention`'s. The cross attention's keys and values
        are computed from ``enc_out`` at every call; without a state
        (forward, prefill) the queries attend through the flash kernel, in
        a decode step with the plain attention."""
        cfg = self.cfg
        b, s, _ = h.shape
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        y, new = self_attention(self, x, positions, state, pos, theta=cfg.rope_theta)
        h = h + y
        x = L.rms_norm(h, self.cross_norm, cfg.norm_eps)
        f = enc_out.shape[1]
        xq = (x @ L.cast(self.x_wq)).reshape(b, s, cfg.num_heads, cfg.head_dim)
        xk = (enc_out @ L.cast(self.x_wk)).reshape(b, f, cfg.num_kv_heads, cfg.head_dim)
        xv = (enc_out @ L.cast(self.x_wv)).reshape(b, f, cfg.num_kv_heads, cfg.head_dim)
        if state is None:
            o = ops.flash_attention(xq, xk, xv, causal=False)
        else:
            o = L.attention_scores(xq, xk, xv, positions, torch.arange(f, device=h.device),
                                   causal=False)
        h = h + o.reshape(b, s, -1) @ L.cast(self.x_wo)
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        return h + L.ffn_apply(self, x, cfg.act, cfg.glu), new


class EncDecLM(BaseLM):
    """Whisper-style encoder-decoder: ``encoder_layers`` encoder blocks over
    a batch's ``frames`` (B, F, D) (the audio frontend is a stub: the frames
    are its output), ``enc_norm``, then ``num_layers`` decoder blocks over
    the tokens with cross attention to the encoder's output. The parameter
    tree is the reference's, ``{"embed", "enc_norm", "encoder": {name:
    stacked}, "decoder": {name: stacked}}``; the serving cache is ``{"k",
    "v"}`` (L, B, max_len, KV, Dh) bf16 and ``"enc_out"`` (B,
    encoder_seq, D) bf16."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.enc_norm = nn.Parameter(torch.empty(cfg.d_model, device=device),
                                     requires_grad=False)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device) for _ in range(cfg.num_layers))

    def param_tree(self) -> dict:
        return {"embed": dict(self.embed.items()), "enc_norm": self.enc_norm,
                "encoder": stacked(self.encoder), "decoder": stacked(self.decoder)}

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "EncDecLM":
        """As :meth:`BaseLM.init`: the encoder's blocks, the decoder's, then
        the embedding; ``enc_norm`` zeros."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for block in (*self.encoder, *self.decoder):
            block.reset_parameters(generator)
        self._init_embed(generator)
        self.enc_norm.zero_()
        return self

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, D) -> the encoder's output (B, F, D) bf16, after
        ``enc_norm``."""
        h = L.cast(frames)
        for block in self.encoder:
            h = block(h)
        return L.rms_norm(h, self.enc_norm, self.cfg.norm_eps)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V) bf16, aux loss 0)."""
        enc_out = self.encode(batch["frames"])
        h = self._embed(batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)
        for block in self.decoder:
            h, _ = block(h, enc_out, positions)
        return self._logits(h), torch.zeros((), dtype=torch.float32, device=h.device)

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero ``k``, ``v`` (L, B, max_len, KV, Dh) and ``enc_out`` (B,
        encoder_seq, D), all bf16."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache = {name: torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
                 for name in ("k", "v")}
        cache["enc_out"] = torch.zeros((batch_size, cfg.encoder_seq, cfg.d_model),
                                       dtype=torch.bfloat16, device=self.device)
        return cache

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """-> (logits of the last position (B, 1, V) bf16, new cache): the
        encoder's output, and every decoder layer's keys and values in slots
        0..S-1 of fresh ``k``, ``v`` caches of the given shape, zeros
        after."""
        enc_out = self.encode(batch["frames"])
        h = self._embed(batch["tokens"])
        s = h.shape[1]
        positions = torch.arange(s, device=h.device)
        new = {name: torch.zeros_like(cache[name]) for name in ("k", "v")}
        for i, block in enumerate(self.decoder):
            h, st = block(h, enc_out, positions)
            for name in new:
                new[name][i, :, :s] = st[name]
        new["enc_out"] = enc_out
        return self._logits(h[:, -1:, :]), new

    def decode_step(self, token: torch.Tensor, cache: Cache, pos) -> Tuple[torch.Tensor, Cache]:
        """token (B,) at position ``pos`` -> (logits (B, V) bf16, new cache);
        each layer's cross attention recomputes its keys and values from the
        cached ``enc_out``."""
        pos = int(pos)
        h = self._embed(token[:, None])
        positions = torch.tensor([pos], device=h.device)
        enc_out = L.cast(cache["enc_out"])
        new = {"k": [], "v": []}
        for i, block in enumerate(self.decoder):
            h, st = block(h, enc_out, positions, {n: cache[n][i] for n in new}, pos)
            for name in new:
                new[name].append(st[name])
        out = {name: torch.stack(v) for name, v in new.items()}
        out["enc_out"] = cache["enc_out"]
        return self._logits(h)[:, 0, :], out


def build_model(cfg: Union[str, ModelConfig], device=None) -> BaseLM:
    """The module of ``cfg`` with uninitialised parameters on ``device``
    (default: the card; ``"meta"`` allocates nothing), chosen as the
    reference chooses: ``EncDecLM`` for an encoder-decoder, ``RwkvLM`` when
    every layer is RWKV-6, ``HybridLM`` when any is RG-LRU, else ``LM``.
    Call ``init`` or :func:`repro_torch.models.convert.params_from_jax` to
    fill it."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    types = set(cfg.layer_types())
    if cfg.is_encdec:
        cls = EncDecLM
    elif types == {"W"}:
        cls = RwkvLM
    elif "R" in types:
        cls = HybridLM
    else:
        cls = LM
    return cls(cfg, resolve_device(device))


def param_shapes(cfg: Union[str, ModelConfig]) -> dict:
    """Parameter shapes of ``cfg``'s model, from its module built on the
    ``meta`` device, in the reference's init-tree layout."""
    return build_model(cfg, device="meta").param_shapes()


def count_params(cfg: Union[str, ModelConfig]) -> int:
    return sum(math.prod(s) for s in tree_leaves(
        param_shapes(cfg), lambda n: isinstance(n, tuple)).values())


def count_active_params(cfg: Union[str, ModelConfig]) -> int:
    """Parameters a token activates: each routed-expert leaf (``we_*``)
    scaled by top_k / num_experts, as the reference counts them."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    total = 0
    for path, shape in tree_leaves(param_shapes(cfg), lambda n: isinstance(n, tuple)).items():
        n = math.prod(shape)
        if str(path[-1]).startswith("we_") and cfg.num_experts:
            n = n * cfg.top_k // cfg.num_experts
        total += n
    return total
