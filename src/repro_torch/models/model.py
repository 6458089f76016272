"""Model assembly: ``build_model(config)`` -> an ``nn.Module`` with ``init``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``.

Ported so far: ``LM``, the uniform decoder of attention + FFN blocks (the
dense family, gemma3's local / global pattern included), ``RwkvLM``, the
uniform RWKV-6 stack (attention-free), and ``HybridLM``, the Griffin-style
periodic stack of RG-LRU and local-attention blocks (recurrentgemma). MoE,
VLM and encoder-decoder models raise ``NotImplementedError``.

The residual stream is bf16, as in the reference: the embedding is cast to
bf16, each block returns its input's dtype and the residual adds run in
bf16. Parameters are fp32 ``nn.Parameter``s with the reference's names.
Each model keeps a flat list of blocks and maps it onto the reference's
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


def is_param_leaf(node) -> bool:
    """A leaf of ``param_tree``: a parameter, or a non-empty list of the
    parameters that the reference stacks on a leading axis."""
    return isinstance(node, torch.Tensor) or (
        isinstance(node, list) and bool(node) and isinstance(node[0], torch.Tensor))


def _params(shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, nn.Parameter]:
    """Uninitialised fp32 parameters of the given shapes. They take no
    gradient: the ported path serves (``requires_grad_()`` turns it on)."""
    return {
        name: nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()
    }


class BaseLM(nn.Module):
    """Embedding and output head shared by every family."""

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
        names = [n for n, _ in self.layers[0].named_parameters()]
        return {"embed": dict(self.embed.items()),
                "layers": {n: [getattr(b, n) for b in self.layers] for n in names}}

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

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token lookup times sqrt(d_model) in fp32, cast to bf16."""
        emb = F.embedding(tokens, self.embed["tok"])
        return L.cast(emb * math.sqrt(self.cfg.d_model))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm, then bf16 x bf16 against the (tied) table with fp32
        accumulation, stored bf16. The products of two bf16 values are exact
        in fp32, so the fp32 product of the upcast operands is that sum."""
        h = L.rms_norm(h, self.embed["final_norm"], self.cfg.norm_eps)
        table = self.embed["head"] if "head" in self.embed else self.embed["tok"]
        logits = torch.matmul(h.float(), L.cast(table).float().T)
        return logits.to(torch.bfloat16)


class DenseBlock(nn.Module):
    """One layer of the uniform decoder: ``attn_norm``, attention, residual
    add, ``ffn_norm``, the (GLU) FFN, residual add. An ``"L"`` layer attends
    within ``cfg.window_size`` keys with rope theta ``rope_theta``; a ``"G"``
    layer attends to every earlier key with ``rope_theta_global`` (or
    ``rope_theta``)."""

    def __init__(self, cfg: ModelConfig, ltype: str, device):
        super().__init__()
        self.cfg = cfg
        self.dims = L.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        self.window = cfg.window_size if ltype == "L" else None
        self.theta = cfg.rope_theta if ltype == "L" else (cfg.rope_theta_global or cfg.rope_theta)
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

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                state: Optional[Cache] = None, pos: int = 0) -> Tuple[torch.Tensor, Cache]:
        """h (B, S, D) bf16 at ``positions`` -> (h, {"k", "v"}).

        Without a state (forward, prefill) the S queries at positions
        0..S-1 attend through the flash kernel, and the new ``k``, ``v`` are
        this call's keys and values (B, S, KV, Dh) bf16. With a state (a
        decode step, S = 1 at position ``pos``) the key and value go into
        slot ``pos`` of a copy of the layer's cache (B, max_len, KV, Dh),
        and the query attends over every slot, masked by slot position."""
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        q, k, v = L.attn_qkv(self, x, self.dims)
        q = L.rope(q, positions, self.theta)
        k = L.rope(k, positions, self.theta)
        if state is None:
            o = ops.flash_attention(q, k, v, causal=True, window=self.window,
                                    logit_softcap=cfg.logit_softcap)
            new = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        else:
            new = {name: state[name].clone() for name in ("k", "v")}
            new["k"][:, pos] = k[:, 0].to(torch.bfloat16)
            new["v"][:, pos] = v[:, 0].to(torch.bfloat16)
            kv_pos = torch.arange(new["k"].shape[1], device=h.device)
            o = L.attention_scores(q, new["k"], new["v"], positions, kv_pos, causal=True,
                                   window=self.window, logit_softcap=cfg.logit_softcap)
        h = h + L.attn_out(self, o)
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        return h + L.ffn_apply(self, x, cfg.act, cfg.glu), new


class LM(BaseLM):
    """Uniform decoder: ``num_layers`` attention + FFN blocks, the layer
    pattern ("G", or gemma3's "LLLLLG") tiled over them. The serving cache
    is ``{"k", "v"}``, each (L, B, max_len, KV, Dh) bf16, the reference's
    layout."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, t, device) for t in cfg.layer_types())

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V) bf16, aux loss 0)."""
        h = self._embed(batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)
        for block in self.layers:
            h, _ = block(h, positions)
        return self._logits(h), torch.zeros((), dtype=torch.float32, device=h.device)

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero ``k``, ``v`` caches (L, B, max_len, KV, Dh) bf16."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {name: torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
                for name in ("k", "v")}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """-> (logits of the last position (B, 1, V) bf16, new cache): every
        layer's keys and values in slots 0..S-1 of a fresh cache of the given
        cache's shape, zeros after."""
        h = self._embed(batch["tokens"])
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


def build_model(cfg: Union[str, ModelConfig], device=None) -> BaseLM:
    """The module of ``cfg`` with uninitialised parameters on ``device``
    (default: the card; ``"meta"`` allocates nothing). Call ``init`` or
    :func:`repro_torch.models.convert.params_from_jax` to fill it."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    types = set(cfg.layer_types())
    if not cfg.is_encdec and types == {"W"}:
        return RwkvLM(cfg, resolve_device(device))
    if not cfg.is_encdec and "R" in types:
        return HybridLM(cfg, resolve_device(device))
    if cfg.family == "dense":
        return LM(cfg, resolve_device(device))
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}, layers {cfg.layer_pattern!r}): not ported yet; the "
        "port has the dense, RWKV-6 and RG-LRU hybrid families; MoE, VLM and "
        "encoder-decoder models come in a later slice")


def param_shapes(cfg: Union[str, ModelConfig]) -> dict:
    """Parameter shapes of ``cfg``'s model, from its module built on the
    ``meta`` device, in the reference's init-tree layout."""
    return build_model(cfg, device="meta").param_shapes()


def count_params(cfg: Union[str, ModelConfig]) -> int:
    def count(node) -> int:
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return math.prod(node)
    return count(param_shapes(cfg))
