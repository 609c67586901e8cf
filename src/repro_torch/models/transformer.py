"""Generic decoder/encoder stack — PyTorch port of ``repro/models/transformer.py``.

The stack is a list of :class:`LayerDef` factored into

    prefix layers  +  (cycle of length c) × reps  +  suffix layers

exactly as in the reference, and the parameter and cache trees keep its
layout: the repeated cycle's leaves are stacked under ``"blocks"`` with a
leading layer axis, so ``weights.params_from_jax`` maps a JAX tree leaf for
leaf.  PyTorch runs eagerly, so the reference's ``lax.scan`` over the cycle
is a Python loop over that axis.

Three modes share the layer application: ``train`` (full sequence, no
cache), ``prefill`` (full sequence, emits the decode cache) and ``decode``
(one token, updates the cache in place).  The port has, in every mode, the
``attn`` mixer with a dense FFN and the whisper decoder's cross-attention,
and the recurrentgemma hybrid's ``recurrent`` (RG-LRU) and ``local_attn``
(sliding window, ring-buffer cache) mixers; and the ``rwkv`` mixer with the
``rwkv_cm`` channel mix in ``train`` only.  Every other mixer or FFN kind,
and rwkv serving, raises ``NotImplementedError`` naming its ROADMAP item.
The MoE auxiliary loss the reference threads through is therefore always
zero here and is not carried.
The reference's ``cfg.remat_policy`` (a ``jax.checkpoint`` around each
repeated block) is not ported: eager autograd keeps every layer's
activations (ROADMAP A3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str              # attn | local_attn | recurrent | rwkv | mla | cross_only
    ffn: str                # dense | moe | rwkv_cm
    cross: bool = False     # additional cross-attn (whisper decoder)


#: layer kinds not yet ported -> the ROADMAP item that ports them
_NOT_PORTED = {
    "mla": "ROADMAP A8.3 (deepseek-v2-236b)",
    "moe": "ROADMAP A8.3 (deepseek-v2-236b, moonshot-v1-16b-a3b)",
    "cross_only": "ROADMAP A8.5 (llama-3.2-vision-90b)",
}


#: layer kinds ported for ``train`` only -> the ROADMAP item that serves them
_SERVING_NOT_PORTED = {
    "rwkv": "ROADMAP A8.2 (rwkv6-7b serving: rwkv_decode and the prefill state)",
    "rwkv_cm": "ROADMAP A8.2 (rwkv6-7b serving: the channel-mix token-shift cache)",
}


def _require_ported(ld: LayerDef, serving: bool = False) -> None:
    missing = dict(_NOT_PORTED, **(_SERVING_NOT_PORTED if serving else {}))
    for kind in (ld.mixer, ld.ffn):
        if kind in missing:
            what = "for serving" if kind in _SERVING_NOT_PORTED else "yet"
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported {what}: {missing[kind]}")


def build_layer_defs(cfg) -> List[LayerDef]:
    if cfg.family == "rwkv":
        return [LayerDef("rwkv", "rwkv_cm")] * cfg.num_layers
    if cfg.family == "vision":
        e = cfg.cross_attn_every
        return [LayerDef("cross_only" if (i % e) == e - 1 else "attn", "dense")
                for i in range(cfg.num_layers)]
    if cfg.family == "encdec":
        return [LayerDef("attn", "dense", cross=True)] * cfg.num_layers
    if cfg.moe is not None:
        mixer = "mla" if cfg.mla is not None else "attn"
        f = cfg.moe.first_moe_layer
        return [LayerDef(mixer, "dense" if i < f else "moe")
                for i in range(cfg.num_layers)]
    kinds = cfg.layer_kinds()
    return [LayerDef(k, "dense") for k in kinds]


def factor_layers(cfg, defs: List[LayerDef]) -> Tuple[List, List, int, List]:
    """-> (prefix_defs, cycle_defs, reps, suffix_defs)."""
    prefix_len = 0
    if cfg.moe is not None:
        prefix_len = cfg.moe.first_moe_layer
    cyc_len = 1
    if cfg.family == "hybrid":
        cyc_len = len(cfg.block_pattern)
    elif cfg.family == "vision":
        cyc_len = cfg.cross_attn_every
    body = defs[prefix_len:]
    reps = len(body) // cyc_len
    cycle = body[:cyc_len] if reps else []
    suffix = body[reps * cyc_len:]
    for i, d in enumerate(body[: reps * cyc_len]):
        assert d == cycle[i % cyc_len], f"non-cyclic layer structure at {i}"
    return defs[:prefix_len], cycle, reps, suffix


# ---------------------------------------------------------------------------
# per-layer specs and caches


def layer_specs(cfg, ld: LayerDef) -> dict:
    _require_ported(ld)
    s = {"ln1": cm.norm_spec(cfg, cfg.d_model)}
    if ld.mixer == "rwkv":
        s["mixer"] = rwkv_mod.rwkv_specs(cfg)
    elif ld.mixer == "recurrent":
        s["mixer"] = rglru_mod.rglru_specs(cfg)
    else:                                   # attn | local_attn
        s["mixer"] = attn.attn_specs(cfg)
    if ld.cross:
        s["ln_cross"] = cm.norm_spec(cfg, cfg.d_model)
        s["cross"] = attn.attn_specs(cfg, cross=True)
    s["ln2"] = cm.norm_spec(cfg, cfg.d_model)
    s["ffn"] = (ffn_mod.rwkv_channel_mix_specs(cfg) if ld.ffn == "rwkv_cm"
                else ffn_mod.ffn_specs(cfg))
    return s


def stack_specs(tree, n: int):
    return cm.tree_map(
        lambda s: cm.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                               s.init, s.scale), tree)


def layer_cache(cfg, ld: LayerDef, batch: int, seq_len: int, device) -> dict:
    """Zero decode cache for one layer."""
    _require_ported(ld, serving=True)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    pdt = torch_dtype(cfg.param_dtype)

    def mk(*shape, dtype=pdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if ld.mixer == "recurrent":
        r = cfg.recurrent
        c = {"h": mk(batch, r.lru_width, dtype=torch.float32),
             "conv": mk(batch, r.conv_width - 1, r.lru_width, dtype=torch.float32)}
    else:
        # a local layer keeps a ring buffer of its window's latest positions
        slots = min(cfg.local_window, seq_len) if ld.mixer == "local_attn" else seq_len
        c = {"k": mk(batch, slots, K, hd), "v": mk(batch, slots, K, hd)}
    if ld.cross:
        t = cfg.encoder_frames
        # cross-attention layers are full MHA (attn_specs(cross=True))
        c["cross_k"] = mk(batch, t, cfg.num_heads, hd)
        c["cross_v"] = mk(batch, t, cfg.num_heads, hd)
    return c


def stack_cache(tree, n: int):
    return cm.tree_map(lambda t: t.new_zeros((n,) + tuple(t.shape)), tree)


def _at(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so in-place writes land in it)."""
    return cm.tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# layer application


def apply_layer_train(cfg, ld, p, x, positions, ctx, bidirectional=False):
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "rwkv":
        out, _, _ = rwkv_mod.rwkv_time_mix(cfg, p["mixer"], h, want_state=False)
    elif ld.mixer == "recurrent":
        out, _ = rglru_mod.rglru_block(cfg, p["mixer"], h)
    elif ld.mixer == "local_attn":
        out = attn.self_attention(cfg, p["mixer"], h, positions, window=cfg.local_window)
    else:
        out = attn.self_attention(cfg, p["mixer"], h, positions, causal=not bidirectional)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc, attn.cross_kv(p["cross"], ctx))
    h2 = cm.apply_norm(cfg, p["ln2"], x)
    if ld.ffn == "rwkv_cm":
        prev = F.pad(h2, (0, 0, 1, 0))[:, :-1]          # token shift, zero at t=0
        return x + ffn_mod.rwkv_channel_mix(cfg, p["ffn"], h2, prev)
    return x + ffn_mod.ffn(cfg, p["ffn"], h2)


def apply_layer_prefill(cfg, ld, p, x, positions, ctx):
    """Train-path compute + emit the decode cache (sized to the prompt; the
    caller right-pads it to max_seq)."""
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "recurrent":
        out, (hf, conv) = rglru_mod.rglru_block(cfg, p["mixer"], h)
        cache = {"h": hf, "conv": conv}
    else:
        window = cfg.local_window if ld.mixer == "local_attn" else None
        out, cache = attn.prefill_attention(cfg, p["mixer"], h, positions, window=window)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        ckv = attn.cross_kv(p["cross"], ctx)
        x = x + attn.cross_attention(cfg, p["cross"], hc, ckv)
        cache.update({"cross_k": ckv["k"], "cross_v": ckv["v"]})
    h2 = cm.apply_norm(cfg, p["ln2"], x)
    return x + ffn_mod.ffn(cfg, p["ffn"], h2), cache


def apply_layer_decode(cfg, ld, p, x, cache, pos):
    """x: (B,1,d). Updates ``cache`` in place; returns x."""
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "recurrent":
        out, hf, conv = rglru_mod.rglru_decode(cfg, p["mixer"], h, cache["h"], cache["conv"])
        cache["h"].copy_(hf)
        cache["conv"].copy_(conv)
    else:
        window = cfg.local_window if ld.mixer == "local_attn" else None
        out, _ = attn.decode_attention(cfg, p["mixer"], h,
                                       {"k": cache["k"], "v": cache["v"]}, pos, window=window)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc,
                                     {"k": cache["cross_k"], "v": cache["cross_v"]})
    h2 = cm.apply_norm(cfg, p["ln2"], x)
    return x + ffn_mod.ffn(cfg, p["ffn"], h2)


# ---------------------------------------------------------------------------
# stack


class Stack:
    """Factored layer stack bound to a config (decoder by default)."""

    def __init__(self, cfg, bidirectional: bool = False,
                 defs: Optional[List[LayerDef]] = None):
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.defs = defs if defs is not None else build_layer_defs(cfg)
        for d in self.defs:
            _require_ported(d)
        self.prefix, self.cycle, self.reps, self.suffix = factor_layers(cfg, self.defs)

    def _layers(self, p: dict):
        """Yield ``(group, key, layer index or None, LayerDef, layer params)``
        in execution order."""
        for i, d in enumerate(self.prefix):
            yield "prefix", str(i), None, d, p["prefix"][str(i)]
        for r in range(self.reps):
            for i, d in enumerate(self.cycle):
                yield "blocks", str(i), r, d, _at(p["blocks"][str(i)], r)
        for i, d in enumerate(self.suffix):
            yield "suffix", str(i), None, d, p["suffix"][str(i)]

    # -- specs --------------------------------------------------------------
    def specs(self) -> dict:
        s = {}
        if self.prefix:
            s["prefix"] = {str(i): layer_specs(self.cfg, d)
                           for i, d in enumerate(self.prefix)}
        if self.reps:
            s["blocks"] = {str(i): stack_specs(layer_specs(self.cfg, d), self.reps)
                           for i, d in enumerate(self.cycle)}
        if self.suffix:
            s["suffix"] = {str(i): layer_specs(self.cfg, d)
                           for i, d in enumerate(self.suffix)}
        return s

    def cache(self, batch: int, seq_len: int, device) -> dict:
        c = {}
        if self.prefix:
            c["prefix"] = {str(i): layer_cache(self.cfg, d, batch, seq_len, device)
                           for i, d in enumerate(self.prefix)}
        if self.reps:
            c["blocks"] = {str(i): stack_cache(
                layer_cache(self.cfg, d, batch, seq_len, device), self.reps)
                for i, d in enumerate(self.cycle)}
        if self.suffix:
            c["suffix"] = {str(i): layer_cache(self.cfg, d, batch, seq_len, device)
                           for i, d in enumerate(self.suffix)}
        return c

    # -- forward ------------------------------------------------------------
    def train(self, p: dict, x, positions, ctx=None):
        for _, _, _, d, lp in self._layers(p):
            x = apply_layer_train(self.cfg, d, lp, x, positions, ctx, self.bidirectional)
        return x

    def _require_serving(self) -> None:
        for d in self.defs:
            _require_ported(d, serving=True)

    def prefill(self, p: dict, x, positions, ctx=None):
        self._require_serving()
        caches: dict = {}
        stacked: dict = {}
        for group, key, r, d, lp in self._layers(p):
            x, c = apply_layer_prefill(self.cfg, d, lp, x, positions, ctx)
            if r is None:
                caches.setdefault(group, {})[key] = c
            else:
                stacked.setdefault(key, []).append(c)
        if stacked:
            caches["blocks"] = {key: {name: torch.stack([c[name] for c in cs])
                                      for name in cs[0]}
                                for key, cs in stacked.items()}
        return x, caches

    def decode(self, p: dict, x, caches: dict, pos):
        """One token; ``caches`` is updated in place and returned."""
        self._require_serving()
        for group, key, r, d, lp in self._layers(p):
            c = caches[group][key] if r is None else _at(caches[group][key], r)
            x = apply_layer_decode(self.cfg, d, lp, x, c, pos)
        return x, caches
