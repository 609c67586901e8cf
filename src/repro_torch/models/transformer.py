"""Generic decoder/encoder stack — PyTorch port of ``repro/models/transformer.py``.

The stack is a list of :class:`LayerDef` factored into

    prefix layers  +  (cycle of length c) × reps  +  suffix layers

exactly as in the reference, and the parameter and cache trees keep its
layout: the repeated cycle's leaves are stacked under ``"blocks"`` with a
leading layer axis, so ``weights.params_from_jax`` maps a JAX tree leaf for
leaf.  PyTorch runs eagerly, so the reference's ``lax.scan`` over the cycle
is a Python loop over that axis.

Three modes share the layer application: ``train`` (full sequence, no
cache), ``prefill`` (full sequence, or a suffix against a cached prefix;
emits the decode cache) and ``decode`` (one token, updates the cache in
place: the contiguous cache or, for paged serving, a page pool read
through per-row page tables).  Every mode has the mixers ``attn`` (with
the whisper decoder's cross-attention), ``local_attn`` (sliding window,
ring-buffer cache), ``recurrent`` (RG-LRU), ``rwkv`` (its state and
token-shift carries) and ``mla`` (latent cache, absorbed decode), and the
FFNs ``dense``, ``moe`` and ``rwkv_cm``, and the ``cross_only`` mixer
(llama-3.2-vision-90b: full-MHA cross-attention to the image embeddings,
gated by ``tanh(xgate)``, its K/V resident in the decode cache).  The MoE
auxiliary loss is threaded through every mode, as in the reference;
``train`` returns it, ``prefill`` and ``decode`` drop it.
``train`` wraps each repetition of the cycle in ``cfg.remat_policy`` as
the reference does (``common.maybe_remat``: ``"full"`` and, on one device,
``"moe"`` recompute the block in backward, ``"dots"`` / ``"dots_no_batch"``
keep its products' outputs, ``"nothing"`` keeps every activation), when
autograd records; ``prefill`` and ``decode`` run without autograd in the
port, so they are not wrapped.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import ctx as dctx
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str              # attn | local_attn | recurrent | rwkv | mla | cross_only
    ffn: str                # dense | moe | rwkv_cm
    cross: bool = False     # additional cross-attn (whisper decoder)


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
    s = {"ln1": cm.norm_spec(cfg, cfg.d_model)}
    if ld.mixer == "rwkv":
        s["mixer"] = rwkv_mod.rwkv_specs(cfg)
    elif ld.mixer == "recurrent":
        s["mixer"] = rglru_mod.rglru_specs(cfg)
    elif ld.mixer == "mla":
        s["mixer"] = mla_mod.mla_specs(cfg)
    elif ld.mixer == "cross_only":
        s["mixer"] = attn.attn_specs(cfg, cross=True)
        s["xgate"] = cm.ParamSpec((1,), (None,), torch.float32, "zeros")
    else:                                   # attn | local_attn
        s["mixer"] = attn.attn_specs(cfg)
    if ld.cross:
        s["ln_cross"] = cm.norm_spec(cfg, cfg.d_model)
        s["cross"] = attn.attn_specs(cfg, cross=True)
    s["ln2"] = cm.norm_spec(cfg, cfg.d_model)
    if ld.ffn == "rwkv_cm":
        s["ffn"] = ffn_mod.rwkv_channel_mix_specs(cfg)
    elif ld.ffn == "moe":
        s["ffn"] = moe_mod.moe_specs(cfg)
    else:
        s["ffn"] = ffn_mod.ffn_specs(cfg)
    return s


def stack_specs(tree, n: int):
    return cm.tree_map(
        lambda s: cm.ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                               s.init, s.scale), tree)


def layer_cache(cfg, ld: LayerDef, batch: int, seq_len: int, device) -> dict:
    """Zero decode cache for one layer."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    pdt = torch_dtype(cfg.param_dtype)

    def mk(*shape, dtype=pdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if ld.mixer == "recurrent":
        r = cfg.recurrent
        c = {"h": mk(batch, r.lru_width, dtype=torch.float32),
             "conv": mk(batch, r.conv_width - 1, r.lru_width, dtype=torch.float32)}
    elif ld.mixer == "rwkv":
        hd_r = cfg.rwkv.head_dim
        c = {"s": mk(batch, cfg.num_heads, hd_r, hd_r, dtype=torch.float32),
             "ts_tm": mk(batch, cfg.d_model), "ts_cm": mk(batch, cfg.d_model)}
    elif ld.mixer == "mla":
        a = cfg.mla
        c = {"c_kv": mk(batch, seq_len, a.kv_lora_rank),
             "k_rope": mk(batch, seq_len, a.qk_rope_head_dim)}
    elif ld.mixer == "cross_only":
        # the image K/V, computed once at prefill (full MHA, K = H)
        t = cfg.num_image_tokens
        c = {"ck": mk(batch, t, cfg.num_heads, hd), "cv": mk(batch, t, cfg.num_heads, hd)}
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


#: cache leaves that page (global, unbounded-growth KV and MLA latents);
#: every other leaf is *resident* — bounded per-row state (ring-buffer
#: window, recurrent and rwkv carries, precomputed cross K/V) that stays
#: slot-granular
_PAGED_MIXER_LEAVES = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope")}


def layer_cache_paged(cfg, ld: LayerDef, batch: int, seq_len: int,
                      pool_pages: int, page_size: int, device) -> dict:
    """Like :func:`layer_cache`, but pageable leaves take the pool layout
    ``(pool_pages + 1, page_size, ...)`` — row 0 is the null page — shared
    across batch rows through per-row page tables.  Resident leaves keep
    their slot-granular ``(batch, ...)`` layout."""
    c = layer_cache(cfg, ld, batch, seq_len, device)
    pdt = torch_dtype(cfg.param_dtype)
    for name in _PAGED_MIXER_LEAVES.get(ld.mixer, ()):
        c[name] = torch.zeros((pool_pages + 1, page_size) + tuple(c[name].shape[2:]),
                              dtype=pdt, device=device)
    return c


def layer_paged_flags(cfg, ld: LayerDef) -> dict:
    """Cache-structured tree of bools: True on pageable leaves."""
    paged = _PAGED_MIXER_LEAVES.get(ld.mixer, ())
    base = layer_cache(cfg, ld, 1, 2, "meta")       # leaf names only
    return {name: name in paged for name in base}


# ---------------------------------------------------------------------------
# layer application


def _ffn_apply(cfg, ld, p, x, aux):
    """The dense or MoE FFN on ``x`` (the residual added); -> (x, aux)."""
    h2 = cm.apply_norm(cfg, p["ln2"], x)
    if ld.ffn == "moe":
        out, a = moe_mod.moe_ffn(cfg, p["ffn"], h2)
        return x + out, aux + a
    return x + ffn_mod.ffn(cfg, p["ffn"], h2), aux


def _gated_cross(cfg, p, h, kv):
    """A ``cross_only`` layer's mixer: cross-attention to the image K/V,
    scaled by ``tanh(xgate)``."""
    out = attn.cross_attention(cfg, p["mixer"], h, kv)
    return out * torch.tanh(dctx.gathered(p["xgate"])).to(out.dtype)


#: layer kinds whose distributed paths are not ported yet ("cross": the
#: whisper decoder's cross-attention, whose context is the encoder's)
_NO_DISTRIBUTED = {"mla", "recurrent", "rwkv", "moe", "rwkv_cm", "cross"}


def undistributed_kind(defs) -> Optional[str]:
    """The first layer kind in ``defs`` whose distributed path is not
    ported (ROADMAP A9.2), or None."""
    for d in defs:
        for kind in (d.mixer, d.ffn) + (("cross",) if d.cross else ()):
            if kind in _NO_DISTRIBUTED:
                return kind
    return None


def _require_distributed(defs) -> None:
    """Under a sharding context, raise for a layer kind whose distributed
    path is not ported."""
    kind = undistributed_kind(defs)
    if kind is not None:
        raise NotImplementedError(f"layer kind {kind!r} under a sharding context: {dctx.A92}")


def apply_layer_train(cfg, ld, p, x, positions, ctx, aux, bidirectional=False):
    x = dctx.constrain(x, ("batch", "act_seq", None))
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "cross_only":
        out = _gated_cross(cfg, p, h, attn.cross_kv(p["mixer"], ctx))
    elif ld.mixer == "rwkv":
        out, _, _ = rwkv_mod.rwkv_time_mix(cfg, p["mixer"], h, want_state=False)
    elif ld.mixer == "recurrent":
        out, _ = rglru_mod.rglru_block(cfg, p["mixer"], h)
    elif ld.mixer == "mla":
        out = mla_mod.mla_attention(cfg, p["mixer"], h, positions)
    elif ld.mixer == "local_attn":
        out = attn.self_attention(cfg, p["mixer"], h, positions, window=cfg.local_window)
    else:
        out = attn.self_attention(cfg, p["mixer"], h, positions, causal=not bidirectional)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc, attn.cross_kv(p["cross"], ctx))
    if ld.ffn == "rwkv_cm":
        h2 = cm.apply_norm(cfg, p["ln2"], x)
        prev = F.pad(h2, (0, 0, 1, 0))[:, :-1]          # token shift, zero at t=0
        return x + ffn_mod.rwkv_channel_mix(cfg, p["ffn"], h2, prev), aux
    return _ffn_apply(cfg, ld, p, x, aux)


def apply_layer_prefill(cfg, ld, p, x, positions, ctx, aux, past=None, past_len=0):
    """Train-path compute + emit the decode cache (sized to the prompt; the
    caller right-pads it to max_seq); -> (x, cache, aux).  ``past``
    (prefix-cache reuse) carries this layer's already-computed prefix K/V
    or latents; only pageable mixers take it — the engine gates prefix
    sharing to stacks made purely of those."""
    if past is not None and ld.mixer not in _PAGED_MIXER_LEAVES:
        raise ValueError(f"prefix reuse unsupported for mixer {ld.mixer!r}")
    x = dctx.constrain(x, ("batch", "act_seq", None))
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "cross_only":
        ckv = attn.cross_kv(p["mixer"], ctx)
        out = _gated_cross(cfg, p, h, ckv)
        cache = {"ck": ckv["k"], "cv": ckv["v"]}
    elif ld.mixer == "recurrent":
        out, (hf, conv) = rglru_mod.rglru_block(cfg, p["mixer"], h)
        cache = {"h": hf, "conv": conv}
    elif ld.mixer == "rwkv":
        out, state, last = rwkv_mod.rwkv_time_mix(cfg, p["mixer"], h)
        cache = {"s": state, "ts_tm": last}
    elif ld.mixer == "mla":
        out, cache = mla_mod.mla_prefill(cfg, p["mixer"], h, positions, past=past,
                                         past_len=past_len)
    else:
        window = cfg.local_window if ld.mixer == "local_attn" else None
        out, cache = attn.prefill_attention(cfg, p["mixer"], h, positions, window=window,
                                            past=past, past_len=past_len)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        ckv = attn.cross_kv(p["cross"], ctx)
        x = x + attn.cross_attention(cfg, p["cross"], hc, ckv)
        cache.update({"cross_k": ckv["k"], "cross_v": ckv["v"]})
    if ld.ffn == "rwkv_cm":
        h2 = cm.apply_norm(cfg, p["ln2"], x)
        prev = F.pad(h2, (0, 0, 1, 0))[:, :-1]
        cache["ts_cm"] = h2[:, -1]
        return x + ffn_mod.rwkv_channel_mix(cfg, p["ffn"], h2, prev), cache, aux
    x, aux = _ffn_apply(cfg, ld, p, x, aux)
    return x, dctx.constrain_cache(cache), aux


def apply_layer_decode(cfg, ld, p, x, cache, pos, aux, tables=None, page_size=None):
    """x: (B,1,d). Updates ``cache`` in place; -> (x, aux).  With ``tables``
    (paged serving) the attn and mla leaves are a shared page pool read
    through per-row page tables; resident leaves keep per-row state."""
    x = dctx.constrain(x, ("batch", "act_seq", None))
    h = cm.apply_norm(cfg, p["ln1"], x)
    if ld.mixer == "cross_only":
        out = _gated_cross(cfg, p, h, {"k": cache["ck"], "v": cache["cv"]})
    elif ld.mixer == "recurrent":
        out, hf, conv = rglru_mod.rglru_decode(cfg, p["mixer"], h, cache["h"], cache["conv"])
        cache["h"].copy_(hf)
        cache["conv"].copy_(conv)
    elif ld.mixer == "rwkv":
        out, state, last = rwkv_mod.rwkv_decode(cfg, p["mixer"], h, cache["s"],
                                                cache["ts_tm"])
        cache["s"].copy_(state)
        cache["ts_tm"].copy_(last)
    elif ld.mixer == "mla":
        latents = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}
        if tables is not None:
            out, _ = mla_mod.mla_paged_decode(cfg, p["mixer"], h, latents, pos, tables,
                                              page_size=page_size)
        else:
            out, _ = mla_mod.mla_decode(cfg, p["mixer"], h, latents, pos)
    elif ld.mixer == "attn" and tables is not None:
        out, _ = attn.paged_decode_attention(cfg, p["mixer"], h,
                                             {"k": cache["k"], "v": cache["v"]}, pos,
                                             tables, page_size=page_size)
    else:
        window = cfg.local_window if ld.mixer == "local_attn" else None
        out, _ = attn.decode_attention(cfg, p["mixer"], h,
                                       {"k": cache["k"], "v": cache["v"]}, pos, window=window)
    x = x + out
    if ld.cross:
        hc = cm.apply_norm(cfg, p["ln_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc,
                                     {"k": cache["cross_k"], "v": cache["cross_v"]})
    if ld.ffn == "rwkv_cm":
        h2 = cm.apply_norm(cfg, p["ln2"], x)
        x = x + ffn_mod.rwkv_channel_mix(cfg, p["ffn"], h2, cache["ts_cm"][:, None])
        cache["ts_cm"].copy_(h2[:, 0])
        return x, aux
    return _ffn_apply(cfg, ld, p, x, aux)


# ---------------------------------------------------------------------------
# stack


class Stack:
    """Factored layer stack bound to a config (decoder by default)."""

    def __init__(self, cfg, bidirectional: bool = False,
                 defs: Optional[List[LayerDef]] = None):
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.defs = defs if defs is not None else build_layer_defs(cfg)
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

    def _groups(self, layer_fn, stacked_fn) -> dict:
        """A tree in the stack's layout (specs, caches, flags): ``layer_fn(d)``
        per prefix and suffix layer, ``stacked_fn(d)`` per layer of the
        repeated cycle."""
        c = {}
        if self.prefix:
            c["prefix"] = {str(i): layer_fn(d) for i, d in enumerate(self.prefix)}
        if self.reps:
            c["blocks"] = {str(i): stacked_fn(d) for i, d in enumerate(self.cycle)}
        if self.suffix:
            c["suffix"] = {str(i): layer_fn(d) for i, d in enumerate(self.suffix)}
        return c

    # -- specs --------------------------------------------------------------
    def specs(self) -> dict:
        def ls(d):
            return layer_specs(self.cfg, d)
        return self._groups(ls, lambda d: stack_specs(ls(d), self.reps))

    def cache(self, batch: int, seq_len: int, device) -> dict:
        def lc(d):
            return layer_cache(self.cfg, d, batch, seq_len, device)
        return self._groups(lc, lambda d: stack_cache(lc(d), self.reps))

    def paged_cache(self, batch: int, seq_len: int, pool_pages: int, page_size: int,
                    device) -> dict:
        """Decode cache with pageable leaves in pool layout (null page at
        row 0); ``seq_len`` still sizes the resident leaves."""
        def lc(d):
            return layer_cache_paged(self.cfg, d, batch, seq_len, pool_pages, page_size,
                                     device)
        return self._groups(lc, lambda d: stack_cache(lc(d), self.reps))

    def paged_flags(self) -> dict:
        """Cache-structured bool tree: True on pageable (pool-layout) leaves.
        Bools under ``blocks`` are not layer-stacked: a leaf's pagedness is
        the same in every repetition of the cycle."""
        def flags(d):
            return layer_paged_flags(self.cfg, d)
        return self._groups(flags, flags)

    # -- forward ------------------------------------------------------------
    def train(self, p: dict, x, positions, ctx=None):
        """-> (features, the summed MoE auxiliary loss; 0 without MoE).
        Under a sharding context ``x`` is this rank's shard of the residual
        layout and ``positions`` the whole sequence's."""
        if dctx.current() is not None:
            _require_distributed(self.defs)
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, d in enumerate(self.prefix):
            x, aux = apply_layer_train(cfg, d, p["prefix"][str(i)], x, positions, ctx, aux,
                                       self.bidirectional)
        if self.reps:
            def body(x, aux, bp):
                for i, d in enumerate(self.cycle):
                    x, aux = apply_layer_train(cfg, d, bp[str(i)], x, positions, ctx, aux,
                                               self.bidirectional)
                return x, aux
            if torch.is_grad_enabled():
                body = cm.maybe_remat(body, cfg.remat_policy)
            for r in range(self.reps):
                x, aux = body(x, aux, _at(p["blocks"], r))
        for i, d in enumerate(self.suffix):
            x, aux = apply_layer_train(cfg, d, p["suffix"][str(i)], x, positions, ctx, aux,
                                       self.bidirectional)
        return x, aux

    def prefill(self, p: dict, x, positions, ctx=None, past=None, past_len=0):
        """``past`` (prefix-cache reuse): a cache-structured tree of this
        stack's prefix K/V (or latents) at length ``past_len``; only the
        suffix in ``x`` is computed and the emitted cache covers that
        suffix.  The MoE auxiliary loss is dropped, as in the reference."""
        if dctx.current() is not None:
            _require_distributed(self.defs)
        caches: dict = {}
        stacked: dict = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group, key, r, d, lp in self._layers(p):
            lpast = None
            if past is not None:
                lpast = past[group][key] if r is None else _at(past[group][key], r)
            x, c, aux = apply_layer_prefill(self.cfg, d, lp, x, positions, ctx, aux,
                                            past=lpast, past_len=past_len)
            if r is None:
                caches.setdefault(group, {})[key] = c
            else:
                stacked.setdefault(key, []).append(c)
        if stacked:
            caches["blocks"] = {key: {name: torch.stack([c[name] for c in cs])
                                      for name in cs[0]}
                                for key, cs in stacked.items()}
        return x, caches

    def decode(self, p: dict, x, caches: dict, pos, tables=None, page_size=None):
        """One token; ``caches`` is updated in place and returned.  With
        ``tables`` the pageable leaves are pools read through them."""
        if dctx.current() is not None:
            raise NotImplementedError(f"decode under a sharding context: {dctx.A92}")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group, key, r, d, lp in self._layers(p):
            c = caches[group][key] if r is None else _at(caches[group][key], r)
            x, aux = apply_layer_decode(self.cfg, d, lp, x, c, pos, aux, tables, page_size)
        return x, caches
