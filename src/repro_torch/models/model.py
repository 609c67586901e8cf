"""Config → model: parameter specs, train loss and the serving steps —
PyTorch port of ``repro/models/model.py``.

- :func:`model_specs`        — ParamSpec tree for an arch (the reference's layout)
- :func:`loss_fn`            — full train loss (chunked cross-entropy + MoE aux)
- :func:`build_prefill_step` / :func:`build_decode_step` / :func:`decode_cache`
- paged serving: :func:`decode_cache_paged`, :func:`paged_cache_flags`,
  :func:`paged_support`, :func:`build_prefill_past_step` (suffix-only
  prefill against a cached prefix), :func:`build_decode_step_paged`
- :func:`full_forward_logits` — train-path logits, the oracle decode is held to
- :func:`count_params`       — analytic N
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import ctx as dctx
from repro_torch.models import common as cm
from repro_torch.models.transformer import (_PAGED_MIXER_LEAVES, LayerDef, Stack,
                                            build_layer_defs)


def _decoder(cfg) -> Stack:
    return Stack(cfg)


def _encoder(cfg) -> Stack:
    defs = [LayerDef("attn", "dense")] * cfg.encoder_layers
    return Stack(cfg, bidirectional=True, defs=defs)


def model_specs(cfg) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    s = {
        "embed": cm.ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              dt, "small"),
        "decoder": _decoder(cfg).specs(),
        "final_norm": cm.norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = cm.ParamSpec((cfg.d_model, cfg.vocab_size),
                                    ("embed", "vocab"), dt)
    if cfg.family == "encdec":
        s["encoder"] = _encoder(cfg).specs()
        s["enc_norm"] = cm.norm_spec(cfg, cfg.d_model)
    return s


def count_params(cfg, active_only: bool = False, include_embed: bool = True) -> int:
    """Analytic N, by the reference's rules: ``include_embed=False`` leaves
    out every leaf with a vocabulary axis; ``active_only`` counts an expert
    leaf at ``top_k / num_experts``."""
    total = 0
    m = cfg.moe
    for _, spec in cm.tree_leaves(model_specs(cfg)):
        n = math.prod(spec.shape)
        if not include_embed and "vocab" in spec.axes:
            continue
        if active_only and m is not None and "expert" in spec.axes:
            n = int(n * m.top_k / m.num_experts)
        total += n
    return total


def _sinusoid(positions, d_model: int, device=None):
    """Whisper-style sinusoidal position embedding; positions: (S,) or scalar."""
    pos = torch.atleast_1d(torch.as_tensor(positions, device=device)).float()
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=pos.device)
                     / max(half - 1, 1))
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_tokens(cfg, params, tokens):
    x = dctx.gathered(params["embed"])[tokens]
    return dctx.constrain(x.to(cfg.dtype), ("batch", "act_seq", None))


def _logit_kernel(cfg, params):
    if cfg.tie_embeddings:
        return dctx.gathered(params["embed"]).T
    return dctx.gathered(params["unembed"])


def _encode(cfg, params, frames, dtype):
    """Bidirectional encoder over frame embeddings -> normalized context."""
    enc_x = frames.to(dtype)
    enc_pos = torch.arange(enc_x.shape[1], device=enc_x.device)
    enc_x = enc_x + _sinusoid(enc_pos, cfg.d_model).to(dtype)
    ctx, _ = _encoder(cfg).train(params["encoder"], enc_x, enc_pos)
    return cm.apply_norm(cfg, params["enc_norm"], ctx)


def _context(cfg, params, batch, x, positions):
    """-> (decoder input, cross-attention context or None)."""
    if cfg.family == "encdec":
        ctx = _encode(cfg, params, batch["frames"], x.dtype)
        return x + _sinusoid(positions, cfg.d_model).to(x.dtype), ctx
    if cfg.family == "vision":
        # the vision frontend is a stub: the batch carries the patch embeddings
        return x, batch["image_embeds"].to(x.dtype)
    return x, None


def _logits(cfg, params, feats):
    feats = cm.apply_norm(cfg, params["final_norm"], feats)
    return (feats @ _logit_kernel(cfg, params)).float()


def _xent_block(fb, kernel, lb):
    logits = (fb @ kernel).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(cfg, features, kernel, labels):
    """Mean cross-entropy without materializing (B,S,V) logits.

    features: (B,S,d); kernel: (d,V); labels: (B,S) int.  Loops over
    sequence chunks of cfg.xent_chunk; under autograd each chunk's logits are
    recomputed in backward (the reference's ``jax.checkpoint(body)``).  The
    reference's optional ``mask`` has no caller and is left out.
    """
    S = features.shape[1]
    C = cfg.xent_chunk if S % cfg.xent_chunk == 0 else S
    tot = torch.zeros((), dtype=torch.float32, device=features.device)
    # split, not slicing: one concatenation of the chunks' feature grads in
    # backward instead of a full-size zero-padded grad per chunk
    for fb, lb in zip(features.split(C, dim=1), labels.long().split(C, dim=1)):
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_xent_block, fb, kernel, lb, use_reentrant=False)
        else:
            tot = tot + _xent_block(fb, kernel, lb)
    return tot / max(labels.numel(), 1)


AUX_WEIGHT = 0.01


def loss_fn(cfg, params, batch):
    """batch: {tokens, labels[, frames][, image_embeds]} → (loss, metrics):
    the cross-entropy plus ``AUX_WEIGHT`` times the MoE load-balance loss.
    Under a sharding context each rank takes its shard of the (global)
    batch and the loss is the mean over every rank's tokens."""
    batch = dctx.local_batch(batch)
    tokens = batch["tokens"]
    positions = dctx.positions(tokens)
    x = _embed_tokens(cfg, params, tokens)
    x, ctx = _context(cfg, params, batch, x, positions)
    feats, aux = _decoder(cfg).train(params["decoder"], x, positions, ctx)
    feats = cm.apply_norm(cfg, params["final_norm"], feats)
    xent = chunked_xent(cfg, feats, _logit_kernel(cfg, params), batch["labels"])
    xent = dctx.token_mean(xent, batch["labels"].numel())
    loss = xent + AUX_WEIGHT * aux
    return loss, {"xent": xent, "moe_aux": aux}


def full_forward_logits(cfg, params, batch):
    """Train-path forward returning (B, S, V) logits (for tests: small V;
    under a sharding context, this rank's rows of them)."""
    batch = dctx.local_batch(batch)
    tokens = batch["tokens"]
    positions = dctx.positions(tokens)
    x = _embed_tokens(cfg, params, tokens)
    x, ctx = _context(cfg, params, batch, x, positions)
    feats, _ = _decoder(cfg).train(params["decoder"], x, positions, ctx)
    return _logits(cfg, params, feats)


# ---------------------------------------------------------------------------
# serving


def build_prefill_step(cfg):
    dec = _decoder(cfg)

    def prefill_step(params, batch):
        """Under a sharding context: this rank's shard of the cache and its
        batch rows' logits."""
        batch = dctx.local_batch(batch)
        tokens = batch["tokens"]
        positions = dctx.positions(tokens)
        x = _embed_tokens(cfg, params, tokens)
        x, ctx = _context(cfg, params, batch, x, positions)
        feats, cache = dec.prefill(params["decoder"], x, positions, ctx)
        if dctx.current() is not None:          # the last row is the last rank's
            feats = dctx.gather(feats[:, -1:], dctx.layout().s_axes, 1)
        return cache, _logits(cfg, params, feats[:, -1:])[:, 0]

    return prefill_step


def build_decode_step(cfg):
    dec = _decoder(cfg)

    def decode_step(params, cache, token, pos):
        """token: (B,1) int; pos: scalar or (B,) int — absolute position(s)
        of ``token`` (a (B,) vector puts each row on its own timeline).
        ``cache`` is updated in place and returned."""
        x = _embed_tokens(cfg, params, token)
        if cfg.family == "encdec":
            pos_t = torch.as_tensor(pos, device=x.device)
            pe = _sinusoid(pos_t, cfg.d_model).to(x.dtype)
            x = x + (pe[:, None] if pos_t.ndim == 1 else pe[None])
        feats, cache = dec.decode(params["decoder"], x, cache, pos)
        return cache, _logits(cfg, params, feats)[:, 0]

    return decode_step


def decode_cache(cfg, batch: int, seq_len: int, device=None):
    return _decoder(cfg).cache(batch, seq_len, cm.resolve_device(device))


# ---------------------------------------------------------------------------
# paged serving (block-granular KV pool + prefix reuse)


def decode_cache_paged(cfg, batch: int, seq_len: int, pool_pages: int, page_size: int,
                       device=None):
    """Decode cache with attn and mla leaves in ``(pool_pages+1, page_size,
    ...)`` pool layout (row 0 = null page); resident leaves stay ``(batch, ...)``."""
    return _decoder(cfg).paged_cache(batch, seq_len, pool_pages, page_size,
                                     cm.resolve_device(device))


def paged_cache_flags(cfg):
    """Cache-structured bool tree marking pool-layout leaves."""
    return _decoder(cfg).paged_flags()


def paged_support(cfg):
    """-> (any_paged, prefix_ok): whether the arch has pageable cache leaves
    at all, and whether prefix-cache reuse is sound for it (every mixer
    pageable, no cross-attention, no encoder/image context)."""
    defs = build_layer_defs(cfg)
    any_paged = any(d.mixer in _PAGED_MIXER_LEAVES for d in defs)
    prefix_ok = (cfg.family not in ("encdec", "vision")
                 and all(d.mixer in _PAGED_MIXER_LEAVES and not d.cross for d in defs))
    return any_paged, prefix_ok


def _past_seq_len(past) -> int:
    """Prefix length from a past tree's leaf shapes."""
    for path, leaf in cm.tree_leaves(past):
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            return int(leaf.shape[-3])
        if name in ("c_kv", "k_rope"):
            return int(leaf.shape[-2])
    raise ValueError("past tree has no recognizable KV leaf")


def build_prefill_past_step(cfg):
    """Suffix-only prefill against an already-cached prefix.

    ``past`` is a cache-structured tree of the prefix's K/V at batch 1; its
    leaf shapes carry the prefix length.  Only archs for which
    :func:`paged_support` reports ``prefix_ok`` may use this.
    """
    dec = _decoder(cfg)

    def prefill_past_step(params, batch, past):
        tokens = batch["tokens"]
        past_len = _past_seq_len(past)
        positions = past_len + torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_tokens(cfg, params, tokens)
        feats, cache = dec.prefill(params["decoder"], x, positions, None,
                                   past=past, past_len=past_len)
        return cache, _logits(cfg, params, feats[:, -1:])[:, 0]

    return prefill_past_step


def build_decode_step_paged(cfg, page_size: int):
    dec = _decoder(cfg)

    def decode_step(params, cache, token, pos, tables):
        """token: (B,1) int; pos: (B,) absolute positions; tables: (B, width)
        page ids (0 = unallocated / null).  The pool is written in place."""
        x = _embed_tokens(cfg, params, token)
        if cfg.family == "encdec":
            pe = _sinusoid(pos, cfg.d_model, device=x.device).to(x.dtype)
            x = x + pe[:, None]
        feats, cache = dec.decode(params["decoder"], x, cache, pos,
                                  tables=tables, page_size=page_size)
        return cache, _logits(cfg, params, feats)[:, 0]

    return decode_step
