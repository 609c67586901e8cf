"""Grouped-query attention with chunked (query-blocked) softmax — PyTorch port
of ``repro/models/attention.py``.

Scores are materialized for one query block at a time, ``(B, chunk, H, T)``.
The plain path is the oracle for the hand-written flash kernel
(``repro_torch.kernels.flash_attention``), which ``chunked_attention`` takes
under the reference's gate when ``cfg.use_pallas`` is set.

Under a sharding context (``repro_torch.distributed``) ``self_attention``
and ``prefill_attention`` take the explicit-collective blocks where the
reference's do (``sp_gqa_block``, then ``sp_attention``), and every other
path works on this rank's shards with whole weights
(``distributed.ctx.gathered``); outside one those hooks are identities.
Cache updates are in place: the caller's cache tensors (or page pool) are
written, and returned.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import ctx as dctx
from repro_torch.models import common as cm

NEG_INF = -1e30


def attn_specs(cfg, *, bias: Optional[bool] = None, cross: bool = False) -> dict:
    """Param specs for one (cross-)attention layer."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cross:
        k = h  # cross-attn layers use full MHA over image/encoder tokens
    dt = torch_dtype(cfg.param_dtype)
    use_bias = cfg.qkv_bias if bias is None else bias
    s = {
        "wq": cm.ParamSpec((d, h, hd), ("embed", "heads", None), dt),
        "wk": cm.ParamSpec((d, k, hd), ("embed", "kv_heads", None), dt),
        "wv": cm.ParamSpec((d, k, hd), ("embed", "kv_heads", None), dt),
        "wo": cm.ParamSpec((h, hd, d), ("heads", None, "embed"), dt),
    }
    if use_bias:
        s["bq"] = cm.ParamSpec((h, hd), ("heads", None), torch.float32, "zeros")
        s["bk"] = cm.ParamSpec((k, hd), ("kv_heads", None), torch.float32, "zeros")
        s["bv"] = cm.ParamSpec((k, hd), ("kv_heads", None), torch.float32, "zeros")
    return s


def project_qkv(p: dict, x, xkv=None, sp_constrain: bool = False):
    """(B,S,d) -> q (B,S,H,hd), k/v (B,T,K,hd)."""
    g = dctx.gathered
    xkv = x if xkv is None else xkv
    q = torch.einsum("bsd,dhk->bshk", x, g(p["wq"]))
    k = torch.einsum("btd,dgk->btgk", xkv, g(p["wk"]))
    v = torch.einsum("btd,dgk->btgk", xkv, g(p["wv"]))
    if "bq" in p:
        q = q + g(p["bq"]).to(q.dtype)
        k = k + g(p["bk"]).to(k.dtype)
        v = v + g(p["bv"]).to(v.dtype)
    if sp_constrain:
        q, k, v = dctx.constrain_qkv(q), dctx.constrain_qkv(k), dctx.constrain_qkv(v)
    return q, k, v


def out_proj(p: dict, o):
    y = torch.einsum("bshk,hkd->bsd", o, dctx.gathered(p["wo"]))
    return dctx.constrain_residual(y.to(o.dtype))


def _block_attend(q_blk, k, v, row_pos, col_pos, *, causal, window, kv_valid):
    """Attention for one query block against the full key range.

    q_blk: (B, C, K, G, hd); k/v: (B, T, K, hd); row_pos: (C,) / (B, C) and
    col_pos: (T,) / (B, T) absolute positions (2-D when each batch row sits
    on its own timeline); kv_valid: (T,) / (B, T) bool or None.
    Returns (B, C, K, G, hd).
    """
    hd = q_blk.shape[-1]
    scores = torch.einsum("bckgh,btkh->bckgt", q_blk, k).float()
    scores = scores / math.sqrt(hd)
    row = row_pos if row_pos.ndim == 2 else row_pos[None]          # (Bm, C)
    col = col_pos if col_pos.ndim == 2 else col_pos[None]          # (Bm, T)
    mask = torch.ones((max(row.shape[0], col.shape[0]), row.shape[1], col.shape[1]),
                      dtype=torch.bool, device=q_blk.device)       # (Bm, C, T)
    if causal:
        mask &= col[:, None, :] <= row[:, :, None]
    if window is not None:
        mask &= col[:, None, :] > (row[:, :, None] - window)
    if kv_valid is not None:
        kvv = kv_valid if kv_valid.ndim == 2 else kv_valid[None]
        mask &= kvv[:, None, :]
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q_blk.dtype)
    return torch.einsum("bckgt,btkh->bckgh", probs, v)


def pallas_attention(cfg, q, k, v, *, causal: bool):
    """Route through the hand-written flash kernel (the reference's name for
    this hook).  Only sound for from-scratch causal/bidirectional attention
    without windows/offsets — callers gate on that."""
    from repro_torch.kernels.flash_attention.ops import mha

    return mha(q, k, v, causal=causal)


def chunked_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      chunk: int = 1024, q_offset: int = 0,
                      kv_valid=None, cfg=None):
    """GQA attention over query blocks of size ``chunk``.

    q: (B, S, H, hd); k, v: (B, T, K, hd) with H = K*G.  ``q_offset`` places
    the queries inside the KV timeline.  Exact — block size only bounds the
    live score buffer.  With ``cfg.use_pallas`` and a kernel-compatible call
    the flash kernel takes over.
    """
    if (cfg is not None and cfg.use_pallas and window is None
            and q_offset == 0 and kv_valid is None
            and q.shape[1] == k.shape[1]):
        return pallas_attention(cfg, q, k, v, causal=causal)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    col_pos = torch.arange(T, dtype=torch.int64, device=q.device)
    attend = functools.partial(_block_attend, causal=causal, window=window,
                               kv_valid=kv_valid)
    if torch.is_grad_enabled() and S > chunk:
        # flash-style recompute, as the reference's jax.checkpoint over its
        # blocks: without it autograd keeps every block's scores and softmax
        # for backward — more than the full (B,S,H,T) attention matrix
        attend = functools.partial(checkpoint, attend, use_reentrant=False)
    outs = []
    for s0 in range(0, S, chunk):
        row_pos = q_offset + torch.arange(s0, min(S, s0 + chunk), dtype=torch.int64,
                                          device=q.device)
        outs.append(attend(qg[:, s0:s0 + chunk], k, v, row_pos, col_pos))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.reshape(B, S, H, hd)


def self_attention(cfg, p: dict, x, positions, *, causal=True,
                   window: Optional[int] = None):
    """Full-sequence self-attention (train / encoder)."""
    from repro_torch.distributed.sp_attention import maybe_sp_attention_fused
    from repro_torch.distributed.sp_block import sp_gqa_block

    blk = sp_gqa_block(cfg, p, x, positions, causal=causal, window=window,
                       with_cache=False)
    if blk is not None:
        return blk[0]
    q, k, v = project_qkv(p, x, sp_constrain=True)
    if cfg.family != "encdec":  # whisper uses absolute pos-emb, not RoPE
        rows = dctx.local_rows(positions, x.shape[1])
        q = cm.rope(q, rows, cfg.rope_theta)
        k = cm.rope(k, rows, cfg.rope_theta)
    y = maybe_sp_attention_fused(q, k, v, p["wo"], causal=causal,
                                 window=window, chunk=cfg.attn_chunk)
    if y is not None:
        return y
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          chunk=cfg.attn_chunk, cfg=cfg)
    return out_proj(p, o)


def prefill_attention(cfg, p: dict, x, positions, *, window: Optional[int] = None,
                      past: Optional[dict] = None, past_len: int = 0):
    """Causal self-attention that also returns the KV cache (its latest
    ``window`` positions for a local layer).  As in the reference, no
    ``cfg`` reaches ``chunked_attention`` here, so prefill never takes the
    kernel.

    With ``past`` (k/v of an already-cached prefix, (B, past_len, K, hd)),
    only the suffix is computed: queries at ``positions`` (absolute, i.e.
    ``past_len + arange(S)``) attend over concat(past, suffix), and the
    returned cache covers the suffix only — the prefix's pages already hold
    its K/V."""
    from repro_torch.distributed.sp_attention import maybe_sp_attention_fused
    from repro_torch.distributed.sp_block import sp_gqa_block

    if past is None:
        blk = sp_gqa_block(cfg, p, x, positions, causal=True, window=window,
                           with_cache=True)
        if blk is not None:
            y, cache = blk
            if window is not None and cache["k"].shape[1] > window:
                cache = {"k": cache["k"][:, -window:], "v": cache["v"][:, -window:]}
            return y, cache
    q, k, v = project_qkv(p, x, sp_constrain=True)
    if cfg.family != "encdec":
        rows = dctx.local_rows(positions, x.shape[1])
        q = cm.rope(q, rows, cfg.rope_theta)
        k = cm.rope(k, rows, cfg.rope_theta)
    if past is not None:
        k_all = torch.cat([past["k"].to(k.dtype), k], dim=1)
        v_all = torch.cat([past["v"].to(v.dtype), v], dim=1)
        o = chunked_attention(q, k_all, v_all, causal=True, window=window,
                              chunk=cfg.attn_chunk, q_offset=past_len)
        return out_proj(p, o), {"k": k, "v": v}
    y = maybe_sp_attention_fused(q, k, v, p["wo"], causal=True,
                                 window=window, chunk=cfg.attn_chunk)
    if y is None:
        o = chunked_attention(q, k, v, causal=True, window=window, chunk=cfg.attn_chunk)
        y = out_proj(p, o)
    if window is not None and k.shape[1] > window:
        k, v = k[:, -window:], v[:, -window:]
    return y, {"k": k, "v": v}


def decode_attention(cfg, p: dict, x, cache: dict, pos, *,
                     window: Optional[int] = None):
    """One-token decode against a (B, T, K, hd) cache, written in place.

    Global attention: the cache holds T = max_seq slots and slot ``pos`` is
    written.  Local attention: the cache is a ring buffer of ``window``
    slots.  ``pos`` is a scalar (the whole batch at one position) or a (B,)
    tensor (continuous batching: each row on its own timeline).
    """
    q, k_new, v_new = project_qkv(p, x)           # (B, 1, ., .)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_row = pos.ndim == 1
    posv = pos[:, None] if per_row else pos.reshape(1)
    if cfg.family != "encdec":
        q = cm.rope(q, posv, cfg.rope_theta)
        k_new = cm.rope(k_new, posv, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    T = k_cache.shape[1]
    slot = pos % T if window is not None else pos
    if per_row:
        b = torch.arange(q.shape[0], device=x.device)
        k_cache[b, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[b, slot] = v_new[:, 0].to(v_cache.dtype)
    else:
        k_cache.index_copy_(1, slot.reshape(1), k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, slot.reshape(1), v_new.to(v_cache.dtype))
    idx = torch.arange(T, dtype=torch.int64, device=x.device)
    if window is None:
        col_pos = idx
        kv_valid = (idx[None, :] <= pos[:, None]) if per_row else (idx <= pos)
    else:
        # ring buffer: slot i holds absolute position p with p % T == i, the
        # largest such p <= pos
        prow = pos[:, None] if per_row else pos
        col_pos = prow - torch.remainder(prow - idx, T)    # (B, T) or (T,)
        kv_valid = col_pos >= 0
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, 1, K, H // K, hd)
    o = _block_attend(qg, k_cache, v_cache, posv, col_pos, causal=True,
                      window=window, kv_valid=kv_valid)
    o = o.reshape(B, 1, H, hd)
    return out_proj(p, o), {"k": k_cache, "v": v_cache}


def write_pool_rows(pool, pid, off, values) -> None:
    """``pool[pid[b], off[b]] = values[b]`` for every batch row b, in place.
    Rows that share a slot — dead rows all write the null page — write the
    value of the last of them, as a scatter that runs the rows in order
    would, so the slot holds the same bits whatever order the card runs the
    writes in.  Under MoE capacity the dead rows' null-page reads reach the
    live rows' routing, so that order would otherwise show in their
    tokens."""
    same = (pid[:, None] == pid[None, :]) & (off[:, None] == off[None, :])
    rows = torch.arange(pid.shape[0], device=pid.device)
    last = torch.where(same, rows[None, :], -1).amax(1)
    pool[pid, off] = values[last].to(pool.dtype)


def paged_decode_attention(cfg, p: dict, x, cache: dict, pos, tables, *,
                           page_size: int):
    """One-token decode against a block-granular paged KV pool.

    cache k/v: (num_pages+1, page_size, K, hd) — row 0 is the null page that
    dead batch rows write into and no one reads.  tables: (B, width) page
    ids (0 where unallocated); pos: (B,) per-row absolute positions.  The
    engine guarantees that every position <= pos[b] is backed by a real
    page in row b's table and that the write page (block ``pos //
    page_size``) is private to row b: shared prefix pages are never
    written.  The new k/v are written into the pool in place (a view of a
    stacked pool writes the stacked storage); the gather through the table
    copies.
    """
    q, k_new, v_new = project_qkv(p, x)           # (B, 1, ., .)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    posv = pos[:, None]
    if cfg.family != "encdec":
        q = cm.rope(q, posv, cfg.rope_theta)
        k_new = cm.rope(k_new, posv, cfg.rope_theta)
    k_pool, v_pool = cache["k"], cache["v"]
    B = q.shape[0]
    b = torch.arange(B, device=x.device)
    pid = tables[b, pos // page_size]             # (B,) write page per row
    off = pos % page_size
    write_pool_rows(k_pool, pid, off, k_new[:, 0])
    write_pool_rows(v_pool, pid, off, v_new[:, 0])
    K, hd = k_pool.shape[-2], k_pool.shape[-1]
    T = tables.shape[1] * page_size
    k = k_pool[tables].reshape(B, T, K, hd)       # gather through the table
    v = v_pool[tables].reshape(B, T, K, hd)
    idx = torch.arange(T, dtype=torch.int64, device=x.device)
    kv_valid = idx[None, :] <= posv
    H = q.shape[2]
    qg = q.reshape(B, 1, K, H // K, hd)
    o = _block_attend(qg, k, v, posv, idx, causal=True, window=None,
                      kv_valid=kv_valid)
    o = o.reshape(B, 1, H, hd)
    return out_proj(p, o), {"k": k_pool, "v": v_pool}


def cross_attention(cfg, p: dict, x, kv_cache: dict):
    """Cross-attention against precomputed encoder/image K,V (full MHA)."""
    q = torch.einsum("bsd,dhk->bshk", x, dctx.gathered(p["wq"]))
    if "bq" in p:
        q = q + dctx.gathered(p["bq"]).to(q.dtype)
    o = chunked_attention(q, kv_cache["k"], kv_cache["v"], causal=False,
                          chunk=cfg.attn_chunk)
    return out_proj(p, o)


def cross_kv(p: dict, ctx):
    """Precompute cross-attention K,V from encoder/image embeddings."""
    p = dctx.gathered({name: p[name] for name in ("wk", "wv", "bk", "bv") if name in p})
    k = torch.einsum("btd,dgk->btgk", ctx, p["wk"])
    v = torch.einsum("btd,dgk->btgk", ctx, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return {"k": k, "v": v}
