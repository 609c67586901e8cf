"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434) — PyTorch port
of ``repro/models/mla.py`` on one device.

Two execution paths:

- **train/prefill** — *decompressed*: up-project the latent to per-head
  K_nope/V and run the plain ``chunked_attention`` over head_dim =
  qk_nope + qk_rope.  As in the reference, no ``cfg`` reaches it, so MLA
  never takes the flash kernel.
- **decode** — *absorbed*: the cache holds only the latent ``c_kv`` (B, T,
  kv_lora) and the shared rope key (B, T, rope); W_uk is absorbed into the
  query and W_uv into the output, so no per-head K/V is ever formed.  The
  paged variant keeps both leaves in a page pool read through per-row page
  tables.

Cache writes are in place, as in ``models/attention.py``.  The reference's
sequence-parallel blocks (``sp_mla_block``, ``maybe_sp_attention*``) are
ROADMAP A9.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.models import common as cm
from repro_torch.models.attention import NEG_INF, chunked_attention, write_pool_rows


def mla_specs(cfg) -> dict:
    a = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "w_dq": cm.ParamSpec((d, a.q_lora_rank), ("embed", "lora"), dt),
        "q_norm": cm.ParamSpec((a.q_lora_rank,), ("lora",), f32, "zeros"),
        "w_uq": cm.ParamSpec((a.q_lora_rank, h, a.qk_nope_head_dim + a.qk_rope_head_dim),
                             ("lora", "heads", None), dt),
        "w_dkv": cm.ParamSpec((d, a.kv_lora_rank + a.qk_rope_head_dim), ("embed", None), dt),
        "kv_norm": cm.ParamSpec((a.kv_lora_rank,), (None,), f32, "zeros"),
        "w_uk": cm.ParamSpec((a.kv_lora_rank, h, a.qk_nope_head_dim),
                             ("lora", "heads", None), dt),
        "w_uv": cm.ParamSpec((a.kv_lora_rank, h, a.v_head_dim), ("lora", "heads", None), dt),
        "wo": cm.ParamSpec((h, a.v_head_dim, d), ("heads", None, "embed"), dt),
    }


def _latent(cfg, p, x, positions):
    """Down-project to (c_kv, k_rope); rope applied to the shared rope key."""
    a = cfg.mla
    dkv = x @ p["w_dkv"]
    c_kv = cm.rmsnorm(dkv[..., :a.kv_lora_rank], p["kv_norm"])
    k_rope = cm.rope(dkv[..., a.kv_lora_rank:], positions, cfg.rope_theta)  # (B,T,rope)
    return c_kv, k_rope


def _queries(cfg, p, x, positions):
    a = cfg.mla
    q = cm.rmsnorm(x @ p["w_dq"], p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", q, p["w_uq"])
    q_nope, q_rope = q[..., :a.qk_nope_head_dim], q[..., a.qk_nope_head_dim:]
    return q_nope, cm.rope(q_rope, positions, cfg.rope_theta)


def _decompressed(cfg, p, x, q_nope, q_rope, c_kv, k_rope, q_offset: int = 0):
    """Per-head K/V from the latents, plain causal attention, output
    projection.  V is padded to the qk head dim for ``chunked_attention``'s
    one head dim and sliced after."""
    a = cfg.mla
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["w_uk"])
    v = torch.einsum("btr,rhk->bthk", c_kv, p["w_uv"])
    B, T = c_kv.shape[0], c_kv.shape[1]
    k_rope_h = k_rope[:, :, None, :].expand(B, T, cfg.num_heads, a.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    qk_hd, v_hd = q.shape[-1], v.shape[-1]
    if v_hd < qk_hd:
        v = F.pad(v, (0, qk_hd - v_hd))
    o = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk, q_offset=q_offset)
    o = o[..., :a.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]).to(x.dtype)


def mla_attention(cfg, p: dict, x, positions):
    """Train-path MLA (decompressed)."""
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = _latent(cfg, p, x, positions)
    return _decompressed(cfg, p, x, q_nope, q_rope, c_kv, k_rope)


def mla_prefill(cfg, p: dict, x, positions, *, past: Optional[dict] = None,
                past_len: int = 0):
    """Returns (out, {"c_kv", "k_rope"}).  With ``past`` (latents of an
    already-cached prefix), only the suffix is computed: suffix queries at
    absolute ``positions`` attend over concat(past, suffix) latents, and the
    returned cache covers the suffix only."""
    c_kv, k_rope = _latent(cfg, p, x, positions)
    q_nope, q_rope = _queries(cfg, p, x, positions)
    if past is None:
        return _decompressed(cfg, p, x, q_nope, q_rope, c_kv, k_rope), \
            {"c_kv": c_kv, "k_rope": k_rope}
    c_all = torch.cat([past["c_kv"].to(c_kv.dtype), c_kv], dim=1)
    kr_all = torch.cat([past["k_rope"].to(k_rope.dtype), k_rope], dim=1)
    out = _decompressed(cfg, p, x, q_nope, q_rope, c_all, kr_all, q_offset=past_len)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def _absorbed_read(cfg, p: dict, x_dtype, q_nope, q_rope, c_kv, k_rope, valid):
    """Absorbed-path scores and latent readout shared by the contiguous and
    paged decode.  valid: bool mask broadcastable to (B, 1, H, T)."""
    a = cfg.mla
    # absorb W_uk into q: (B,1,H,nope) x (r,H,nope) -> (B,1,H,r)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    scores = torch.einsum("bshr,btr->bsht", q_lat, c_kv).float()
    scores = scores + torch.einsum("bshk,btk->bsht", q_rope, k_rope).float()
    scores = scores / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x_dtype)
    o_lat = torch.einsum("bsht,btr->bshr", probs, c_kv)              # latent readout
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"])             # absorb W_uv
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]).to(x_dtype)


def mla_decode(cfg, p: dict, x, cache: dict, pos):
    """Absorbed decode against the contiguous latent cache, written in
    place.  ``pos`` is a scalar or a (B,) tensor of per-row absolute
    positions (continuous batching)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_row = pos.ndim == 1
    posv = pos[:, None] if per_row else pos.reshape(1)
    q_nope, q_rope = _queries(cfg, p, x, posv)                       # (B,1,H,.)
    c_new, kr_new = _latent(cfg, p, x, posv)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    if per_row:
        b = torch.arange(x.shape[0], device=x.device)
        c_kv[b, pos] = c_new[:, 0].to(c_kv.dtype)
        k_rope[b, pos] = kr_new[:, 0].to(k_rope.dtype)
    else:
        c_kv.index_copy_(1, pos.reshape(1), c_new.to(c_kv.dtype))
        k_rope.index_copy_(1, pos.reshape(1), kr_new.to(k_rope.dtype))
    idx = torch.arange(c_kv.shape[1], device=x.device)
    valid = (idx[None, :] <= pos[:, None])[:, None, None, :] if per_row else idx <= pos
    out = _absorbed_read(cfg, p, x.dtype, q_nope, q_rope, c_kv, k_rope, valid)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_paged_decode(cfg, p: dict, x, cache: dict, pos, tables, *, page_size: int):
    """Absorbed decode against a block-granular paged latent pool.

    cache c_kv: (num_pages+1, page_size, kv_lora); k_rope likewise — row 0
    is the null page.  tables: (B, width) page ids (0 where unallocated);
    pos: (B,) per-row absolute positions.  The engine's guarantees are
    ``paged_decode_attention``'s: every valid position is backed by a real
    page and the write page is private to its row.  The new latents are
    written into the pool in place; the gather through the table copies."""
    a = cfg.mla
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    posv = pos[:, None]
    q_nope, q_rope = _queries(cfg, p, x, posv)                       # (B,1,H,.)
    c_new, kr_new = _latent(cfg, p, x, posv)
    c_pool, kr_pool = cache["c_kv"], cache["k_rope"]
    B = x.shape[0]
    pid = tables[torch.arange(B, device=x.device), pos // page_size]
    off = pos % page_size
    write_pool_rows(c_pool, pid, off, c_new[:, 0])
    write_pool_rows(kr_pool, pid, off, kr_new[:, 0])
    T = tables.shape[1] * page_size
    c_kv = c_pool[tables].reshape(B, T, a.kv_lora_rank)
    k_rope = kr_pool[tables].reshape(B, T, a.qk_rope_head_dim)
    idx = torch.arange(T, device=x.device)
    valid = (idx[None, :] <= posv)[:, None, None, :]
    out = _absorbed_read(cfg, p, x.dtype, q_nope, q_rope, c_kv, k_rope, valid)
    return out, {"c_kv": c_pool, "k_rope": kr_pool}
