"""Whole-block sequence-parallel attention with explicit collectives —
PyTorch port of ``repro/distributed/sp_block.py``.

The entire GQA block runs on the rank's shards, with one activation gather
and one activation scatter per layer:

    xg   = all_gather(x, seq_ax)                 [dual: reduce_scatter dx]
    w*   = all_gather(w, fsdp_ax)                [dual: ZeRO-3 grad RS]
    q/k/v, RoPE, blocked attention  — all local to the rank's heads
    y    = reduce_scatter(o @ wo, seq_ax)        [dual: all_gather dy]

Weight gradients never leave their shard layout.  With ``with_cache`` it
also returns the rank's sequence slice of K/V, so prefill caches stay
sequence-sharded.  ``sp_mla_block`` (DeepSeek-V2's MLA under the same
scheme) is ROADMAP A9.2: an ``mla`` layer under a context raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import ctx as dctx
from repro_torch.distributed.sharding import axes_tuple
from repro_torch.models import common as cm


def _env(x_shape, h, k):
    c = dctx.current()
    if c is None:
        return None
    mesh, recipe = c
    B, S, d = x_shape
    used: set = set()
    b_axes = recipe.resolve("batch", mesh, used, B)
    s_ax = recipe.resolve("act_seq", mesh, set(used), S)
    h_axes = recipe.resolve("heads", mesh, set(used), h)
    if not isinstance(s_ax, str) or h_axes is None or S % dctx.axis_size(s_ax):
        return None
    tp = dctx.axis_size(s_ax)
    if h % tp:
        return None
    wq_used = set(axes_tuple(h_axes))
    fsdp = recipe.resolve("embed", mesh, wq_used, d)
    kv_sharded = k % tp == 0
    G = h // k
    if not kv_sharded and not ((h // tp) <= G and G % (h // tp) == 0):
        return None
    return mesh, recipe, b_axes, s_ax, h_axes, fsdp, tp, kv_sharded


def sp_gqa_block(cfg, p: dict, x, positions, *, causal: bool,
                 window: Optional[int], with_cache: bool):
    """The full GQA block on the rank's shards.  ``x`` is the rank's shard
    in the residual layout and ``positions`` the whole sequence's.  Returns
    (y, cache or None) or None."""
    if dctx.current() is None:
        return None
    lay = dctx.layout()
    env = _env((lay.batch, lay.seq, x.shape[2]), cfg.num_heads, cfg.num_kv_heads)
    if env is None or cfg.family == "encdec":
        return None
    mesh, recipe, b_axes, s_ax, h_axes, fsdp, tp, kv_sharded = env
    from repro_torch.models.attention import chunked_attention

    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    kv_keep = {1: h_axes} if kv_sharded else {}
    xg = dctx.gather(x, s_ax, 1)                                # (B_loc, S, d)
    q = torch.einsum("bsd,dhk->bshk", xg, dctx.param(p["wq"], {1: h_axes}))
    kk = torch.einsum("btd,dgk->btgk", xg, dctx.param(p["wk"], kv_keep))
    vv = torch.einsum("btd,dgk->btgk", xg, dctx.param(p["wv"], kv_keep))
    if "bq" in p:
        q = q + dctx.param(p["bq"], {0: h_axes}).to(q.dtype)
        kk = kk + dctx.param(p["bk"], {0: h_axes} if kv_sharded else {}).to(kk.dtype)
        vv = vv + dctx.param(p["bv"], {0: h_axes} if kv_sharded else {}).to(vv.dtype)
    q = cm.rope(q, positions, cfg.rope_theta)
    kk_r = cm.rope(kk, positions, cfg.rope_theta)
    if kv_sharded:
        kg, vg = kk_r, vv
    else:
        group = (dctx.axis_index(h_axes) * (H // tp)) // G
        kg, vg = kk_r[:, :, group:group + 1], vv[:, :, group:group + 1]
    o = chunked_attention(q, kg, vg, causal=causal, window=window, chunk=cfg.attn_chunk)
    y_part = torch.einsum("bshk,hkd->bsd", o, dctx.param(p["wo"], {0: h_axes})).to(x.dtype)
    y = dctx.scatter_sum(y_part, s_ax, 1)
    if not with_cache:
        return y, None
    # the rank's sequence slice of every head's K/V.  Head-sharded K/V are
    # gathered whole before the slice: the reference gathers the heads of
    # each rank's own slice, and ranks of the heads axis hold different
    # sequence slices, so its heads blocks would come from other rows
    if kv_sharded:
        kk_r, vv = dctx.gather(kk_r, h_axes, 2), dctx.gather(vv, h_axes, 2)
    return y, {"k": dctx.local_slice(kk_r, 1, s_ax), "v": dctx.local_slice(vv, 1, s_ax)}
