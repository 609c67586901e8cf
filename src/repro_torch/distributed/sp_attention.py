"""Sequence-parallel attention with explicit collectives — PyTorch port of
``repro/distributed/sp_attention.py``.

With sequence-parallel activations the model-axis decomposition of the
attention core is made explicit, as the reference's ``shard_map`` makes it.
Two variants, chosen per (arch × mesh) by the same rules:

- **heads-sharded** (preferred; H divisible by the tensor axis and each
  rank's head range inside one GQA group, or K sharded with the q heads):
  every rank computes its own heads over the full sequence; no collective
  inside the body.
- **seq-sharded** (fallback; e.g. qwen's 40 heads over a 16-way axis):
  every rank owns a contiguous block of query rows and all-gathers K/V;
  the all-gather's backward is a reduce-scatter of dK/dV.

Both bodies call ``chunked_attention`` without ``cfg``, as the reference's
do, so the flash kernel does not run inside them.

The port's inputs are local shards in the residual layout
(``ctx.layout()``: batch rows over the batch axes, sequence rows over
``act_seq``'s where those resolve), where the reference's are global arrays
that ``shard_map`` slices by its ``in_specs``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import ctx as dctx


def _heads_block(t, r: int, n: int):
    """Heads block ``r`` of ``n`` along dim 2."""
    size = t.shape[2] // n
    return t[:, :, r * size:(r + 1) * size]


def sp_attention(q, k, v, *, causal: bool, window: Optional[int],
                 chunk: int, wo=None, v_head: Optional[int] = None):
    """Drop-in replacement for chunked_attention under a sharding context.

    q: (B, S, H, hd); k, v: (B, S, K, hd), each this rank's shard in the
    residual layout.  Returns ``(out, fused)``: with ``wo`` (H, hd_o, d)
    and a sequence-sharded layout, the fused residual output (B, S, d)
    reduce-scattered back to the residual layout (``fused`` True); else the
    attention output — the rank's heads over the whole sequence under the
    heads variant, the rank's rows under the sequence variant.  None if no
    decomposition applies (the caller falls back).
    """
    c = dctx.current()
    if c is None:
        return None
    from repro_torch.models.attention import chunked_attention

    mesh, recipe = c
    lay = dctx.layout()
    B, S = lay.batch, lay.seq
    H, K = q.shape[2], k.shape[2]
    G = H // K

    used: set = set()
    recipe.resolve("batch", mesh, used, B)
    h_axes = recipe.resolve("heads", mesh, set(used), H)
    tp_h = dctx.axis_size(h_axes)
    s_axes = recipe.resolve("act_seq", mesh, set(used), S)
    tp_s = dctx.axis_size(s_axes)

    # -- variant 1: heads sharded, sequence gathered --------------------------
    kv_sharded = K % tp_h == 0
    if tp_h > 1 and (kv_sharded or ((H // tp_h) <= G and G % (H // tp_h) == 0)):
        r = dctx.axis_index(h_axes)

        def whole_seq(t):
            # the rank's rows -> every row (backward: a reduce-scatter); a
            # layout without sequence sharding holds every row on each rank
            # of the heads axes, whose heads blocks then sum in backward
            if s_axes is not None:
                return dctx.gather(t, s_axes, 1)
            return dctx.sum_grad(t, h_axes)

        ql = _heads_block(whole_seq(q), r, tp_h)
        kg, vg = whole_seq(k), whole_seq(v)
        if kv_sharded:
            kg, vg = _heads_block(kg, r, tp_h), _heads_block(vg, r, tp_h)
        else:
            group = (r * ql.shape[2]) // G           # single group per rank
            kg, vg = kg[:, :, group:group + 1], vg[:, :, group:group + 1]
        o = chunked_attention(ql, kg, vg, causal=causal, window=window, chunk=chunk)
        fused = wo is not None and s_axes is not None and S % tp_s == 0
        if not fused:
            return o, False
        # fused out-projection: partial contraction over the local heads,
        # then reduce-scatter the sequence back to the SP layout
        if v_head is not None:
            o = o[..., :v_head]
        wo_l = dctx.param(wo, {0: h_axes})
        y_part = torch.einsum("bshk,hkd->bsd", o, wo_l).to(o.dtype)
        return dctx.scatter_sum(y_part, s_axes, 1), True

    # -- variant 2: sequence sharded, K/V gathered inside ----------------------
    if tp_s > 1 and S % tp_s == 0:
        s_loc = S // tp_s
        kg = dctx.gather(k, s_axes, 1)
        vg = dctx.gather(v, s_axes, 1)
        r = dctx.axis_index(s_axes)
        out = chunked_attention(q, kg, vg, causal=causal, window=window,
                                chunk=min(chunk, s_loc), q_offset=r * s_loc)
        return out, False

    return None


def _h_axes(H: int):
    """The mesh axes the heads variant shards ``H`` heads over."""
    mesh, recipe = dctx.current()
    used: set = set()
    recipe.resolve("batch", mesh, used, dctx.layout().batch)
    return recipe.resolve("heads", mesh, used, H)


def maybe_sp_attention(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None, chunk: int = 512):
    """sp_attention if a profitable decomposition exists, else the plain
    chunked path.  Returns the (B, S, H, hd) attention output (unfused), in
    the residual layout."""
    out = sp_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    if out is not None:
        o, fused = out
        assert not fused
        if o.shape[2] != q.shape[2]:
            # heads variant -> the residual layout: every head, the rank's
            # rows (the ranks' uses of the gathered heads then differ)
            s_axes = dctx.layout().s_axes
            o = dctx.gather(o, _h_axes(q.shape[2]), 2, partial_grad=s_axes is not None)
            return dctx.local_slice(o, 1, s_axes)
        return o
    from repro_torch.models.attention import chunked_attention

    return chunked_attention(q, k, v, causal=causal, window=window, chunk=chunk)


def maybe_sp_attention_fused(q, k, v, wo, *, causal: bool = True,
                             window: Optional[int] = None, chunk: int = 512,
                             v_head: Optional[int] = None):
    """Attention + fused output projection.  Returns (B, S, d) in the
    residual layout, or None."""
    out = sp_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                       wo=wo, v_head=v_head)
    if out is None:
        return None
    o, fused = out
    if fused:
        return o
    # decomposition found but fusion not applicable: finish outside
    if v_head is not None:
        o = o[..., :v_head]
    if o.shape[2] == q.shape[2]:                    # sequence variant: rows
        return dctx.constrain_residual(
            torch.einsum("bshk,hkd->bsd", o, dctx.param(wo)).to(o.dtype))
    # heads variant on a layout without sequence sharding: every rank of the
    # heads axes sums its heads' partial projection
    h_axes = _h_axes(q.shape[2])
    y_part = torch.einsum("bshk,hkd->bsd", o, dctx.param(wo, {0: h_axes})).to(o.dtype)
    return dctx.all_sum(y_part, h_axes)
