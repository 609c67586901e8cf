"""Explicit Megatron-SP + ZeRO-3 FFN — PyTorch port of
``repro/distributed/sp_ffn.py``.

The block's collectives are written out, with the exact duals in backward:

    forward                              backward
    x_full = all_gather(x, seq_ax)       dx = reduce_scatter(dx_full)
    w_full = all_gather(w, fsdp_ax)      dw = reduce_scatter(dw)  (ZeRO-3)
    h      = act(x_full @ w_gate) * ..   (local; weight grads local-sharded)
    y_part = h @ w_down                  dh local
    y      = reduce_scatter(y_part, seq) dy_full = all_gather(dy)

Nothing is all-reduced at full size; weight gradients never leave their
shard layout.  ``x`` is this rank's shard in the residual layout; each
weight arrives as its DTensor and the block keeps its ``mlp`` dimension
sharded, as the reference's ``in_specs`` do.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx as dctx
from repro_torch.models import common as cm


def sp_ffn(cfg, p: dict, x):
    """Explicit-collective FFN.  Returns None if inapplicable (the caller
    falls back to the plain path)."""
    c = dctx.current()
    if c is None or x.ndim != 3:
        return None
    mesh, recipe = c
    lay = dctx.layout()
    B, S, d = lay.batch, lay.seq, x.shape[2]
    f = p["w_up"].shape[-1]

    used: set = set()
    recipe.resolve("batch", mesh, used, B)
    s_axes = recipe.resolve("act_seq", mesh, set(used), S)
    used_w: set = set()
    recipe.resolve("embed", mesh, used_w, d)
    mlp = recipe.resolve("mlp", mesh, set(used_w), f)
    if s_axes is None or mlp is None or not isinstance(s_axes, str):
        return None
    if S % dctx.axis_size(s_axes) != 0:
        return None

    gated = "w_gate" in p
    act = cm.ACTIVATIONS["silu" if cfg.ffn_activation == "swiglu" else
                         "gelu" if gated else cfg.ffn_activation]
    xg = dctx.gather(x, s_axes, 1)
    up = xg @ dctx.param(p["w_up"], {1: mlp})
    if gated:
        h = act(xg @ dctx.param(p["w_gate"], {1: mlp})) * up
    else:
        h = act(up)
    y_part = (h @ dctx.param(p["w_down"], {0: mlp})).to(x.dtype)
    return dctx.scatter_sum(y_part, s_axes, 1)
