"""Dense feed-forward variants: SwiGLU, squared-ReLU, (gated-)GELU, and the
RWKV-6 channel mix — PyTorch port of ``repro/models/ffn.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import ctx as dctx
from repro_torch.models import common as cm


def ffn_specs(cfg, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    gated = cfg.ffn_activation in ("swiglu", "gelu")  # gelu == GeGLU (gemma-style)
    s = {
        "w_up": cm.ParamSpec((d, f), ("embed", "mlp"), dt),
        "w_down": cm.ParamSpec((f, d), ("mlp", "embed"), dt),
    }
    if gated:
        s["w_gate"] = cm.ParamSpec((d, f), ("embed", "mlp"), dt)
    return s


def ffn(cfg, p: dict, x):
    from repro_torch.distributed.sp_ffn import sp_ffn

    y = sp_ffn(cfg, p, x)    # explicit-collective Megatron/ZeRO-3 block
    if y is not None:
        return y
    p = dctx.gathered(p)
    up = x @ p["w_up"]
    if "w_gate" in p:
        act = cm.ACTIVATIONS["silu" if cfg.ffn_activation == "swiglu" else "gelu"]
        h = act(x @ p["w_gate"]) * up
    else:
        h = cm.ACTIVATIONS[cfg.ffn_activation](up)
    if h.ndim == 3:
        h = dctx.constrain_hidden(h)
    y = (h @ p["w_down"]).to(x.dtype)
    return dctx.constrain_residual(y) if y.ndim == 3 else y


def rwkv_channel_mix_specs(cfg) -> dict:
    """RWKV-6 channel mix: token-shift + squared-ReLU keyed by receptance."""
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "mu_k": cm.ParamSpec((d,), ("embed",), torch.float32, "small"),
        "mu_r": cm.ParamSpec((d,), ("embed",), torch.float32, "small"),
        "w_k": cm.ParamSpec((d, f), ("embed", "mlp"), dt),
        "w_v": cm.ParamSpec((f, d), ("mlp", "embed"), dt),
        "w_r": cm.ParamSpec((d, d), ("embed", "embed"), dt),
    }


def rwkv_channel_mix(cfg, p: dict, x, x_prev):
    """x: (B,S,d); x_prev: (B,S,d) token-shifted input (prev token)."""
    sx = x_prev - x
    kx = x + sx * p["mu_k"].to(x.dtype)
    rx = x + sx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(kx @ p["w_k"]))
    kv = k @ p["w_v"]
    r = torch.sigmoid((rx @ p["w_r"]).float())
    return (r.to(x.dtype) * kv).to(x.dtype)
