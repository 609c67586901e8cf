"""Dense feed-forward variants: SwiGLU, squared-ReLU, (gated-)GELU — PyTorch
port of ``repro/models/ffn.py``."""
from __future__ import annotations

from repro_torch.configs.base import torch_dtype
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
    up = x @ p["w_up"]
    if "w_gate" in p:
        act = cm.ACTIVATIONS["silu" if cfg.ffn_activation == "swiglu" else "gelu"]
        h = act(x @ p["w_gate"]) * up
    else:
        h = cm.ACTIVATIONS[cfg.ffn_activation](up)
    return (h @ p["w_down"]).to(x.dtype)
