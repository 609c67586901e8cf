"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
PyTorch port of ``repro/models/rglru.py``.

    r_t = σ(W_a x_t + b_a)                  recurrence gate
    i_t = σ(W_x x_t + b_x)                  input gate
    a_t = exp(-c · softplus(Λ) ⊙ r_t)       per-channel decay
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Block layout: linear-in (d→w) ∥ gelu gate branch, causal depthwise conv
(width 4), RG-LRU, gated multiply, linear-out (w→d).  Over a full sequence
the diagonal linear recurrence goes through the hand-written kernel K2
(``kernels/rglru/ops.py::linear_recurrence``) under the reference's gate, and
otherwise through the plain doubling scan ``rglru_ref``; decode is one
sequential step (O(1) state).  The conv tail and ``h`` are fp32, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.kernels.rglru.ops import linear_recurrence
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.models import common as cm


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width
    cw = cfg.recurrent.conv_width
    dt = torch_dtype(cfg.param_dtype)
    return {
        "w_in": cm.ParamSpec((d, w), ("embed", "mlp"), dt),
        "w_gate_in": cm.ParamSpec((d, w), ("embed", "mlp"), dt),
        "conv_w": cm.ParamSpec((cw, w), ("conv", "mlp"), dt, "small"),
        "conv_b": cm.ParamSpec((w,), ("mlp",), torch.float32, "zeros"),
        "lam": cm.ParamSpec((w,), ("mlp",), torch.float32, "decay"),
        "w_a": cm.ParamSpec((w, w), ("mlp", "mlp"), dt, "small"),
        "b_a": cm.ParamSpec((w,), ("mlp",), torch.float32, "zeros"),
        "w_x": cm.ParamSpec((w, w), ("mlp", "mlp"), dt, "small"),
        "b_x": cm.ParamSpec((w,), ("mlp",), torch.float32, "zeros"),
        "w_out": cm.ParamSpec((w, d), ("mlp", "embed"), dt),
    }


def _gates(cfg, p, u):
    """u: (..., w) conv output → (a, b) of the recurrence h' = a·h + b, fp32."""
    uf = u.float()
    r = torch.sigmoid((u @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((u @ p["w_x"]).float() + p["b_x"])
    log_a = -cfg.recurrent.c * F.softplus(p["lam"]) * r           # ≤ 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def _conv_train(p, x):
    """Causal depthwise conv via shifted adds. x: (B,S,w)."""
    cw = p["conv_w"].shape[0]
    y = x * p["conv_w"][cw - 1].to(x.dtype)
    for i in range(1, cw):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        y = y + shifted * p["conv_w"][cw - 1 - i].to(x.dtype)
    return y + p["conv_b"].to(x.dtype)


def rglru_block(cfg, p: dict, x, h0=None, conv_state=None):
    """Full-sequence recurrent block. x: (B,S,d).

    Returns (out, (h_final, conv_tail)) — the state pair primes decode.
    """
    B, S, _ = x.shape
    u = x @ p["w_in"]
    gate = cm.gelu(x @ p["w_gate_in"])
    if conv_state is not None:  # continuation: prepend cached conv tail
        u_ext = torch.cat([conv_state.to(u.dtype), u], dim=1)
        c = _conv_train(p, u_ext)[:, conv_state.shape[1]:]
    else:
        c = _conv_train(p, u)
    a, b = _gates(cfg, p, c)

    W = a.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    # the reference's gate; its ``h0 is not None`` test always holds, since
    # h0 is set just above
    if cfg.use_pallas and S % 64 == 0 and W % min(128, W) == 0:
        # the kernel starts from h = 0: fold the carried state into b_0
        # instead, h_1 = a_1·h0 + b_1
        b_seeded = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
        h = linear_recurrence(a, b_seeded, chunk=64, block_w=min(128, W))
    else:
        # the carried state as step 0 with a = 1 (identity), b = h0
        a_ext = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b_ext = torch.cat([h0[:, None, :], b], dim=1)
        h = rglru_ref(a_ext, b_ext)[:, 1:]                       # drop the seed step
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    cw = cfg.recurrent.conv_width
    conv_tail = u[:, -(cw - 1):].float()
    return out.to(x.dtype), (h[:, -1], conv_tail)


def rglru_decode(cfg, p: dict, x1, h, conv_state):
    """One-token step. x1: (B,1,d); h: (B,w) fp32; conv_state: (B,cw-1,w).

    Returns (out (B,1,d), new h, new conv state); the caller writes the
    state into its cache."""
    u = x1 @ p["w_in"]                                            # (B,1,w)
    gate = cm.gelu(x1 @ p["w_gate_in"])
    window = torch.cat([conv_state.to(u.dtype), u], dim=1)       # (B,cw,w)
    c = torch.einsum("bcw,cw->bw", window, p["conv_w"].to(u.dtype)) + p["conv_b"].to(u.dtype)
    a, b = _gates(cfg, p, c[:, None, :])
    h = (a[:, 0] * h + b[:, 0]).float()
    out = (h.to(x1.dtype) * gate[:, 0]) @ p["w_out"]
    return out[:, None].to(x1.dtype), h, window[:, 1:].float()
