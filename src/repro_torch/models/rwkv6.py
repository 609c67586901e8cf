"""RWKV-6 "Finch" time-mix (arXiv:2404.05892) — data-dependent decay.
PyTorch port of ``repro/models/rwkv6.py``.

Recurrence per head (state S ∈ R^{hd×hd}, fp32):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

with per-channel, per-token decay  w_t = exp(-exp(w0 + lora_w(x̃_t))) ∈ (0,1).

Training and prefill use the chunked parallel form (chunk length ``CHUNK``,
the math of ``kernels/rwkv6/ref.py::chunk_scan``), or K3 where the
reference's gate allows; decode runs the recurrence one token at a time
(``rwkv_decode``).  A sequence of S tokens with S % CHUNK != 0 and
S > CHUNK runs ⌊S/CHUNK⌋ chunks and then one remainder chunk, carrying the
state across; the reference falls to chunks of one token there (the same
recurrence, rounded differently in fp32: ROADMAP C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.kernels.rwkv6.ref import chunk_scan
from repro_torch.models import common as cm

CHUNK = 32
_MIX = 5  # w, k, v, r, g


def rwkv_specs(cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = cfg.rwkv.head_dim
    dl, ml, gl = cfg.rwkv.decay_lora, cfg.rwkv.mix_lora, cfg.rwkv.gate_lora
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "mu_x": cm.ParamSpec((d,), ("embed",), f32, "small"),
        "mu_5": cm.ParamSpec((_MIX, d), (None, "embed"), f32, "small"),
        "tm_w1": cm.ParamSpec((d, _MIX * ml), ("embed", "lora"), dt),
        "tm_w2": cm.ParamSpec((_MIX, ml, d), (None, "lora", "embed"), dt, "small"),
        "w0": cm.ParamSpec((d,), ("embed",), f32, "decay"),
        "td_w1": cm.ParamSpec((d, dl), ("embed", "lora"), dt),
        "td_w2": cm.ParamSpec((dl, d), ("lora", "embed"), dt, "small"),
        "u": cm.ParamSpec((h, hd), ("heads", None), f32, "small"),
        "w_r": cm.ParamSpec((d, h, hd), ("embed", "heads", None), dt),
        "w_k": cm.ParamSpec((d, h, hd), ("embed", "heads", None), dt),
        "w_v": cm.ParamSpec((d, h, hd), ("embed", "heads", None), dt),
        "w_g": cm.ParamSpec((d, gl), ("embed", "lora"), dt),
        "w_g2": cm.ParamSpec((gl, h, hd), ("lora", "heads", None), dt),
        "ln_x": cm.ParamSpec((h, hd), ("heads", None), f32, "zeros"),
        "ln_x_b": cm.ParamSpec((h, hd), ("heads", None), f32, "zeros"),
        "w_o": cm.ParamSpec((h, hd, d), ("heads", None, "embed"), dt),
    }


def _projections(cfg, p, x, x_prev):
    """Token-shift mixing + r/k/v/g/decay projections.

    x, x_prev: (B, S, d).  Returns r,k,v,g: (B,S,H,hd); lw: (B,S,H,hd) fp32
    (log-decay, ≤ 0).
    """
    B, S, d = x.shape
    h, hd = cfg.num_heads, cfg.rwkv.head_dim
    sx = (x_prev - x).to(x.dtype)
    xx = x + sx * p["mu_x"].to(x.dtype)
    m = torch.tanh(xx @ p["tm_w1"]).reshape(B, S, _MIX, -1)
    deltas = torch.einsum("bsfl,fld->bsfd", m, p["tm_w2"])          # (B,S,5,d)
    mixed = x[:, :, None, :] + sx[:, :, None, :] * (
        p["mu_5"].to(x.dtype)[None, None] + deltas)
    xw, xk, xv, xr, xg = mixed.unbind(2)

    r = torch.einsum("bsd,dhk->bshk", xr, p["w_r"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["w_k"])
    v = torch.einsum("bsd,dhk->bshk", xv, p["w_v"])
    g = F.silu(torch.einsum("bsl,lhk->bshk", torch.tanh(xg @ p["w_g"]), p["w_g2"]))
    w_raw = p["w0"].float() + (torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]).float()
    lw = -torch.exp(w_raw).reshape(B, S, h, hd)                     # log w_t ≤ 0
    return r, k, v, g, lw


def _chunk_scan(r, k, v, lw, u, state):
    """Chunked linear recurrence.  r,k,v: (B,S,H,hd) compute dtype;
    lw: (B,S,H,hd) fp32; u: (H,hd); state: (B,H,hd,hd) fp32.  Chunks of
    ``CHUNK`` tokens, the last one the remainder (one chunk of S when
    S < CHUNK, as in the reference)."""
    y, state = chunk_scan(*(t.transpose(1, 2) for t in (r, k, v, lw)), u, state, CHUNK)
    return y.transpose(1, 2), state


def _readout(cfg, p, y, g, x_dtype):
    """Per-head groupnorm → gate → output projection."""
    yf = y.float()
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(yf - mu), dim=-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + 64e-5)
    yn = yn * (1.0 + p["ln_x"]) + p["ln_x_b"]
    out = yn.to(x_dtype) * g.to(x_dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"]).to(x_dtype)


def rwkv_time_mix(cfg, p: dict, x, x_prev=None, state=None,
                  want_state: bool = True):
    """Full-sequence time-mix. Returns (out, final_state, last_x).

    ``want_state=False`` (train path — the final state is discarded) allows
    routing through the hand-written chunked-recurrence kernel K3 when
    ``cfg.use_pallas`` is set; the returned state is then the input state.
    """
    B, S, d = x.shape
    h, hd = cfg.num_heads, cfg.rwkv.head_dim
    if x_prev is None:
        x_prev_seq = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:  # continuing from a cached last token
        x_prev_seq = torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)
    r, k, v, g, lw = _projections(cfg, p, x, x_prev_seq)
    if state is None:
        state = torch.zeros((B, h, hd, hd), dtype=torch.float32, device=x.device)
    use_kernel = (cfg.use_pallas and not want_state and S % CHUNK == 0
                  and x_prev is None)
    if use_kernel:
        from repro_torch.kernels.rwkv6.ops import time_mix_scan

        y = time_mix_scan(r, k, v, lw, p["u"].float(), chunk=CHUNK)
    else:
        y, state = _chunk_scan(r, k, v, lw, p["u"].float(), state)
    return _readout(cfg, p, y, g, x.dtype), state, x[:, -1]


def rwkv_decode(cfg, p: dict, x1, state, x_prev):
    """Single-token decode. x1: (B,1,d); state: (B,H,hd,hd) fp32; x_prev: (B,d).
    Returns (out, new state, x1[:, 0])."""
    r, k, v, g, lw = _projections(cfg, p, x1, x_prev[:, None, :])
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))               # (B,H,hd)
    w = torch.exp(lw[:, 0])                                         # (B,H,hd)
    u = p["u"].float()
    kv = kf[..., :, None] * vf[..., None, :]                        # (B,H,hd,hd)
    y = torch.einsum("bhd,bhde->bhe", rf, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    out = _readout(cfg, p, y[:, None].to(x1.dtype), g, x1.dtype)
    return out, state, x1[:, 0]
