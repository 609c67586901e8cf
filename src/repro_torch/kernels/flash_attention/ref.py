"""Plain PyTorch oracle for the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, hd); k, v: (B, K, T, hd), H = K·G. fp32 math."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, S, hd)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bkgsh,bkth->bkgst", qf, kf) / math.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool, device=q.device),
                          diagonal=T - S)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bkth->bkgsh", p, vf)
    return o.reshape(B, H, S, hd).to(q.dtype)
