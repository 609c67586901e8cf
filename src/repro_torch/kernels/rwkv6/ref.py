"""Plain PyTorch versions of the RWKV-6 recurrence (port of
``repro/kernels/rwkv6/ref.py``), in the kernel layout (B, H, S, hd).

    S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u)·k_tᵀ v_t)

- :func:`rwkv6_ref` — the sequential scan, the oracle K3 is held against.
- :func:`chunk_scan` / :func:`rwkv6_chunked` — the chunked parallel form of
  ``repro/models/rwkv6.py::_chunk_scan``, which the reference names as the
  kernel's oracle too.  Within a chunk the pairwise decay exponent
  cum_{t-1} − cum_j (j < t) is formed as a difference, always ≤ 0, so
  ``exp`` never overflows.  K3's backward recomputes through it: the
  sequential scan would cost one Python step per token.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def rwkv6_ref(r, k, v, lw, u):
    """r,k,v,lw: (B, H, S, hd); u: (H, hd). Sequential scan over S."""
    B, H, S, hd = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(lw.float())
    bonus = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]           # (B,H,hd,hd)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, :, t], state + bonus * kv))
        state = state * w[:, :, t, :, None] + kv
    return torch.stack(ys, dim=2).to(r.dtype)


def _chunk_body(state, rc, kc, vc, lwc, u):
    """One chunk from ``state``. rc,kc,vc,lwc: (B,H,C,hd) fp32; u: (H,hd)."""
    C = rc.shape[2]
    cum = torch.cumsum(lwc, dim=2)                                # inclusive
    # pairwise exponent cum_{t-1} - cum_j  (t > j): always <= 0
    expn = (cum - lwc)[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,H,t,j,hd)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=rc.device), diagonal=-1)
    pair = torch.exp(torch.where(tri[:, :, None], expn, float("-inf")))
    A = (rc[:, :, :, None, :] * pair * kc[:, :, None, :, :]).sum(-1)   # (B,H,t,j)
    A = A + torch.diag_embed((rc * u[None, :, None, :] * kc).sum(-1))
    y = A @ vc
    # cross-chunk read: r_t decayed to the chunk start
    y = y + (rc * torch.exp(cum - lwc)) @ state
    # state update
    dec_k = torch.exp(cum[:, :, -1:] - cum)                       # <= 1
    state = (state * torch.exp(cum[:, :, -1])[..., None]
             + (kc * dec_k).transpose(-1, -2) @ vc)
    return state, y


def chunk_scan(r, k, v, lw, u, state, chunk: int):
    """Chunked recurrence from ``state`` (B,H,hd,hd) fp32; S % chunk == 0.
    Returns (y in r's dtype, final state).  Under autograd each chunk is
    recomputed in backward (the reference's ``jax.checkpoint(body)``): the
    pairwise block dwarfs r, k and v."""
    u = u.float()
    ys = []
    # split, not slicing: autograd then joins the chunks' grads with one
    # concatenation instead of adding a full-size zero-padded grad per chunk
    for blk in zip(*(t.float().split(chunk, dim=2) for t in (r, k, v, lw))):
        if torch.is_grad_enabled():
            state, y = checkpoint(_chunk_body, state, *blk, u, use_reentrant=False)
        else:
            state, y = _chunk_body(state, *blk, u)
        ys.append(y)
    return torch.cat(ys, dim=2).to(r.dtype), state


def rwkv6_chunked(r, k, v, lw, u, *, chunk: int = 32):
    """:func:`rwkv6_ref`'s signature, chunked from a zero state."""
    B, H, S, hd = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"rwkv6: sequence {S} is not a multiple of chunk {chunk}")
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    return chunk_scan(r, k, v, lw, u, state, chunk)[0]
