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
- :func:`rwkv6_subchunked` — the chunked form with the pairwise decay
  factored across sub-chunks (both factors ≤ 1), the arithmetic K3 runs on
  its tensor cores; a test oracle only.
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
    """Chunked recurrence from ``state`` (B,H,hd,hd) fp32, in chunks of
    ``chunk`` tokens, the last one the remainder when ``chunk`` does not
    divide S.  Returns (y in r's dtype, final state).  Under autograd each chunk is
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


def rwkv6_subchunked(r, k, v, lw, u, *, chunk: int = 32, sub: int = 16):
    """:func:`rwkv6_ref`'s signature; the chunked form with the pairwise decay
    factored across sub-chunks of ``sub`` tokens, as K3 computes it.  A test
    oracle only (the CPU path and the backward use :func:`rwkv6_chunked`).

    Inside a diagonal sub-block the exponent stays the difference
    cum[t-1] - cum[j] <= 0.  Across sub-blocks I > J it is split at p, the
    last position of J: exp(cum[t-1] - cum[p]) * exp(cum[p] - cum[j]), both
    factors <= 1 because j <= p <= t-1 and cum only falls, so the block is a
    product (r_I * e^(cum[t-1]-cum[p])) (k_J * e^(cum[p]-cum[j]))^T.  Works in
    float64 for float64 inputs, else in float32."""
    B, H, S, hd = r.shape
    if chunk < 1 or S % chunk or sub < 1:
        raise ValueError(f"rwkv6: sequence {S} is not a multiple of chunk {chunk}")
    wt = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, lwf = (t.to(wt) for t in (r, k, v, lw))
    uf = u.to(wt)[None, :, None, :]
    state = torch.zeros((B, H, hd, hd), dtype=wt, device=r.device)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lc = (t[:, :, c0:c0 + chunk] for t in (rf, kf, vf, lwf))
        cum = torch.cumsum(lc, dim=2)
        cx = cum - lc                                              # cum[t-1]
        A = torch.diag_embed((rc * uf * kc).sum(-1))               # the bonus diagonal
        for i0 in range(0, chunk, sub):
            ti = slice(i0, min(i0 + sub, chunk))
            n = ti.stop - i0
            tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r.device), -1)
            expn = cx[:, :, ti, None, :] - cum[:, :, None, ti, :]
            pair = torch.exp(torch.where(tri[:, :, None], expn, float("-inf")))
            A[:, :, ti, ti] += (rc[:, :, ti, None, :] * pair * kc[:, :, None, ti, :]).sum(-1)
            for j0 in range(0, i0, sub):
                tj = slice(j0, j0 + sub)
                p = cum[:, :, j0 + sub - 1:j0 + sub]               # cum at J's last position
                ra = rc[:, :, ti] * torch.exp(cx[:, :, ti] - p)
                kb = kc[:, :, tj] * torch.exp(p - cum[:, :, tj])
                A[:, :, ti, tj] = ra @ kb.transpose(-1, -2)
        ys.append(A @ vc + (rc * torch.exp(cx)) @ state)
        state = (state * torch.exp(cum[:, :, -1])[..., None]
                 + (kc * torch.exp(cum[:, :, -1:] - cum)).transpose(-1, -2) @ vc)
    return torch.cat(ys, dim=2).to(r.dtype)
