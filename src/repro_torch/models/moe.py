"""Routed mixture-of-experts with sort-based capacity dispatch — PyTorch port
of ``repro/models/moe.py`` on one device.

1. route: top-k expert ids per token,
2. flatten (token, choice) pairs and stable-sort them by expert id,
3. each pair's slot within its expert is its rank less the expert's start,
4. scatter token activations into an (E, cap, d) buffer; a pair past
   ``cap`` is dropped (its output is zero),
5. per-expert batched products over the buffer,
6. gather each pair's output back and combine with its router weight.

Which pairs drop depends on the capacity formula (Python's ``round``, then
up to a multiple of 128 above 128), the stable sort and the top-k tie order
(the lower expert id first, as ``jax.lax.top_k``), all kept from the
reference.  Two things differ, so that the step is deterministic on the card
(a CUDA graph replay and an eager step agree bit for bit) and captures as a
graph (no host reads):

- dropped pairs are written into one spare row instead of being added as
  zeros into their expert's last slot;
- each token's k contributions are summed in choice order through the
  inverse permutation, where the reference scatter-adds them
  (``.at[tok].add``; on CUDA an ``index_add_`` adds duplicates by atomics
  in no fixed order).

The reference's sharded dispatch (``sp_moe``/``sp_ffn``) is ROADMAP A9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.models import common as cm


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    dt = torch_dtype(cfg.param_dtype)
    s = {
        "router": cm.ParamSpec((d, e), ("embed", None), torch.float32, "small"),
        "w_gate": cm.ParamSpec((e, d, f), ("expert", "embed", "mlp"), dt),
        "w_up": cm.ParamSpec((e, d, f), ("expert", "embed", "mlp"), dt),
        "w_down": cm.ParamSpec((e, f, d), ("expert", "mlp", "embed"), dt),
    }
    if m.num_shared_experts:
        fs = m.shared_ff
        s["shared"] = {
            "w_gate": cm.ParamSpec((d, fs), ("embed", "mlp"), dt),
            "w_up": cm.ParamSpec((d, fs), ("embed", "mlp"), dt),
            "w_down": cm.ParamSpec((fs, d), ("mlp", "embed"), dt),
        }
    return s


def capacity(tokens: int, top_k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's formula, half to even included."""
    cap = int(max(1, round(tokens * top_k / num_experts * capacity_factor)))
    return -(-cap // 128) * 128 if cap > 128 else cap


def _route(cfg, p, x2d):
    """x2d: (T, d) -> probs (T, k), ids (T, k), aux load-balance loss."""
    m = cfg.moe
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert id first among ties,
    # as jax.lax.top_k does; torch.topk promises no order for ties
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :m.top_k], top_i[:, :m.top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)         # renormalize
    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    experts = torch.arange(m.num_experts, device=x2d.device)
    density = (top_i[:, :1] == experts).float().mean(0)
    aux = m.num_experts * torch.sum(density * probs.mean(0))
    return top_p, top_i, aux


def _dispatch(top_i, num_experts: int, cap: int):
    """-> (order, sorted expert id, slot, keep) of the flattened (token,
    choice) pairs sorted stably by expert: ``slot`` is a pair's rank within
    its expert, ``keep`` whether it is below ``cap``."""
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(num_experts, dtype=sorted_e.dtype, device=sorted_e.device)
    starts = torch.searchsorted(sorted_e, experts)
    slot = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    return order, sorted_e, slot, slot < cap


def moe_ffn(cfg, p: dict, x):
    """x: (B, S, d) -> ((B, S, d), aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    x2d = x.reshape(T, d)
    top_p, top_i, aux = _route(cfg, p, x2d)
    cap = capacity(T, k, E, m.capacity_factor)
    order, sorted_e, slot, keep = _dispatch(top_i, E, cap)

    tok = order // k                                              # source token / pair
    # kept pairs own distinct rows of the (E, cap) buffer; every dropped pair
    # writes the spare row E * cap, which is cut off
    row = torch.where(keep, sorted_e * cap + slot, E * cap)
    buf = x2d.new_zeros((E * cap + 1, d)).index_put((row,), x2d[tok])
    buf = buf[:E * cap].view(E, cap, d)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).to(x.dtype).view(E * cap, d)

    gathered = out_buf[torch.where(keep, sorted_e * cap + slot, 0)]
    gathered = torch.where(keep[:, None], gathered, 0)
    pair_w = top_p.reshape(T * k)[order].to(x.dtype)
    contrib = gathered * pair_w[:, None]
    # back to (token, choice) order through the inverse permutation, then
    # each token's k contributions summed in choice order
    contrib = torch.zeros_like(contrib).index_copy(0, order, contrib).view(T, k, d)
    y2d = contrib[:, 0]
    for c in range(1, k):
        y2d = y2d + contrib[:, c]

    if "shared" in p:
        y2d = y2d + _shared_experts(p["shared"], x2d)
    return y2d.reshape(B, S, d), aux


def _shared_experts(sp: dict, x):
    """Always-on shared experts (DeepSeek/Moonlight): a SwiGLU FFN."""
    h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
    return (h @ sp["w_down"]).to(x.dtype)
