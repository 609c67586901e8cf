"""AdamW with configurable moment dtype — PyTorch port of
``repro/training/optimizer.py``.

Moments live in ``cfg.moment_dtype`` (fp32 default; bf16 for the 236B/340B
archs), parameters stay in ``cfg.param_dtype``.  The arithmetic of each
leaf's update follows its moment dtype, as in the reference: bf16 moments
mean bf16 update math, with each constant rounded to bf16 first as JAX's
weak-typed scalars are.  The update is in place: the reference's launcher
donates the state to the jitted step (``donate_argnums=0``), and the port
reuses the same buffers.  Under a sharding context the parameters, grads and
moments are DTensors of one placement: each rank updates its own shards,
and the global grad norm sums every shard once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import torch_dtype
from repro_torch.models import common as cm


class OptState(NamedTuple):
    step: Any
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params, moment_dtype) -> OptState:
    """Zero moments laid out as ``params`` (DTensors take their placements)."""
    mdt = torch_dtype(moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)
    device = cm.tree_leaves(params)[0][1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=cm.tree_map(zeros, params), nu=cm.tree_map(zeros, params))


def _whole(t):
    """A DTensor reduction's value, the same on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t):
    """The tensor this rank updates in place (a DTensor's local shard)."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tree):
    return torch.sqrt(sum(_whole(torch.sum(torch.square(g.float())))
                          for _, g in cm.tree_leaves(tree)))


def _schedule(hp: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(hp.warmup_steps, 1), max=1.0)
    return hp.lr * warm


def _const(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a JAX weak-typed scalar takes the array's
    dtype before the operation)."""
    return float(torch.tensor(x, dtype=dtype))


#: elements of a leaf updated at once (see ``apply_updates``)
UPDATE_SLICE = 1 << 24


@torch.no_grad()
def apply_updates(hp: AdamWConfig, params, grads, state: OptState):
    """One AdamW step, in place on ``params`` and ``state``'s moments.
    Returns (params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = _schedule(hp, step)
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(hp.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(hp.b2, dtype=torch.float32, device=t.device), t)

    def upd_one(p, g, m, v):
        cdt = torch.float32 if m.dtype == torch.float32 else torch.bfloat16
        c = lambda x: _const(x, cdt)
        gf = g.to(cdt) * scale.to(cdt)
        mf = c(hp.b1) * m.to(cdt) + c(1 - hp.b1) * gf
        vf = c(hp.b2) * v.to(cdt) + c(1 - hp.b2) * torch.square(gf)
        mhat = mf / bc1.to(cdt)
        vhat = vf / bc2.to(cdt)
        delta = mhat / (torch.sqrt(vhat) + c(hp.eps)) + c(hp.weight_decay) * p.to(cdt)
        p.copy_(p.to(cdt) - lr.to(cdt) * delta)
        m.copy_(mf)
        v.copy_(vf)

    flat_m = dict(cm.tree_leaves(state.mu))
    flat_v = dict(cm.tree_leaves(state.nu))
    flat_g = dict(cm.tree_leaves(grads))
    for path, p in cm.tree_leaves(params):
        # slice by slice: the same arithmetic per element, with the update's
        # ~10 temporaries in the moment dtype bounded by the slice, not the
        # leaf (a 256000 x 4096 embedding would need ~40 GB of them in fp32)
        pv, mv, vv = (_local(t).view(-1) for t in (p, flat_m[path], flat_v[path]))
        gv = _local(flat_g[path]).reshape(-1)
        for i in range(0, pv.numel(), UPDATE_SLICE):
            sl = slice(i, i + UPDATE_SLICE)
            upd_one(pv[sl], gv[sl], mv[sl], vv[sl])
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
