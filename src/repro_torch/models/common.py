"""Model building blocks shared across architectures (PyTorch port of
``repro/models/common.py``).

Parameters are plain nested dicts of tensors with the reference's tree
layout and leaf shapes, so ``weights.params_from_jax`` can load a JAX tree
leaf for leaf.  A model definition produces a tree of :class:`ParamSpec`
leaves; :func:`init_params` materializes it on a device from a seeded
``torch.Generator`` with the reference's distributions (the values cannot
be JAX's: ``jax.random`` is not replayable in torch).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.distributed import ctx as dctx


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means ``"cuda"``, and a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:                 # "cuda" -> "cuda:<current>"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"             # normal | zeros | ones | decay | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict (leaves are non-dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """``[(path, leaf)]`` in sorted-key order, paths joined with ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_from_paths(template, values: dict, prefix: str = ""):
    """``template``'s nested-dict structure with each leaf replaced by
    ``values[path]`` (paths as :func:`tree_leaves` makes them)."""
    if isinstance(template, dict):
        return {k: tree_from_paths(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    return values[prefix]


#: the most elements drawn at once in fp32 for one leaf (a 32 GiB draw); a
#: larger leaf (moonshot-v1-16b-a3b's stacked experts, 8.7 G elements each) is
#: drawn slice by slice along its leading axis, so that its draw and the rest
#: of the parameters fit one 80 GB card together
_MAX_DRAW = 1 << 33


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "decay":
        # log-decay init for recurrences: a in (0.9, 0.999)
        u = torch.empty(spec.shape, dtype=torch.float32, device=device)
        u.uniform_(0.9, 0.999, generator=gen)
        return torch.log(-torch.log(u)).to(spec.dtype)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    if spec.init == "small":
        std = 0.02 * spec.scale
    if math.prod(spec.shape) <= _MAX_DRAW:
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return x.mul_(std).to(spec.dtype)    # in place: one fp32 copy at a time
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for i in range(spec.shape[0]):
        out[i] = torch.randn(spec.shape[1:], generator=gen, dtype=torch.float32,
                             device=device).mul_(std)
    return out


def init_params(specs, seed: int = 0, device=None):
    """Materialize a ParamSpec tree on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_from_paths(specs, {path: _init_leaf(s, gen, dev)
                                   for path, s in tree_leaves(specs)})


# ---------------------------------------------------------------------------
# numerics


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x, w, b=None, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * (1.0 + w.float())
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def norm_spec(cfg, dim: int, axes=("embed",)) -> dict:
    s = {"scale": ParamSpec((dim,), axes, torch.float32, "zeros")}
    if cfg.norm == "layernorm":
        s["bias"] = ParamSpec((dim,), axes, torch.float32, "zeros")
    return s


def apply_norm(cfg, p: dict, x):
    p = dctx.gathered(p)
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p.get("bias"))
    return rmsnorm(x, p["scale"])


def rope(x, positions, theta: float = 10000.0, rotary_dim: Optional[int] = None):
    """Rotary position embedding over the trailing head-dim (half-split).

    x: (..., seq, heads, head_dim) or (..., seq, head_dim); positions:
    (seq,) shared across the batch, or (batch, seq) when each row sits on
    its own timeline (continuous batching).
    """
    hd = x.shape[-1]
    rd = rotary_dim or hd
    half = rd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    positions = torch.atleast_1d(torch.as_tensor(positions, device=x.device))
    ang = positions[..., None].float() * freq                  # (..., seq, half)
    if x.ndim == 4:                                            # (B, S, H, hd)
        ang = ang[..., None, :]                                # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:rd]
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if rd < hd:
        xr = torch.cat([xr, x[..., rd:]], dim=-1)
    return xr.to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable] = {
    "gelu": gelu,
    "silu": F.silu,
    "squared_relu": lambda x: torch.square(F.relu(x)),
    "relu": F.relu,
}


#: the products whose outputs the selective policies keep for backward:
#: every matmul ("dots", JAX's ``checkpoint_dots``) or those without a batch
#: dimension ("dots_no_batch", ``checkpoint_dots_with_no_batch_dims``)
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
}


def remat_policy(name: str):
    """Config remat names (the reference's) -> what to wrap a block with:
    ``None`` for no recompute, else the ``context_fn`` of
    ``torch.utils.checkpoint.checkpoint`` (``"full"`` recomputes everything,
    the selective ones save their products' outputs; ``"moe"`` is
    ``"full"`` on one device, until A9's sharded MoE names what it saves)."""
    if name == "nothing":
        return None
    if name in ("full", "moe"):
        # "moe" saves only the tensors named ``moe_bufe`` / ``moe_h``, which
        # the reference names in its sharded dispatch alone
        # (``distributed/sp_moe.py``, ROADMAP A9): on one device nothing
        # carries those names, so it recomputes everything, as "full"
        return noop_context_fn
    if name in _SAVED_PRODUCTS:
        saved = _SAVED_PRODUCTS[name]

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        return functools.partial(create_selective_checkpoint_contexts, policy)
    raise ValueError(f"unknown remat policy {name!r}")


def maybe_remat(fn, policy_name: str):
    """``fn`` wrapped so that its backward recomputes it under the named
    policy (non-reentrant ``torch.utils.checkpoint``); ``"nothing"`` returns
    ``fn`` itself."""
    context_fn = remat_policy(policy_name)
    if context_fn is None:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)
