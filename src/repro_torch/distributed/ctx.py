"""Sharding context and the collectives of the explicit blocks — PyTorch port
of ``repro/distributed/ctx.py``.

The reference installs an ambient ``(mesh, recipe)`` while it lowers a step
and pins activations with ``with_sharding_constraint``; GSPMD partitions the
rest.  The port runs the same model code SPMD on each rank's *local shards*:

- Parameters are DTensors placed by ``sharding.param_shardings``.  A plain
  path takes a whole weight through :func:`gathered` (an all-gather; in
  backward the gradient is reduce-scattered back to the parameter's
  placement); an explicit block takes its shard through :func:`param` with
  the dimensions it keeps sharded, as the reference's ``shard_map`` bodies
  take theirs through their ``in_specs``.
- Activations are plain tensors holding this rank's shard.  The residual
  stream between layers is laid out as the reference's constraint
  ``("batch", "act_seq", None)`` asks: batch rows over the batch axes,
  sequence over ``act_seq``'s (:class:`Layout`, set from the global batch by
  :func:`local_batch`).  So :func:`constrain` on a plain tensor returns it
  unchanged (the SPMD code already holds the shard the constraint names);
  on a DTensor it redistributes it to that layout and returns the local
  shard.
- The blocks' collectives are autograd-aware DTensor redistributions on
  the mesh axes they name (:func:`gather`, :func:`scatter_sum`,
  :func:`all_sum`, :func:`sum_grad`), each with the backward that
  ``shard_map``'s transpose gives: an all-gather's is a reduce-scatter, a
  reduce-scatter's an all-gather.

Outside a context every function here returns its input, so single-device
paths are unchanged; so does every collective over mesh axes of size 1.
The context is one per process (one mesh per process), as the reference's
is, so autograd's own threads (the card's backward thread runs a
checkpointed block's recompute) see it too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import axes_tuple, mesh_axes


class _State:
    ctx: Optional[Tuple] = None         # (mesh, recipe)
    layout: Optional["Layout"] = None   # the residual layout, set by use_layout


_state = _State()

#: what each layer kind or batch input that has no distributed path yet waits for
A92 = "ROADMAP A9.2 (distributed: MoE, MLA, recurrent and encoder paths)"


def current() -> Optional[Tuple]:
    return _state.ctx


@contextlib.contextmanager
def sharding_ctx(mesh, recipe):
    prev = _state.ctx, _state.layout
    _state.ctx, _state.layout = (mesh, recipe), None
    try:
        yield
    finally:
        _state.ctx, _state.layout = prev


# ---------------------------------------------------------------------------
# the reference's constraints


def _to_layout(x, axes):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements, spec_for_axes

    if not isinstance(x, DTensor):
        return x            # a local shard, already where the SPMD code keeps it
    mesh, recipe = current()
    place = placements(mesh, spec_for_axes(axes, recipe, mesh, tuple(x.shape)))
    return x.redistribute(mesh, place).to_local()


def constrain(x, axes):
    """Pin logical axes onto x if a sharding context is active."""
    if current() is None:
        return x
    return _to_layout(x, axes)


def heads_shardable(n_heads: int) -> bool:
    """True if the ambient recipe can shard ``n_heads`` on a tensor axis."""
    c = current()
    if c is None:
        return False
    mesh, recipe = c
    return recipe.resolve("heads", mesh, set(), n_heads) is not None


def constrain_qkv(x):
    """Megatron-SP projection constraint for (B, S, H, hd) tensors:
    heads-sharded when the head count divides the tensor axis, else the
    sequence stays sharded and ``sp_attention``'s sequence variant takes the
    core."""
    if heads_shardable(x.shape[2]):
        return constrain(x, ("batch", None, "heads", None))
    return constrain(x, ("batch", "act_seq", None, None))


def constrain_hidden(x):
    """FFN hidden (B, S, F): shard F on the tensor axis, gather seq."""
    return constrain(x, ("batch", None, "mlp"))


def constrain_residual(x):
    """Layer output back to the sequence-parallel residual layout."""
    return constrain(x, ("batch", "act_seq", None))


def constrain_cache(cache: dict) -> dict:
    """Pin decode-cache leaves (kv_heads-before-seq priority resolution)."""
    c = current()
    if c is None:
        return cache
    mesh, recipe = c
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import cache_spec, placements

    out = {}
    for name, x in cache.items():
        if isinstance(x, DTensor):
            x = x.redistribute(mesh, placements(
                mesh, cache_spec(name, tuple(x.shape), recipe, mesh))).to_local()
        out[name] = x
    return out


# ---------------------------------------------------------------------------
# the residual layout and the batch


@dataclasses.dataclass(frozen=True)
class Layout:
    """The residual stream's layout for a global (batch, seq): the mesh axes
    of each (None where that dimension is whole on every rank)."""

    batch: int
    seq: int
    b_axes: object
    s_axes: object

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """Mesh axes over which ranks hold different tokens: a computation
        on local tokens is partial over these and duplicated over the rest."""
        return axes_tuple(self.b_axes) + axes_tuple(self.s_axes)


def use_layout(batch: int, seq: int) -> Layout:
    """Resolve and install the residual layout of a global (batch, seq)."""
    mesh, recipe = current()
    used: set = set()
    b_axes = recipe.resolve("batch", mesh, used, batch)
    s_axes = recipe.resolve("act_seq", mesh, set(used), seq)
    _state.layout = Layout(batch, seq, b_axes, s_axes)
    return _state.layout


def layout() -> Layout:
    lay = _state.layout
    if lay is None:
        raise RuntimeError("no residual layout: lay the batch out with local_batch "
                           "(or use_layout) inside the sharding context first")
    return lay


def device_mesh():
    mesh = current()[0]
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError("running under a sharding context needs a DeviceMesh "
                        "(repro_torch.launch.mesh.make_mesh)")
    return mesh


def axis_size(axes) -> int:
    return sharding.axis_size(current()[0], axes)


def axis_index(axes) -> int:
    """This rank's index along ``axes`` (major to minor, as they shard)."""
    mesh = device_mesh()
    sizes = mesh_axes(mesh)
    idx = 0
    for a in axes_tuple(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def local_slice(t, dim: int, axes):
    """This rank's block of ``t`` (whole on every rank) along ``dim``."""
    n = axis_size(axes)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, axis_index(axes) * size, size)


def local_batch(batch: dict) -> dict:
    """The global batch (the same on every rank; DTensors are read whole) as
    this rank's shard of the residual layout, which it installs: tokens and
    labels by batch rows and sequence, image embeddings by batch rows.  The
    identity outside a context."""
    if current() is None:
        return batch
    from torch.distributed.tensor import DTensor

    full = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in batch.items()}
    B, S = full["tokens"].shape
    lay = use_layout(B, S)
    out = {}
    for key, v in full.items():
        if key in ("tokens", "labels"):
            out[key] = local_slice(local_slice(v, 0, lay.b_axes), 1, lay.s_axes)
        elif key == "image_embeds":
            out[key] = local_slice(v, 0, lay.b_axes)
        else:
            raise NotImplementedError(f"batch input {key!r} under a sharding context: {A92}")
    return out


def positions(tokens):
    """Absolute positions of the global sequence (the whole of it on every
    rank, as the reference's blocks take them)."""
    S = tokens.shape[1] if current() is None else layout().seq
    return torch.arange(S, device=tokens.device)


def local_rows(pos, n: int):
    """The positions of this rank's ``n`` sequence rows."""
    if current() is None or pos.shape[-1] == n:
        return pos
    return local_slice(pos, pos.ndim - 1, layout().s_axes)


def token_mean(local_mean, n_local: int):
    """A mean over this rank's tokens -> the mean over every rank's."""
    if current() is None:
        return local_mean
    lay = layout()
    return all_sum(local_mean * n_local, lay.token_axes) / (lay.batch * lay.seq)


# ---------------------------------------------------------------------------
# parameters


def param(w, keep: Optional[dict] = None):
    """This rank's block of the weight ``w``: sharded over the mesh axes
    ``keep`` names for each tensor dimension, whole over every other axis.
    In backward its gradient is summed over the other axes on which ranks
    hold different tokens and reduce-scattered back to ``w``'s placement.
    A plain tensor is a value this rank already holds whole (a weight
    gathered before, or one the caller keeps in step across ranks): it is
    only cut to the kept blocks, and its gradient stays this rank's own."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(w, DTensor):
        for d, axes in (keep or {}).items():
            w = local_slice(w, d, axes)
        return w
    kept = {a: d for d, axes in (keep or {}).items() for a in axes_tuple(axes)}
    tokens = layout().token_axes
    place, grad = [], []
    for a in device_mesh().mesh_dim_names:
        if a in kept:
            place.append(Shard(kept[a]))
            grad.append(Shard(kept[a]))
        else:
            place.append(Replicate())
            grad.append(Partial() if a in tokens else Replicate())
    return w.redistribute(w.device_mesh, place).to_local(grad_placements=grad)


def gathered(p):
    """A parameter tree with each leaf whole on every rank (:func:`param`);
    the identity outside a context."""
    if current() is None:
        return p
    if isinstance(p, dict):
        return {k: gathered(v) for k, v in p.items()}
    return param(p)


# ---------------------------------------------------------------------------
# collectives on local shards


def _spread(axes) -> Tuple[str, ...]:
    """The axes of ``axes`` of more than one rank: a collective over the
    others is the identity."""
    sizes = mesh_axes(current()[0])
    return tuple(a for a in axes_tuple(axes) if sizes[a] > 1)


def _from_local(x, axis, place):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, device_mesh()[axis], [place], run_check=False)


def gather(x, axes, dim: int, partial_grad: bool = True):
    """All-gather ``x`` over ``axes`` along ``dim``.  Backward: a
    reduce-scatter when the ranks' uses differ (``partial_grad``), else each
    rank's own block of the gradient.  Several axes gather one at a time,
    the minor first (a dimension split by several axes is split major
    first)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    for a in reversed(_spread(axes)):
        x = _from_local(x, a, Shard(dim)).redistribute(placements=[Replicate()]).to_local(
            grad_placements=[Partial() if partial_grad else Replicate()])
    return x


def scatter_sum(x, axes, dim: int):
    """Reduce-scatter ``x`` over ``axes`` along ``dim`` (backward: an
    all-gather); several axes scatter one at a time, the major first."""
    from torch.distributed.tensor import Partial, Shard

    for a in _spread(axes):
        x = _from_local(x, a, Partial()).redistribute(placements=[Shard(dim)]).to_local()
    return x


def all_sum(x, axes):
    """All-reduce (sum) ``x`` over ``axes``; backward passes the gradient on
    (each rank's copy of the sum is used alike)."""
    from torch.distributed.tensor import Partial, Replicate

    for a in _spread(axes):
        x = _from_local(x, a, Partial()).redistribute(placements=[Replicate()]).to_local()
    return x


def sum_grad(x, axes):
    """The identity in forward; backward sums the gradient over ``axes``
    (where ranks that hold the same ``x`` use different parts of it)."""
    from torch.distributed.tensor import Partial, Replicate

    for a in _spread(axes):
        x = _from_local(x, a, Replicate()).to_local(grad_placements=[Partial()])
    return x
