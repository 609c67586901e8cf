"""Logical-axis sharding rules -> mesh axes and DTensor placements — PyTorch
port of ``repro/distributed/sharding.py``.

A :class:`ShardingRecipe` maps *logical* parameter axes (the ``axes`` of each
``ParamSpec``) onto mesh axes, under the reference's names and rules.  The
reference turns a per-dimension list of mesh axes into a JAX
``PartitionSpec`` and a ``NamedSharding``; the port keeps the list (a
tuple, one entry per tensor dimension: ``None``, a mesh axis name or a
tuple of names) and turns it into DTensor placements, one per mesh
dimension (``Shard(d)`` where the mesh axis shards tensor dimension ``d``,
else ``Replicate()``), through :class:`NamedSharding`.

Baseline recipe (``"baseline"``):
- batch            -> all data-like axes ("pod", "data")
- heads/mlp/vocab/expert (tensor-/expert-parallel) -> "model"
- embed (FSDP)     -> "data"   (parameters sharded inside a pod,
                                replicated across pods)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or any object with ``axis_names`` and a ``shape`` mapping of
axis name to size (the reference's ``Mesh`` reads the same way), which
is all :meth:`ShardingRecipe.resolve` reads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


def mesh_axes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axes_tuple(axes) -> Tuple[str, ...]:
    """A resolved entry (None, a name or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    """The number of ranks along a resolved entry's mesh axes."""
    return math.prod(mesh_axes(mesh)[a] for a in axes_tuple(axes))


@dataclasses.dataclass(frozen=True)
class ShardingRecipe:
    name: str
    # logical axis -> tuple of mesh axis names (filtered by mesh presence)
    rules: Dict[str, Tuple[str, ...]]
    description: str = ""

    def resolve(self, logical: Optional[str], mesh, used: set,
                dim: Optional[int] = None):
        """Mesh axes for one tensor dim.

        Greedy divisibility fallback: mesh axes whose size does not divide
        the dimension are dropped (e.g. qwen's 40 heads or GQA kv=8 over a
        16-way model axis -> replicated).
        """
        if logical is None:
            return None
        sizes = mesh_axes(mesh)
        want = self.rules.get(logical, ())
        axes = []
        prod = 1
        for a in want:
            if a not in sizes or a in used:
                continue
            size = sizes[a]
            if dim is not None and dim % (prod * size) != 0:
                continue
            axes.append(a)
            prod *= size
        if not axes:
            return None
        used.update(axes)
        return tuple(axes) if len(axes) > 1 else axes[0]


BASELINE = ShardingRecipe(
    name="baseline",
    rules={
        "batch": ("pod", "data"),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "embed": ("data",),          # FSDP within pod
        "seq_kv": ("model",),        # KV-cache context sharding fallback
        "qkv_hd": ("model",),        # head_dim fallback for non-divisible heads
        "act_seq": ("model",),       # sequence-parallel residual stream:
                                     # layer-boundary activations shard their
                                     # seq dim over the model axis; attention
                                     # and FFN re-gather inside the layer
        "lora": (),
        "layers": (),
        "conv": (),
    },
    description="DP(pod,data) × TP/EP(model) × FSDP(data) — paper-faithful default",
)

FSDP_POD = ShardingRecipe(
    name="fsdp_pod",
    rules={**BASELINE.rules, "embed": ("pod", "data")},
    description="FSDP spans the pod axis too (param all-gather over DCI)",
)

TP_ONLY = ShardingRecipe(
    name="tp_only",
    rules={**BASELINE.rules, "embed": ()},
    description="pure DP×TP (params replicated across data axis)",
)

EXPERT_DATA = ShardingRecipe(
    name="expert_data",
    rules={**BASELINE.rules, "expert": ("data", "model"), "embed": ()},
    description="experts sharded over data×model (2D EP) for large-E MoE",
)

SEQ_DATA = ShardingRecipe(
    name="seq_data",
    rules={**BASELINE.rules, "seq": ("data",), "batch": ("pod", "data")},
    description="adds sequence sharding over data for long-context prefill",
)

NO_SP = ShardingRecipe(
    name="no_sp",
    rules={**BASELINE.rules, "act_seq": ()},
    description="baseline without sequence-parallel activations (ablation)",
)

RECIPES: Dict[str, ShardingRecipe] = {
    r.name: r for r in (BASELINE, FSDP_POD, TP_ONLY, EXPERT_DATA, SEQ_DATA, NO_SP)
}


def spec_for_axes(axes, recipe: ShardingRecipe, mesh, shape=None) -> tuple:
    """The mesh axes of each tensor dimension (the reference's
    ``PartitionSpec``)."""
    used: set = set()
    dims = shape if shape is not None else (None,) * len(axes)
    return tuple(recipe.resolve(a, mesh, used, d) for a, d in zip(axes, dims))


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where it shards tensor dimension ``d``, else
    ``Replicate()``.  A tensor dimension sharded by several mesh axes is
    split by them in the order the spec names them, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for a in axes_tuple(entry):
            owner[a] = d
    names = list(mesh_axes(mesh))
    for d, entry in enumerate(spec):               # DTensor splits in mesh order
        order = [names.index(a) for a in axes_tuple(entry)]
        if order != sorted(order):
            raise ValueError(f"{spec!r}: tensor dim {d} takes its mesh axes out of "
                             f"mesh order {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def distribute(self, tensor):
        """``tensor`` (the same whole value on every rank) as a DTensor laid
        out by this sharding; each rank keeps its own slice, no data moves."""
        from torch.distributed.tensor import DTensor

        local = tensor
        coords = self.mesh.get_coordinate()
        sizes = mesh_axes(self.mesh)
        names = list(sizes)
        for d, entry in enumerate(self.spec):
            for a in axes_tuple(entry):
                local = local.chunk(sizes[a], dim=d)[coords[names.index(a)]]
        return DTensor.from_local(local.contiguous(), self.mesh, self.placements,
                                  run_check=False, shape=tensor.shape,
                                  stride=tensor.stride())


def param_shardings(specs, recipe: ShardingRecipe, mesh):
    """ParamSpec tree -> NamedSharding tree."""
    from repro_torch.models import common as cm

    return cm.tree_map(
        lambda s: NamedSharding(mesh, spec_for_axes(s.axes, recipe, mesh, s.shape)), specs)


def batch_sharding(mesh, recipe: ShardingRecipe, rank: int,
                   seq_axis: Optional[int] = None, shape=None) -> NamedSharding:
    """Sharding for an input whose leading dim is batch."""
    used: set = set()
    spec = [None] * rank
    bdim = shape[0] if shape else None
    spec[0] = recipe.resolve("batch", mesh, used, bdim)
    if seq_axis is not None and "seq" in recipe.rules:
        sdim = shape[seq_axis] if shape else None
        spec[seq_axis] = recipe.resolve("seq", mesh, used, sdim)
    return NamedSharding(mesh, tuple(spec))


def for_decode(recipe: ShardingRecipe) -> ShardingRecipe:
    """Decode-cell variant: batch may additionally shard over the model axis
    (decode has tiny activations; owning full KV context per chip avoids
    per-layer KV all-gathers when batch divides)."""
    rules = dict(recipe.rules)
    rules["batch"] = tuple(rules.get("batch", ())) + ("model",)
    return ShardingRecipe(recipe.name + "+decode", rules, recipe.description)


# decode-cache leaf-name -> logical axes (rank-matched, batch-leading)
CACHE_AXES = {
    "k": ("batch", "seq_kv", "kv_heads", None),
    "v": ("batch", "seq_kv", "kv_heads", None),
    "ck": ("batch", "seq_kv", "heads", None),
    "cv": ("batch", "seq_kv", "heads", None),
    "cross_k": ("batch", "seq_kv", "kv_heads", None),
    "cross_v": ("batch", "seq_kv", "kv_heads", None),
    "c_kv": ("batch", "seq_kv", None),
    "k_rope": ("batch", "seq_kv", None),
    "s": ("batch", "heads", None, None),
    "ts_tm": ("batch", None),
    "ts_cm": ("batch", None),
    "h": ("batch", "mlp"),
    "conv": ("batch", None, "mlp"),
}

# resolution priority: batch first, then parallel dims, context sharding last
_PRIORITY = {"batch": 0, "kv_heads": 1, "heads": 1, "mlp": 1, "expert": 1,
             "seq_kv": 2}


def cache_spec(name: str, shape, recipe: ShardingRecipe, mesh) -> tuple:
    axes = CACHE_AXES[name]
    rank = len(shape)
    if rank == len(axes) + 1:                # stacked by cycle repetitions
        axes = (None,) + axes
    assert rank == len(axes), (name, shape)
    used: set = set()
    order = sorted(range(rank), key=lambda i: _PRIORITY.get(axes[i], 3))
    resolved = [None] * rank
    for i in order:
        resolved[i] = recipe.resolve(axes[i], mesh, used, shape[i])
    return tuple(resolved)


def cache_shardings(cache_tree, recipe: ShardingRecipe, mesh):
    """Decode-cache tree (possibly layer-stacked) -> NamedSharding tree,
    by each leaf's name."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return NamedSharding(mesh, cache_spec(name, tuple(tree.shape), recipe, mesh))

    return walk(cache_tree)
