"""Distributed layer of the port: sharding recipes, the sharding context
and the explicit-collective blocks (ROADMAP A9.1).  The MoE and MLA blocks
and the recurrent, rwkv and encoder paths under a context are A9.2."""
from repro_torch.distributed.sharding import (  # noqa: F401
    RECIPES,
    NamedSharding,
    ShardingRecipe,
    batch_sharding,
    cache_shardings,
    param_shardings,
    spec_for_axes,
)
