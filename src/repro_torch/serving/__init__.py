from repro_torch.serving.cache_utils import (  # noqa: F401
    extend_cache,
    gather_pages,
    write_prefill_paged,
    write_slots,
)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.kv_pages import PagePool, PoolExhausted, PrefixCache  # noqa: F401
