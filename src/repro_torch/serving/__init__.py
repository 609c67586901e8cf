from repro_torch.serving.cache_utils import extend_cache, write_slots  # noqa: F401
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
