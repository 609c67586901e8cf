from repro_torch.models import common  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    build_decode_step,
    build_prefill_step,
    decode_cache,
    full_forward_logits,
    model_specs,
)
