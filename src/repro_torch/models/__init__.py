from repro_torch.models import common  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    build_decode_step,
    build_decode_step_paged,
    build_prefill_past_step,
    build_prefill_step,
    chunked_xent,
    count_params,
    decode_cache,
    decode_cache_paged,
    full_forward_logits,
    loss_fn,
    model_specs,
    paged_cache_flags,
    paged_support,
)
