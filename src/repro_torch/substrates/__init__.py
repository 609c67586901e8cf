from repro_torch.substrates.base import SubstrateAdapter, timed  # noqa: F401
from repro_torch.substrates.gpu_node import (  # noqa: F401
    GpuNodeSubstrate,
    RooflineSurrogate,
    load_dryrun_record,
)
from repro_torch.substrates.lm_serving import LmServingAdapter, ServingSurrogate  # noqa: F401
