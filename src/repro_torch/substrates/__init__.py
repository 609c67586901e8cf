from repro_torch.substrates.base import SubstrateAdapter, timed  # noqa: F401
from repro_torch.substrates.lm_serving import LmServingAdapter, ServingSurrogate  # noqa: F401
