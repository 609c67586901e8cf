from repro_torch.training.optimizer import AdamWConfig, OptState, apply_updates, init_opt_state  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    TrainState,
    build_train_step,
    init_train_state,
)
from repro_torch.training.runner import FleetReport, FleetRunner  # noqa: F401
