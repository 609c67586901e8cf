"""Architecture configs of the port. Importing this package registers them."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    RecurrentConfig,
    RWKVConfig,
    get_config,
    reduced,
    register,
    torch_dtype,
)

# one module per ported architecture — import order is alphabetical
from repro_torch.configs import command_r_35b  # noqa: F401,E402
from repro_torch.configs import deepseek_v2_236b  # noqa: F401,E402
from repro_torch.configs import internlm2_20b  # noqa: F401,E402
from repro_torch.configs import llama_3_2_vision_90b  # noqa: F401,E402
from repro_torch.configs import moonshot_v1_16b_a3b  # noqa: F401,E402
from repro_torch.configs import nemotron_4_340b  # noqa: F401,E402
from repro_torch.configs import qwen2_5_32b  # noqa: F401,E402
from repro_torch.configs import recurrentgemma_9b  # noqa: F401,E402
from repro_torch.configs import rwkv6_7b  # noqa: F401,E402
from repro_torch.configs import whisper_large_v3  # noqa: F401,E402
