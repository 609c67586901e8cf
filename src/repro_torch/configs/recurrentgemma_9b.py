"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  Block pattern (recurrent, recurrent, local_attn); local window
2048.  Bounded decode state (LRU state + window KV) → long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig, RecurrentConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("recurrent", "recurrent", "local_attn"),
    ffn_activation="gelu",           # GeGLU in the paper; gated gelu implemented
    local_window=2048,
    max_context=None,                # bounded state: LRU + 2048-window KV
    microbatches=4,
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4, c=8.0),
    source="[arXiv:2402.19427; unverified]",
))
