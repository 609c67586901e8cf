"""rwkv6-7b — RWKV-6 "Finch", attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536.
Attention-free: O(1) decode state per layer → long_500k RUNS (max_context=None).
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    num_layers=32,
    d_model=4096,
    num_heads=64,                    # 4096 / head_dim 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    ffn_activation="relu_sq_rwkv",   # RWKV channel-mix: relu(x)^2 gated by receptance
    norm="layernorm",
    max_context=None,                # attention-free: unbounded context
    microbatches=4,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
    source="[arXiv:2404.05892; hf]",
))
