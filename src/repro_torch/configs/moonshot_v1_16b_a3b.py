"""moonshot-v1-16b-a3b — Moonlight-16B-A3B MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 vocab=163840, MoE 64e top-6.  DeepSeek-V3-family MoE: 2 shared
experts, first layer dense (dense d_ff = 11264).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,                      # dense first-layer FFN (8/3 * d scaled)
    vocab_size=163840,
    microbatches=4,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=2816, first_moe_layer=1),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
))
