"""deepseek-v2-236b — MLA (kv_lora=512) + MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff=1536(MoE) vocab=102400.
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
First layer dense FFN d_ff=12288. bf16 optimizer moments so the 256-chip
single-pod HBM budget holds (DESIGN.md §5.4).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,                # MLA: latent-compressed, heads share kv_lora cache
    d_ff=12288,                      # dense first-layer FFN
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  num_shared_experts=2, shared_d_ff=3072, first_moe_layer=1),
    moment_dtype="bfloat16",
    microbatches=8,
    remat_policy="full",
    grad_accum_dtype="bfloat16",
    source="[arXiv:2405.04434; hf]",
))
