"""nemotron-4-340b — dense GQA with squared-ReLU FFN.

[arXiv:2402.16819; unverified]  96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  Squared-ReLU MLP (no gating).  bf16 optimizer moments are
mandatory at this size for the single-pod HBM budget (DESIGN.md §5.4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    ffn_activation="squared_relu",
    norm="layernorm",
    moment_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    microbatches=8,
    remat_policy="full",
    source="[arXiv:2402.16819; unverified]",
))
