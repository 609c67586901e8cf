"""command-r-35b — dense GQA, no-bias, LayerNorm.

[hf:CohereForAI/c4ai-command-r-v01; unverified]  40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000.  (The HF model uses a parallel
attn+FFN block; the assignment line specifies only "GQA, no-bias", so the
standard sequential pre-norm block is used — noted here for provenance.)
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    qkv_bias=False,
    tie_embeddings=True,
    microbatches=4,
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
))
