"""llama-3.2-vision-90b — 100L backbone with gated cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.  Every 5th layer is a gated cross-attn
layer attending to precomputed image patch embeddings (the vision frontend
is a stub: the batch carries (B, 1600, d_model) patch embeddings).
bf16 optimizer moments (90B-class).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vision",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    moment_dtype="bfloat16",
    microbatches=8,
    remat_policy="full",
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
))
