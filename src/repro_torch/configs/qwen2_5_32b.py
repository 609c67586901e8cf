"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  40 heads over 16-way tensor parallel is non-divisible —
GSPMD pads; the inefficiency shows up in the roofline table (hillclimb axis).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    attn_chunk=256,          # 40 heads replicated over model axis — keep score blocks small
    microbatches=4,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
))
