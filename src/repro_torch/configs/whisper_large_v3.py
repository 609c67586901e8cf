"""whisper-large-v3 — encoder-decoder audio backbone (frontend stubbed).

[arXiv:2212.04356; unverified]  32L enc + 32L dec, d_model=1280 20H d_ff=5120
vocab=51866.  Conv/audio frontend is a STUB per assignment: ``input_specs()``
provides precomputed frame embeddings (1500, d_model).  LayerNorm, GELU FFN,
learned-positional behaviour approximated with RoPE-free absolute embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,                   # decoder layers
    encoder_layers=32,
    encoder_frames=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    ffn_activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    max_context=65536,               # decoder is quadratic attention → long_500k skipped
    source="[arXiv:2212.04356; unverified]",
))
