"""Architecture configuration system (PyTorch port).

A copy of ``repro/configs/base.py`` reduced to what the port's serving and
training paths read: :class:`ArchConfig` and the sub-configs it nests, the registry
(:func:`register` / :func:`get_config`) and :func:`reduced`.  Field names,
defaults and the ``reduced`` overrides are the reference's, so a config
built here describes the same model as its JAX twin; only :attr:`dtype`
differs, returning a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard/DeepSeek style routed experts)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: Optional[int] = None          # defaults to expert_d_ff * shared
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # index of first MoE layer; earlier layers use the dense FFN
    first_moe_layer: int = 1

    @property
    def shared_ff(self) -> int:
        if self.shared_d_ff is not None:
            return self.shared_d_ff
        return self.expert_d_ff * max(self.num_shared_experts, 1)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention settings."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (Griffin/RecurrentGemma) recurrent-block settings."""

    lru_width: int = 4096
    conv_width: int = 4
    # c constant in a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x))
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) time-mix settings."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 64


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtype names are strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | rwkv | hybrid | encdec | vision
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # block pattern, tiled over num_layers (e.g. ("recurrent","recurrent","local_attn"))
    block_pattern: Tuple[str, ...] = ("attn",)
    # FFN activation: "swiglu" | "squared_relu" | "gelu" | "relu_sq_rwkv"
    ffn_activation: str = "swiglu"
    qkv_bias: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    local_window: int = 4096         # for "local_attn" layers
    # sub-quadratic context support: None = quadratic attention (long_500k skips)
    max_context: Optional[int] = 131072
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500       # precomputed frame embeddings (frontend stub)
    # --- vision cross-attention (llama-3.2-vision) ---
    cross_attn_every: int = 0        # every Nth layer is a gated cross-attn layer
    num_image_tokens: int = 1600     # precomputed patch embeddings (frontend stub)
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat_policy: str = "full"       # nothing | dots | full | moe (hillclimb)
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator for giants
    microbatches: int = 1            # gradient-accumulation steps per train step
    attn_chunk: int = 512            # online-softmax query-block size
    xent_chunk: int = 256            # chunked cross-entropy sequence block
    # route attention through the hand-written flash kernel where
    # ``models.attention.chunked_attention``'s gate allows
    use_pallas: bool = False
    source: str = ""                 # provenance note [citation; tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer kind list, tiling ``block_pattern`` to num_layers."""
        pat = self.block_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


ARCH_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  — triggers per-arch module imports

    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU tests (the reference's overrides)."""
    small = dict(
        num_layers=max(len(cfg.block_pattern) * 2, 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_frames=16 if cfg.encoder_layers else 1500,
        cross_attn_every=cfg.cross_attn_every and 2,
        num_image_tokens=8 if cfg.cross_attn_every else 1600,
        local_window=16,
        attn_chunk=16,
        xent_chunk=32,
        microbatches=1,
        moment_dtype="float32",
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, expert_d_ff=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            shared_d_ff=64 if cfg.moe.num_shared_experts else None,
            first_moe_layer=min(cfg.moe.first_moe_layer, 1),
            capacity_factor=8.0,
        )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        small["head_dim"] = None
    if cfg.recurrent is not None:
        small["recurrent"] = RecurrentConfig(lru_width=64, conv_width=4, c=8.0)
    if cfg.rwkv is not None:
        small["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8, gate_lora=8)
        small["num_heads"] = 4
        small["head_dim"] = 16
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
