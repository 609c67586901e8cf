"""PyTorch port, kernel K1 (flash attention): the port's ``mha`` against the
JAX ``mha`` running the Pallas kernel in interpret mode, at the shapes of
``tests/test_kernels.py``.  On CPU tensors ``mha`` takes its plain version;
the hand-written CUDA kernel is held against that plain version on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import mha

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's shapes, then head dim 192 (nemotron-4-340b)
SWEEP = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 1, 128),
         (2, 192, 6, 3, 32), (1, 128, 4, 2, 128), (1, 128, 4, 2, 192)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(B, S, H, K, hd, T=None):
    T = S if T is None else T
    return (RNG.normal(size=(B, S, H, hd)).astype(np.float32),
            RNG.normal(size=(B, T, K, hd)).astype(np.float32),
            RNG.normal(size=(B, T, K, hd)).astype(np.float32))


def _torch(arrs, dt):
    return [torch.from_numpy(a).to(dt) for a in arrs]


@pytest.mark.parametrize("B,S,H,K,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_matches_jax_kernel(B, S, H, K, hd, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(B, S, H, K, hd)
    ref = jax_mha(*(jnp.asarray(a, jdt) for a in arrs), causal=causal,
                  block_q=64, block_k=64, interpret=True)
    out = mha(*_torch(arrs, tdt), causal=causal, block_q=64, block_k=64)
    assert out.dtype == tdt and out.shape == (B, S, H, hd)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("block_q,block_k", [(32, 32), (64, 128), (128, 64)])
def test_mha_matches_jax_kernel_block_shapes(block_q, block_k):
    arrs = _inputs(1, 256, 4, 2, 64)
    ref = jax_mha(*(jnp.asarray(a) for a in arrs), causal=True,
                  block_q=block_q, block_k=block_k, interpret=True)
    out = mha(*_torch(arrs, torch.float32), causal=True, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_mha_cross_shape_matches_jax_reference():
    """S != T (bidirectional, as cross-attention would call it)."""
    from repro.kernels.flash_attention.ops import mha_ref as jax_mha_ref
    arrs = _inputs(2, 5, 4, 4, 16, T=23)
    out = mha(*_torch(arrs, torch.float32), causal=False)
    ref = jax_mha_ref(*(jnp.asarray(a) for a in arrs), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel's wrapper, which refuses what is not a CUDA tensor."""
    before = fa.flash_attention.launches
    q = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        mha(q, q, q, causal=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)))
    assert fa.flash_attention.launches == before
