"""PyTorch port, hand-written CUDA kernels on the card: each kernel against
its plain PyTorch version on the same CUDA tensors.  The kernels have no CPU
mode, so every test here is ``cuda``-marked and skips without a card.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import mha, mha_ref

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's flash sweep, then the whisper-large-v3 encoder shape
SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 1, 128),
          (2, 192, 6, 3, 32), (1, 128, 4, 2, 128), (1, 1500, 20, 20, 64),
          (3, 70, 4, 2, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    # bf16 inputs: P is rounded to bf16 before P.V; fp32: summation order only
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,H,K,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_kernel_matches_plain(card, B, S, H, K, hd, causal, dtype):
    gen = torch.Generator(device=card).manual_seed(S * H + hd)
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(DTYPES[dtype])
    k, v = (torch.randn((B, S, K, hd), generator=gen, device=card).to(DTYPES[dtype])
            for _ in range(2))
    before = fa.flash_attention.launches
    out = mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = mha_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


def test_flash_kernel_reads_strided_views(card):
    """q/k/v as views of one fused (B, S, 3, H, hd) projection: no copies."""
    qkv = torch.randn((2, 100, 3, 4, 32), device=card, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = mha(q, k, v, causal=True)
    ref = mha_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol("bfloat16"))
