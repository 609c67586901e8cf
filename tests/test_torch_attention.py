"""PyTorch port, plain attention path under autograd: ``chunked_attention``
recomputes each query block in backward, as the reference's
``jax.checkpoint`` over its blocks does (``repro/models/attention.py``), so
what autograd keeps is the inputs and outputs, not every block's scores."""
import numpy as np
import pytest
import torch

from repro_torch.models import attention as attn

# B, S, H, K, hd, window, chunk: a recurrentgemma-style local layer
SHAPE = (1, 2048, 4, 1, 64, 512, 256)


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32))
               .requires_grad_() for n in (H, K, K))
    return q, k, v


def _plain_blocks(q, k, v, *, window, chunk):
    """The block loop without recompute: every block's graph stays alive."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    col = torch.arange(S)
    outs = [attn._block_attend(qg[:, s0:s0 + chunk], k, v, torch.arange(s0, s0 + chunk), col,
                               causal=True, window=window, kv_valid=None)
            for s0 in range(0, S, chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def _saved_bytes(fn):
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total


def test_chunked_attention_saves_no_score_matrix_for_backward():
    B, S, H, K, hd, window, chunk = SHAPE
    q, k, v = _inputs(B, S, H, K, hd)
    out, saved = _saved_bytes(lambda: attn.chunked_attention(q, k, v, causal=True,
                                                             window=window, chunk=chunk))
    scores_bytes = B * S * H * S * 4            # one fp32 (B, S, H, T) score matrix
    _, plain_saved = _saved_bytes(lambda: _plain_blocks(q, k, v, window=window, chunk=chunk))
    assert plain_saved > scores_bytes           # what the loop kept before the recompute
    assert saved < scores_bytes, f"{saved / 1e6:.1f} MB saved for backward"

    w = torch.from_numpy(np.random.default_rng(1).normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((_plain_blocks(q, k, v, window=window, chunk=chunk) * w).sum(),
                               (q, k, v))
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"d{name}")


@pytest.mark.parametrize("grad", [True, False])
def test_chunked_attention_output_unchanged_by_recompute(grad):
    """The same numbers with and without autograd, and as the block loop."""
    q, k, v = _inputs(2, 96, 4, 2, 16, seed=3)
    with torch.set_grad_enabled(grad):
        out = attn.chunked_attention(q, k, v, causal=True, window=40, chunk=32)
    with torch.no_grad():
        want = _plain_blocks(q, k, v, window=40, chunk=32)
    assert out.requires_grad == grad
    torch.testing.assert_close(out, want, rtol=0, atol=0)
