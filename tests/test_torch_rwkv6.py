"""PyTorch port, kernel K3 (RWKV-6 chunked scan) and the rwkv6 model blocks
against the JAX package on the same numpy inputs.

The JAX ``time_mix_scan`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  On CPU tensors the port's ``time_mix_scan``
takes its plain chunked version; the hand-written CUDA kernel is held
against the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Kernel tolerances are ``test_rwkv6_kernel_sweep``'s: the
largest difference relative to the largest output, 1e-5 fp32 and 2e-2 bf16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.rwkv6.ops import time_mix_scan as jax_time_mix_scan
from repro.models import ffn as jffn
from repro.models import rwkv6 as jrwkv
from repro.models.common import init_params as jax_init_params
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.autodiff import kernel_with_ref_vjp
from repro_torch.kernels.rwkv6 import rwkv6_scan as k3
from repro_torch.kernels.rwkv6.ops import time_mix_chunked, time_mix_ref, time_mix_scan
from repro_torch.kernels.rwkv6.ref import rwkv6_subchunked
from repro_torch.models import ffn
from repro_torch.models import rwkv6
from repro_torch.weights import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py::test_rwkv6_kernel_sweep
SWEEP = [(1, 64, 2, 32, 32), (2, 128, 4, 64, 32), (1, 256, 2, 16, 64)]
PORT = {
    "ref": lambda r, k, v, lw, u, chunk: time_mix_ref(r, k, v, lw, u),
    "chunked": lambda r, k, v, lw, u, chunk: time_mix_chunked(r, k, v, lw, u, chunk=chunk),
    "scan": lambda r, k, v, lw, u, chunk: time_mix_scan(r, k, v, lw, u, chunk=chunk),
}


def _limit(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def _rel_err(out, ref):
    out, ref = (np.asarray(a, np.float32) for a in (out, ref))
    return float(np.max(np.abs(out - ref))) / (float(np.max(np.abs(ref))) + 1e-6)


def _inputs(B, S, H, hd, seed, lw_low=0.01, lw_high=4.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    # log-decay <= 0, down to -4: the overflow-prone regime of the pairwise exponent
    lw = -rng.uniform(lw_low, lw_high, size=(B, S, H, hd)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    return r, k, v, lw, u


def _torch(arrs, dt):
    r, k, v, lw, u = arrs
    return ([torch.from_numpy(a).to(dt) for a in (r, k, v)]
            + [torch.from_numpy(lw), torch.from_numpy(u)])


def _jax(arrs, dt):
    r, k, v, lw, u = arrs
    return [jnp.asarray(a, dt) for a in (r, k, v)] + [jnp.asarray(lw), jnp.asarray(u)]


@functools.lru_cache(maxsize=None)
def _jax_scan(shape, dtype, chunk):
    """JAX ``time_mix_scan`` (Pallas, interpret mode) on ``_inputs(*shape)``."""
    arrs = _inputs(*shape, seed=sum(shape))
    return arrs, np.asarray(jax_time_mix_scan(*_jax(arrs, DTYPES[dtype][0]), chunk=chunk,
                                              interpret=True), np.float32)


@pytest.mark.parametrize("impl", sorted(PORT))
@pytest.mark.parametrize("B,S,H,hd,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_scan_matches_jax_kernel(impl, B, S, H, hd, chunk, dtype):
    arrs, ref = _jax_scan((B, S, H, hd), dtype, chunk)
    out = PORT[impl](*_torch(arrs, DTYPES[dtype][1]), chunk)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, S, H, hd)
    err = _rel_err(out.float().numpy(), ref)
    assert err < _limit(dtype), (impl, err)


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scan_state_continuity_matches_jax(chunk, dtype):
    """Chunk boundaries are invisible: the port at chunk 32 or 128 against
    the JAX kernel at chunk 128 (``test_rwkv6_state_continuity``'s shape)."""
    arrs = _inputs(1, 128, 2, 32, seed=7, lw_low=0.05, lw_high=1.0)
    ref = jax_time_mix_scan(*_jax(arrs, DTYPES[dtype][0]), chunk=128, interpret=True)
    out = time_mix_scan(*_torch(arrs, DTYPES[dtype][1]), chunk=chunk)
    assert _rel_err(out.float().numpy(), ref) < _limit(dtype)


def test_scan_grads_match_jax():
    """Backward: the port's chunked recompute against JAX's vjp, which goes
    through the sequential oracle ``rwkv6_ref``."""
    arrs = _inputs(1, 64, 2, 16, seed=3)
    w = np.random.default_rng(4).normal(size=(1, 64, 2, 16)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jax_time_mix_scan(*a, chunk=32) * w),
                  argnums=(0, 1, 2, 3, 4))(*_jax(arrs, jnp.float32))
    ts = [t.requires_grad_() for t in _torch(arrs, torch.float32)]
    tg = torch.autograd.grad((time_mix_scan(*ts, chunk=32) * torch.from_numpy(w)).sum(), ts)
    for name, a, b in zip("r k v lw u".split(), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


def _subchunked(r, k, v, lw, u, chunk, sub):
    """``rwkv6_subchunked`` in the model layout."""
    t = [x.transpose(1, 2) for x in (r, k, v, lw)]
    return rwkv6_subchunked(*t, u, chunk=chunk, sub=sub).transpose(1, 2)


@pytest.mark.parametrize("sub", [16, 8])
@pytest.mark.parametrize("B,S,H,hd,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_subchunked_matches_jax_kernel(sub, B, S, H, hd, chunk, dtype):
    """K3's arithmetic (the pairwise decay factored across sub-chunks)
    against the JAX kernel in interpret mode, at the sweep's limits."""
    arrs, ref = _jax_scan((B, S, H, hd), dtype, chunk)
    out = _subchunked(*_torch(arrs, DTYPES[dtype][1]), chunk, sub)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, S, H, hd)
    assert _rel_err(out.float().numpy(), ref) < _limit(dtype)


def _ref64(r, k, v, lw, u):
    """The sequential recurrence in float64 (model layout, numpy)."""
    B, S, H, hd = r.shape
    state = np.zeros((B, H, hd, hd))
    y = np.zeros((B, S, H, hd))
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = np.einsum("bhd,bhde->bhe", r[:, t], state + u[None, :, :, None] * kv)
        state = state * np.exp(lw[:, t])[..., None] + kv
    return y


# Each limit is the plain chunked form's own fp32 error against float64 at
# that decay (relative to the largest output): lw in [-30, -0.01] reaches
# 1.9e-5 at chunk 32 and 6.2e-5 at chunk 128 on these inputs, where the fp32
# prefix sum of lw sets the error and the factoring adds nothing (the
# sub-chunked form errs the same); lw = -4 everywhere and lw in [-1e-3, 0]
# stay below 1e-6.
@pytest.mark.parametrize("decay,chunk,sub,limit", [
    ("[-30, -0.01]", 32, 16, 1e-4), ("[-30, -0.01]", 32, 8, 1e-4),
    ("[-30, -0.01]", 128, 16, 1e-4), ("[-30, -0.01]", 128, 8, 1e-4),
    ("-4", 32, 16, 1e-5), ("-4", 128, 8, 1e-5),
    ("[-1e-3, 0]", 32, 16, 1e-5), ("[-1e-3, 0]", 128, 8, 1e-5)])
def test_subchunked_matches_float64_at_extreme_decay(decay, chunk, sub, limit):
    rng = np.random.default_rng(11)
    shape = (2, 256, 3, 64)
    r, k, v = (rng.normal(size=shape) for _ in range(3))
    lw = {"[-30, -0.01]": -rng.uniform(0.01, 30.0, size=shape), "-4": np.full(shape, -4.0),
          "[-1e-3, 0]": -rng.uniform(0.0, 1e-3, size=shape)}[decay]
    u = rng.normal(size=(3, 64))
    ref = _ref64(r, k, v, lw, u)
    out = _subchunked(*(torch.from_numpy(a).float() for a in (r, k, v, lw, u)), chunk, sub)
    assert torch.isfinite(out).all()
    assert _rel_err(out.numpy(), ref) < limit


def test_kernel_with_ref_vjp_forwards_kernel_and_backprops_ref():
    """The autograd Function: forward is the kernel's output (here a stand-in
    that differs from the plain version by a constant), backward is the plain
    version's vjp, and inputs that need no grad get none."""
    ref = lambda a, b: torch.sin(a) * b
    op = kernel_with_ref_vjp(lambda a, b: ref(a, b) + 1.0, ref)
    a = torch.randn(5, requires_grad=True)
    b = torch.randn(5)
    y = op(a, b)
    assert torch.allclose(y, ref(a, b) + 1.0)
    (ga,) = torch.autograd.grad(y.sum(), [a])
    assert torch.allclose(ga, torch.cos(a) * b)
    with torch.no_grad():
        assert op(a, b).grad_fn is None


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """No fallback: the CUDA wrapper raises on CPU tensors; the public op
    takes the plain version only for CPU tensors, and refuses a ragged chunk."""
    r, k, v, lw, u = _torch(_inputs(1, 64, 2, 16, seed=1), torch.float32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        k3.rwkv6_scan(r, k, v, lw, u, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        time_mix_scan(r, k, v, lw, u, chunk=48)
    assert k3.smem_bytes(64, torch.bfloat16) == 111_152   # > 48 KB: the dynamic attribute
    assert k3.smem_bytes(64, torch.float32) <= k3.MAX_SMEM  # every chunk: tiles of <= 32 tokens


def _rwkv_configs(use_pallas):
    return (jax_reduced(jax_get_config("rwkv6-7b"), use_pallas=use_pallas),
            reduced(get_config("rwkv6-7b"), use_pallas=use_pallas))


def _layer_params(jcfg, specs_fn, seed):
    jp = jax_init_params(specs_fn(jcfg), seed=seed)
    return jp, params_from_jax(_flatten(jp), device="cpu")


@pytest.mark.parametrize("use_pallas,want_state,cont", [
    (False, True, False), (True, False, False), (True, True, False), (False, True, True)])
def test_rwkv_time_mix_matches_jax(use_pallas, want_state, cont):
    """Output, final state and last token; ``cont`` continues from a cached
    token and state (the prefill-continuation branch)."""
    jcfg, tcfg = _rwkv_configs(use_pallas)
    jp, tp = _layer_params(jcfg, jrwkv.rwkv_specs, seed=11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if cont:
        xp = rng.normal(size=(2, 64)).astype(np.float32)
        st = (0.1 * rng.normal(size=(2, 4, 16, 16))).astype(np.float32)
        kw_j = dict(x_prev=jnp.asarray(xp), state=jnp.asarray(st))
        kw_t = dict(x_prev=torch.from_numpy(xp), state=torch.from_numpy(st))
    jo, js, jl = jrwkv.rwkv_time_mix(jcfg, jp, jnp.asarray(x), want_state=want_state, **kw_j)
    to, ts, tl = rwkv6.rwkv_time_mix(tcfg, tp, torch.from_numpy(x), want_state=want_state,
                                     **kw_t)
    # outputs and states reach O(1e2): fp32 rounding in another summation order
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("S", [64, 40, 20])
def test_chunk_scan_matches_jax_at_ragged_lengths(S):
    """The model's chunk choice: 32, or one chunk of S < 32; at S = 40 the
    port runs a chunk of 32 and one of 8 where the reference runs 40 chunks
    of one token (ROADMAP C)."""
    r, k, v, lw, u = _inputs(1, S, 2, 16, seed=S, lw_high=1.0)
    st = (0.1 * np.random.default_rng(S).normal(size=(1, 2, 16, 16))).astype(np.float32)
    jy, js = jrwkv._chunk_scan(*map(jnp.asarray, (r, k, v, lw, u, st)))
    ty, ts = rwkv6._chunk_scan(*map(torch.from_numpy, (r, k, v, lw, u, st)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


def test_rwkv_channel_mix_matches_jax():
    jcfg, tcfg = _rwkv_configs(False)
    jp, tp = _layer_params(jcfg, jffn.rwkv_channel_mix_specs, seed=13)
    rng = np.random.default_rng(14)
    x, xp = (rng.normal(size=(2, 16, 64)).astype(np.float32) for _ in range(2))
    ref = jffn.rwkv_channel_mix(jcfg, jp, jnp.asarray(x), jnp.asarray(xp))
    out = ffn.rwkv_channel_mix(tcfg, tp, torch.from_numpy(x), torch.from_numpy(xp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
