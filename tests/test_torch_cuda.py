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
from repro_torch.kernels.rglru import rglru_scan as k2
from repro_torch.kernels.rglru.ops import linear_recurrence
from repro_torch.kernels.rglru.ref import rglru_ref, rglru_sequential
from repro_torch.kernels.rwkv6 import rwkv6_scan as k3
from repro_torch.kernels.rwkv6.ops import time_mix_chunked, time_mix_ref, time_mix_scan
from repro_torch.kernels.rwkv6.ref import rwkv6_subchunked

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's flash sweep, the whisper-large-v3 encoder shape,
# head dim 16, head dim 192 (nemotron-4-340b), and ragged S and T at head
# dim 128 (TMA's zero fill and the column mask)
SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 1, 128),
          (2, 192, 6, 3, 32), (1, 128, 4, 2, 128), (1, 1500, 20, 20, 64),
          (3, 70, 4, 2, 16), (1, 256, 4, 2, 192), (2, 333, 8, 2, 128)]


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


def test_flash_kernel_gradient_matches_plain(card):
    """``mha`` on the card: kernel forward, ``mha_ref`` backward, against
    autograd through ``mha_ref`` alone."""
    for dtype, tol in (("float32", dict(rtol=1e-3, atol=1e-4)),
                       ("bfloat16", dict(rtol=2e-2, atol=2e-2))):
        gen = torch.Generator(device=card).manual_seed(5)
        q, k, v = (torch.randn((2, 256, 8 if i == 0 else 2, 64), generator=gen, device=card)
                   .to(DTYPES[dtype]).requires_grad_() for i in range(3))
        w = torch.randn((2, 256, 8, 64), generator=gen, device=card).to(DTYPES[dtype])
        before = fa.flash_attention.launches
        out = mha(q, k, v, causal=True)
        assert out.grad_fn is not None and fa.flash_attention.launches == before + 1
        got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
        want = torch.autograd.grad((mha_ref(q, k, v, causal=True).float() * w.float()).sum(),
                                   (q, k, v))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       err_msg=f"{dtype} d{name}", **tol)


# tests/test_kernels.py::test_rwkv6_kernel_sweep, then the rwkv6-7b layer at B=1
RWKV_SHAPES = [(1, 64, 2, 32, 32), (2, 128, 4, 64, 32), (1, 256, 2, 16, 64),
               (1, 512, 64, 64, 32)]


def _rwkv_inputs(card, B, S, H, hd, dtype, seed, lw_high=4.0):
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=card).to(dtype)
               for _ in range(3))
    # log-decay in [-lw_high, -0.01]: strong decay included
    lw = -(0.01 + (lw_high - 0.01) * torch.rand((B, S, H, hd), generator=gen, device=card))
    u = torch.randn((H, hd), generator=gen, device=card)
    return r, k, v, lw, u


def _rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / (ref.abs().max() + 1e-6)).item()


@pytest.mark.parametrize("B,S,H,hd,chunk", RWKV_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_matches_plain(card, B, S, H, hd, chunk, dtype):
    """K3 against the sequential oracle, limits of the JAX sweep (the
    largest difference relative to the largest output)."""
    args = _rwkv_inputs(card, B, S, H, hd, DTYPES[dtype], seed=S + H)
    before = k3.rwkv6_scan.launches
    out = time_mix_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert k3.rwkv6_scan.launches == before + 1
    assert out.dtype == DTYPES[dtype] and out.shape == (B, S, H, hd)
    assert _rel_err(out, time_mix_ref(*args)) < (2e-2 if dtype == "bfloat16" else 1e-5)


def test_rwkv6_kernel_state_continuity(card):
    """Chunk boundaries are invisible: chunk 32 equals chunk 128."""
    args = _rwkv_inputs(card, 1, 128, 2, 32, torch.float32, seed=7, lw_high=1.0)
    o32, o128 = time_mix_scan(*args, chunk=32), time_mix_scan(*args, chunk=128)
    assert _rel_err(o32, o128) < 1e-5
    assert _rel_err(o128, time_mix_ref(*args)) < 1e-5


def test_rwkv6_kernel_reads_strided_views(card):
    """r, k, v as views of one fused (B, S, 3, H, hd) projection: no copies."""
    rkv = torch.randn((2, 64, 3, 4, 16), device=card, dtype=torch.bfloat16)
    r, k, v = rkv.unbind(2)
    _, _, _, lw, u = _rwkv_inputs(card, 2, 64, 4, 16, torch.bfloat16, seed=3)
    out = k3.rwkv6_scan(r, k, v, lw, u, chunk=32)
    assert _rel_err(out, time_mix_chunked(r, k, v, lw, u, chunk=32)) < 2e-2


def test_rwkv6_kernel_gradient_matches_plain(card):
    """``time_mix_scan`` on the card: K3 forward, chunked plain backward."""
    args = [t.requires_grad_() for t in _rwkv_inputs(card, 1, 128, 4, 64, torch.float32, 9)]
    w = torch.randn((1, 128, 4, 64), device=card)
    got = torch.autograd.grad((time_mix_scan(*args) * w).sum(), args)
    want = torch.autograd.grad((time_mix_ref(*args) * w).sum(), args)
    for name, a, b in zip("r k v lw u".split(), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def _subchunked(r, k, v, lw, u, chunk, sub=16):
    """``rwkv6_subchunked`` in the model layout."""
    t = [x.transpose(1, 2) for x in (r, k, v, lw)]
    return rwkv6_subchunked(*t, u, chunk=chunk, sub=sub).transpose(1, 2)


# K3 tiles a chunk longer than 32 tokens by its largest divisor up to 32, and
# pads a tile to a multiple of 16 rows: chunks 128, 48 and 24 exercise both
@pytest.mark.parametrize("dtype,chunk", [("float32", 32), ("bfloat16", 32), ("float32", 128),
                                         ("float32", 48), ("bfloat16", 24)])
def test_rwkv6_kernel_extreme_decay(card, dtype, chunk):
    """lw in [-30, -0.01]: both factors of the sub-chunk split stay <= 1.
    Limit 1e-4 in fp32: the plain chunked form itself is about 2e-5 (chunk
    32) to 6e-5 (chunk 128) from a float64 oracle there
    (``tests/test_torch_rwkv6.py``); 2e-2 in bf16."""
    args = _rwkv_inputs(card, 1, 384, 3, 64, DTYPES[dtype], seed=21, lw_high=30.0)
    out = time_mix_scan(*args, chunk=chunk)
    limit = 2e-2 if dtype == "bfloat16" else 1e-4
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, time_mix_ref(*args)) < limit
    assert _rel_err(out, _subchunked(*args, chunk=chunk)) < limit


def test_rwkv6_kernel_chunk_128_hd64_bf16(card):
    args = _rwkv_inputs(card, 2, 512, 4, 64, torch.bfloat16, seed=22)
    out = time_mix_scan(*args, chunk=128)
    assert _rel_err(out, time_mix_ref(*args)) < 2e-2
    assert _rel_err(out, _subchunked(*args, chunk=128, sub=8)) < 2e-2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_many_chunks(card, dtype):
    """S = 4096: 128 tiles carry the state through the prefetched stage
    buffers in turn."""
    args = _rwkv_inputs(card, 1, 4096, 2, 64, DTYPES[dtype], seed=23)
    out = time_mix_scan(*args)
    assert _rel_err(out, time_mix_ref(*args)) < (2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("case", ["hd stride", "offset"])
def test_rwkv6_kernel_reads_unaligned_views(card, case):
    """Views the 16-byte copies cannot take (hd stride 2; rows one element
    off 16-byte alignment) go through plain loads."""
    B, S, H, hd = 2, 96, 3, 32
    _, _, _, lw, u = _rwkv_inputs(card, B, S, H, hd, torch.float32, seed=24)
    gen = torch.Generator(device=card).manual_seed(25)
    if case == "hd stride":
        base = torch.randn((3, B, S, H, 2 * hd), generator=gen, device=card)[..., ::2]
    else:
        base = torch.randn((3, B, S, H, hd + 1), generator=gen, device=card)[..., 1:]
    r, k, v = base.unbind(0)
    out = k3.rwkv6_scan(r, k, v, lw, u, chunk=32)
    assert _rel_err(out, time_mix_ref(r, k, v, lw, u)) < 1e-5


@pytest.mark.parametrize("case", ["hd", "ragged", "dtype", "device"])
def test_rwkv6_kernel_refuses_what_it_does_not_take(card, case):
    r, k, v, lw, u = _rwkv_inputs(card, 1, 64, 2, 128 if case == "hd" else 32,
                                  torch.float32, seed=1)
    if case == "dtype":
        lw = lw.to(torch.bfloat16)
    if case == "device":
        u = u.cpu()
    with pytest.raises(ValueError):
        k3.rwkv6_scan(r, k, v, lw, u, chunk=48 if case == "ragged" else 32)


# tests/test_kernels.py::test_rglru_kernel_sweep (B, S, W), a ragged width and
# length, then one recurrentgemma-9b serving prefill and the training shape
RGLRU_SHAPES = [(1, 128, 128), (2, 256, 256), (1, 512, 384), (3, 100, 72), (1, 2112, 4096),
                (2, 4096, 4096)]


def _rglru_inputs(card, B, S, W, dtype, seed):
    """The sweep's distributions: a ~ U(0.2, 0.999), b ~ N(0, 1)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    a = 0.2 + 0.799 * torch.rand((B, S, W), generator=gen, device=card)
    b = torch.randn((B, S, W), generator=gen, device=card)
    return a.to(dtype), b.to(dtype)


@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_matches_plain(card, B, S, W, dtype):
    """K2 against ``rglru_ref`` at the sweep's 1e-4 (fp32), 2e-2 (bf16
    output rounding); the time loop too at the small shapes."""
    a, b = _rglru_inputs(card, B, S, W, DTYPES[dtype], seed=S + W)
    before = k2.rglru_scan.launches
    out = k2.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert k2.rglru_scan.launches == before + 1
    assert out.dtype == DTYPES[dtype] and out.shape == (B, S, W)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    refs = [rglru_ref(a, b)] + ([rglru_sequential(a, b)] if S * W <= 512 * 384 else [])
    for ref in refs:
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **tol)


def test_rglru_kernel_reads_strided_views(card):
    """a and b as views of one (B, S, 2, W) tensor: strided time axes."""
    ab = 0.2 + 0.799 * torch.rand((2, 192, 2, 160), device=card)
    a, b = ab.unbind(2)
    np.testing.assert_allclose(k2.rglru_scan(a, b).cpu().numpy(), rglru_ref(a, b).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_rglru_kernel_gradient_matches_plain(card):
    """``linear_recurrence`` on the card: K2 forward, ``rglru_ref`` backward,
    against autograd through ``rglru_ref`` alone."""
    a, b = (t.requires_grad_() for t in _rglru_inputs(card, 2, 256, 256, torch.float32, 5))
    w = torch.randn((2, 256, 256), device=card)
    before = k2.rglru_scan.launches
    out = linear_recurrence(a, b)
    assert out.grad_fn is not None and k2.rglru_scan.launches == before + 1
    got = torch.autograd.grad((out * w).sum(), (a, b))
    want = torch.autograd.grad((rglru_ref(a, b) * w).sum(), (a, b))
    for name, g, r in zip("ab", got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def _rglru_check(out, a, b, dtype, loop=False):
    """K2's output against ``rglru_ref`` (and the time loop) at the sweep's
    tolerances: 1e-4 in fp32, 2e-2 in bf16 (output rounding)."""
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    for ref in [rglru_ref(a, b)] + ([rglru_sequential(a, b)] if loop else []):
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **tol)


# S below one 64-step chunk, not a multiple of it, and one step past a
# multiple; many chunks at one slab's width, so the 4-stage ring wraps 32 times
@pytest.mark.parametrize("B,S,W", [(2, 1, 256), (2, 63, 256), (1, 4097, 256), (1, 8192, 32)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_chunk_edges(card, B, S, W, dtype):
    a, b = _rglru_inputs(card, B, S, W, DTYPES[dtype], seed=S)
    before = k2.rglru_scan.path_launches["tma"]
    out = k2.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert k2.rglru_scan.path_launches["tma"] == before + 1
    _rglru_check(out, a, b, dtype, loop=S <= 63)


@pytest.mark.parametrize("B,S,W", [(3, 100, 72), (1, 2112, 4096)])
@pytest.mark.parametrize("path", ["tma", "loads"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_rounds_as_the_time_loop(card, B, S, W, path, dtype):
    """Each step rounds the product, then the sum, as the TPU kernel and the
    decode step do: K2 equals the time loop ``rglru_sequential`` bit for bit,
    on both paths (fp32 state; bf16 rounds only the stored h)."""
    a, b = _rglru_inputs(card, B, S, W, DTYPES[dtype], seed=B + S)
    if path == "loads":                              # one element off: no TMA
        b = torch.cat([b[..., :1], b], dim=-1)[..., 1:]
    assert k2.path_for(a, b) == path
    assert torch.equal(k2.rglru_scan(a, b), rglru_sequential(a, b))


def test_rglru_kernel_running_sum(card):
    """a = 1 everywhere: h is the running sum of b, against a float64 cumsum
    within 1e-4 of its largest value."""
    gen = torch.Generator(device=card).manual_seed(7)
    b = torch.randn((2, 4096, 128), generator=gen, device=card)
    out = k2.rglru_scan(torch.ones_like(b), b)
    want = b.double().cumsum(1)
    assert ((out.double() - want).abs().max() <= 1e-4 * want.abs().max()).item()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_restarts_where_a_is_zero(card, dtype):
    """a = 0 on a random tenth of the steps: h restarts exactly at b there."""
    a, b = _rglru_inputs(card, 2, 1000, 192, DTYPES[dtype], seed=8)
    gen = torch.Generator(device=card).manual_seed(9)
    zero = torch.rand(a.shape, generator=gen, device=card) < 0.1
    a = a.masked_fill(zero, 0.0)
    out = k2.rglru_scan(a, b)
    assert torch.equal(out[zero], b[zero])
    _rglru_check(out, a, b, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_takes_plain_loads_for_a_view_one_element_off(card, dtype):
    """b = x[..., 1:]: a base TMA cannot take, so the plain loads path."""
    a, _ = _rglru_inputs(card, 2, 300, 160, DTYPES[dtype], seed=10)
    x = torch.randn((2, 300, 161), device=card).to(DTYPES[dtype])
    b = x[..., 1:]
    assert k2.path_for(a, b) == "loads"
    before = dict(k2.rglru_scan.path_launches)
    out = k2.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert k2.rglru_scan.path_launches == {**before, "loads": before["loads"] + 1}
    _rglru_check(out, a, b, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_kernel_takes_tma_for_contiguous_inputs(card, dtype):
    a, b = _rglru_inputs(card, 2, 640, 4096, DTYPES[dtype], seed=11)
    before = dict(k2.rglru_scan.path_launches)
    out = k2.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert k2.rglru_scan.path_launches == {**before, "tma": before["tma"] + 1}
    _rglru_check(out, a, b, dtype)


@pytest.mark.parametrize("case", ["dtype", "mixed", "layout", "device", "shape"])
def test_rglru_kernel_refuses_what_it_does_not_take(card, case):
    a, b = _rglru_inputs(card, 1, 64, 32, torch.float32, seed=1)
    if case == "dtype":
        a, b = a.half(), b.half()
    if case == "mixed":
        b = b.bfloat16()
    if case == "layout":
        a, b = a.transpose(1, 2), b.transpose(1, 2)
    if case == "device":
        b = b.cpu()
    if case == "shape":
        b = b[:, :32]
    with pytest.raises(ValueError):
        k2.rglru_scan(a, b)


def test_paged_engine_matches_contiguous_on_the_card(card):
    """A reduced internlm2-20b (fp32) served on the card: the paged engine,
    with prefix hits and a request growing across page boundaries, gives
    the contiguous engine's greedy tokens; the hits prefill only their
    suffix; after drain no page is held by a request (the prefix cache keeps
    one reference on each page it registered) and after flush none is used."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, ServingEngine

    cfg = reduced(get_config("internlm2-20b"))
    params = init_params(model_specs(cfg), seed=1, device=card)
    rng = np.random.default_rng(3)
    common = rng.integers(1, cfg.vocab_size, 24)
    prompts = [np.concatenate([common, rng.integers(1, cfg.vocab_size, n)]).astype(np.int32)
               for n in (4, 7, 5)]
    prompts += [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (9, 17)]
    max_new = [5, 21, 6, 8, 4]
    paged = ServingEngine(cfg, params, device=card, batch_size=3, max_seq=64, paged=True,
                          page_size=8, pool_pages=48)
    prefilled = []
    paged.on_prefill_ms = lambda n, ms: prefilled.append(n)
    out = {}
    for name, eng in (("paged", paged),
                      ("contiguous", ServingEngine(cfg, params, device=card, batch_size=3,
                                                   max_seq=64))):
        reqs = [eng.submit(Request(f"r{i}", p, max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        eng.drain()
        assert all(r.done for r in reqs)
        out[name] = [r.generated for r in reqs]
    assert out["paged"] == out["contiguous"]
    assert prefilled == [28, 7, 5, 9, 17]            # the two sharers prefill their suffix
    audit = paged.audit_pages()
    assert audit["reserved"] == 0 and audit["used"] == len(paged._prefix) > 0
    assert paged.pool_stats()["prefix_hit_rate"] > 0
    paged.flush()
    assert paged.audit_pages() == {"pool_pages": 48, "used": 0, "free": 48, "reserved": 0}


def _graph_pair(card, arch, batch_size=3, max_seq=64, **kw):
    """A graphed and an eager engine of a reduced config (fp32) on one set
    of parameters."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServingEngine

    cfg = reduced(get_config(arch))
    params = init_params(model_specs(cfg), seed=1, device=card)
    graphed, eager = (ServingEngine(cfg, params, device=card, batch_size=batch_size,
                                    max_seq=max_seq, decode_graphs=g, **kw)
                      for g in (True, False))
    assert graphed.decode_graphs and not eager.decode_graphs
    return cfg, graphed, eager


def _serve(eng, prompts, budgets, tag):
    from repro_torch.serving import Request

    reqs = [eng.submit(Request(f"{tag}{i}", p, max_new_tokens=m))
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    eng.drain()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("arch,paged", [("internlm2-20b", False), ("internlm2-20b", True),
                                        ("whisper-large-v3", False), ("whisper-large-v3", True),
                                        ("recurrentgemma-9b", False)])
def test_graphed_engine_matches_eager(card, arch, paged):
    """The continuous path's decode step as CUDA graphs against the eager
    step on the same parameters and trace: identical greedy tokens, then
    again after ``flush`` (the graphs stay bound to the zeroed cache).
    recurrentgemma-9b holds the warm-up's restore of the recurrent carries."""
    cfg, graphed, eager = _graph_pair(card, arch, paged=paged, page_size=8)
    rng = np.random.default_rng(5)
    for rnd in range(2):
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 12, 9, 30)]
        budgets = [7, 4, 11, 6]
        assert _serve(graphed, prompts, budgets, "g") == _serve(eager, prompts, budgets, "e")
        graphed.flush()
        eager.flush()
    assert graphed.graph_capture_ms and not eager.graph_capture_ms
    assert (None in graphed.graph_capture_ms) == (graphed._pool is None)


def test_graphed_paged_engine_crosses_table_widths(card):
    """Groups whose widest row needs page tables of 1 to 32 pages (the width
    rounds to a power of two past 16 pages, and a row grows a page as it
    decodes across a page boundary): one graph per width, captured on first
    use, and the eager engine's tokens."""
    cfg, graphed, eager = _graph_pair(card, "internlm2-20b", max_seq=256, paged=True,
                                      page_size=8, prefix_sharing=False)
    rng = np.random.default_rng(6)
    # widths 1 then 2; 8 then 16; 16 and 32
    for group, lengths, budgets in (("a", (5,), (12,)), ("b", (40,), (30,)),
                                    ("c", (100, 200, 3), (20, 40, 9))):
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lengths]
        assert (_serve(graphed, prompts, budgets, f"g{group}")
                == _serve(eager, prompts, budgets, f"e{group}"))
    assert {1, 2, 8, 16, 32} <= set(graphed.graph_capture_ms)
    assert graphed.audit_pages()["used"] == 0


def test_graphed_engine_serves_from_a_driver_thread(card):
    """``serve_forever`` on a driver thread (which captures the graph) while
    four threads submit: each request gets the eager engine's tokens."""
    import threading

    from repro_torch.serving import Request

    cfg, graphed, eager = _graph_pair(card, "internlm2-20b", batch_size=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 9, 13, 6, 21, 8, 5, 11)]
    budgets = [5, 9, 3, 12, 6, 4, 8, 7]
    want = _serve(eager, prompts, budgets, "e")
    done = threading.Semaphore(0)
    graphed.on_complete = lambda r: done.release()
    stop = threading.Event()
    driver = threading.Thread(target=graphed.serve_forever, args=(stop,), daemon=True)
    driver.start()
    reqs = [Request(f"t{i}", p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts,
                                                                               budgets))]
    submitters = [threading.Thread(target=lambda rs: [graphed.submit(r) for r in rs],
                                   args=(reqs[i::4],)) for i in range(4)]
    for t in submitters:
        t.start()
    for t in submitters:
        t.join()
    try:
        for _ in reqs:
            assert done.acquire(timeout=120), "the driver did not finish the requests"
    finally:
        stop.set()
        graphed.wake()
        driver.join(timeout=10)
    assert not driver.is_alive()
    assert [r.generated for r in reqs] == want
    assert list(graphed.graph_capture_ms) == [None]


def test_graphed_rwkv_engine_keeps_its_carries_through_the_warm_up(card):
    """rwkv6-7b's state and token shifts are advanced by every decode step:
    the graph's eager warm-up puts them back, so the carries after capture
    are those before it, bit for bit; the graphed engine then gives the
    eager engine's tokens, prompts of 32 and not."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import Request

    cfg, graphed, eager = _graph_pair(card, "rwkv6-7b")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 45, 32)]
    for i, p in enumerate(prompts):
        graphed.submit(Request(f"c{i}", p, max_new_tokens=6))
    with torch.inference_mode():
        graphed._admit_locked()
        carries = {path: t.clone() for path, t in tree_leaves(graphed._cb_cache)
                   if path.rsplit("/", 1)[-1] in ("s", "ts_tm", "ts_cm")}
        assert len(carries) == 3 and all(t.any() for t in carries.values())
        graphed._capture(None, graphed._step_inputs(None))
        after = dict(tree_leaves(graphed._cb_cache))
        assert all(torch.equal(after[path], t) for path, t in carries.items())
    graphed.drain()
    graphed.flush()
    budgets = [7, 4, 11]
    assert _serve(graphed, prompts, budgets, "g") == _serve(eager, prompts, budgets, "e")


@pytest.mark.parametrize("paged", [False, True])
def test_graphed_moe_decode_step_is_bit_equal_to_eager(card, paged):
    """moonshot-v1-16b-a3b (reduced, fp32) at ``capacity_factor=1.25``, so
    that a decode step of three rows drops (token, expert) pairs and dead
    rows compete with live ones for the experts' slots: one step's logits
    through the graph equal the eager step's from the same cache bit for
    bit, and the graphed engine gives the eager engine's tokens (paged, the
    dead rows share the null page: ``write_pool_rows``)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, ServingEngine

    base = reduced(get_config("moonshot-v1-16b-a3b"))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=1.25))
    params = init_params(model_specs(cfg), seed=1, device=card)
    graphed, eager = (ServingEngine(cfg, params, device=card, batch_size=3, max_seq=64,
                                    paged=paged, page_size=8, decode_graphs=g)
                      for g in (True, False))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 12, 9)]
    for i, p in enumerate(prompts):
        graphed.submit(Request(f"m{i}", p, max_new_tokens=6))
    graphed.step()
    with torch.inference_mode():
        live = [s for s in graphed._slots if s.request is not None]
        width = graphed._grow_tables(live) if paged else None
        inputs = graphed._step_inputs(width)
        _, want = graphed._decode(graphed.params, graphed._cb_cache, *inputs)
        want = want.clone()
        graph = graphed._graphs.get(width) or graphed._capture(width, inputs)
        graph[0].replay()
        assert torch.equal(graph[1], want)
    graphed.drain()
    graphed.flush()
    budgets = [7, 4, 11]
    assert _serve(graphed, prompts, budgets, "g") == _serve(eager, prompts, budgets, "e")


@pytest.mark.parametrize("paged", [False, True])
def test_graphed_vision_decode_step_is_bit_equal_to_eager(card, paged):
    """llama-3.2-vision-90b (reduced, fp32, 4 layers) with ``xgate = 0.5``
    and the same seeded image embeddings in every admission of both engines
    (the frontend stub gives zeros, under which a cross layer adds
    nothing): one step's logits through the graph equal the eager step's
    from the same cache bit for bit (the image K/V resident in the cache),
    and the graphed engine gives the eager engine's tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, ServingEngine

    cfg = reduced(get_config("llama-3.2-vision-90b"), num_layers=4)
    params = init_params(model_specs(cfg), seed=1, device=card)
    params["decoder"]["blocks"]["1"]["xgate"].fill_(0.5)
    image = torch.randn((1, cfg.num_image_tokens, cfg.d_model), device=card,
                        generator=torch.Generator(device=card).manual_seed(2))
    graphed, eager = (ServingEngine(cfg, params, device=card, batch_size=3, max_seq=64,
                                    paged=paged, page_size=8, decode_graphs=g)
                      for g in (True, False))
    for eng in (graphed, eager):
        eng._batch_extras = lambda B: {"image_embeds": image.expand(B, -1, -1).contiguous()}
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 12, 9)]
    for i, p in enumerate(prompts):
        graphed.submit(Request(f"v{i}", p, max_new_tokens=6))
    graphed.step()
    with torch.inference_mode():
        live = [s for s in graphed._slots if s.request is not None]
        width = graphed._grow_tables(live) if paged else None
        inputs = graphed._step_inputs(width)
        _, want = graphed._decode(graphed.params, graphed._cb_cache, *inputs)
        want = want.clone()
        graph = graphed._graphs.get(width) or graphed._capture(width, inputs)
        graph[0].replay()
        assert torch.equal(graph[1], want)
    ck = graphed._cb_cache["blocks"]["1"]["ck"]
    assert ck[:, :len(prompts)].abs().max() > 0           # the image K/V are live
    graphed.drain()
    graphed.flush()
    budgets = [7, 4, 11]
    assert _serve(graphed, prompts, budgets, "g") == _serve(eager, prompts, budgets, "e")


def test_mla_paged_decode_matches_contiguous_on_the_card(card):
    """deepseek-v2-236b (reduced, fp32) on the card: the paged engine (MLA
    latents in pool pages, prefix hits, a request growing across pages)
    gives the contiguous engine's greedy tokens, graphed and eager."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServingEngine

    cfg = reduced(get_config("deepseek-v2-236b"))
    params = init_params(model_specs(cfg), seed=1, device=card)
    rng = np.random.default_rng(10)
    common = rng.integers(1, cfg.vocab_size, 24)
    prompts = [np.concatenate([common, rng.integers(1, cfg.vocab_size, n)]).astype(np.int32)
               for n in (4, 7, 5)]
    prompts += [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (9, 17)]
    budgets = [5, 21, 6, 8, 4]
    want = _serve(ServingEngine(cfg, params, device=card, batch_size=3, max_seq=64),
                  prompts, budgets, "c")
    for graphs in (True, False):
        paged = ServingEngine(cfg, params, device=card, batch_size=3, max_seq=64, paged=True,
                              page_size=8, pool_pages=48, decode_graphs=graphs)
        prefilled = []
        paged.on_prefill_ms = lambda n, ms: prefilled.append(n)
        assert _serve(paged, prompts, budgets, "p") == want
        assert prefilled == [28, 7, 5, 9, 17]
        assert paged.audit_pages()["reserved"] == 0


def _adapter_cycle(card, cfg):
    """Prepare, serve one request and close an ``LmServingAdapter``; return
    a weak reference to its engine and the memory the caller still holds."""
    import types
    import weakref

    from repro_torch.substrates import LmServingAdapter

    adapter = LmServingAdapter(cfg.name, cfg=cfg, batch_size=8, max_seq=4096, device=card)
    adapter.prepare(None)
    raw = adapter.invoke(types.SimpleNamespace(task=types.SimpleNamespace(
        task_id="t", payload={"prompt": list(range(1, 40)), "max_new_tokens": 6},
        latency_budget_ms=None)))
    assert len(raw["output"]["tokens"]) == 6
    engine = weakref.ref(adapter.engine)
    adapter.close()
    del adapter
    torch.cuda.synchronize()
    return engine


def test_closed_adapter_frees_the_card_without_the_cycle_collector(card):
    """ROADMAP C6 on the card: internlm2-20b's layout at 1024 wide, its
    fp32 decode cache for 8 x 4096 tokens (537 MB), served and closed; with
    the cycle collector off, the engine is gone and the memory is back
    within 64 MiB of where it was.  A first cycle warms what the process
    keeps (cuBLAS workspaces of the driver thread's streams)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config, reduced

    cfg = dataclasses.replace(reduced(get_config("internlm2-20b")), d_model=1024, num_heads=8,
                              num_kv_heads=8, head_dim=128, d_ff=2048)
    _adapter_cycle(card, cfg)
    before = torch.cuda.memory_allocated()
    enabled = gc.isenabled()
    gc.disable()
    try:
        engine = _adapter_cycle(card, cfg)
        assert engine() is None
        assert torch.cuda.memory_allocated() <= before + (64 << 20)
    finally:
        if enabled:
            gc.enable()


def test_gpu_node_substrate_trains_on_the_card(card):
    """``GpuNodeSubstrate`` at the reduced rwkv6-7b with ``use_pallas``:
    ``prepare``'s warm-up and two invokes of two steps on the card, K3
    launched twice per layer and step (``remat_policy="full"`` recomputes
    the forward), each invoke's loss within 5e-3 of a CPU substrate's from
    the same parameters (the plain chunked scan)."""
    import types

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.substrates import GpuNodeSubstrate

    cfg = reduced(get_config("rwkv6-7b"), use_pallas=True)
    params = init_params(model_specs(cfg), seed=2, device="cpu")
    subs = [GpuNodeSubstrate(cfg.name, cfg=cfg, params=params, device=dev, batch=2, seq=64)
            for dev in (card, "cpu")]
    before = k3.rwkv6_scan.launches
    for sub in subs:
        sub.prepare(None)
    per_step = cfg.num_layers * 2
    assert k3.rwkv6_scan.launches - before == per_step
    for i in range(2):
        session = types.SimpleNamespace(task=types.SimpleNamespace(payload={"steps": 2}))
        before = k3.rwkv6_scan.launches
        got, want = (sub.invoke(session) for sub in subs)
        assert k3.rwkv6_scan.launches - before == 2 * per_step
        assert got["output"]["step"] == want["output"]["step"] == 2 * (i + 1)
        assert abs(got["output"]["loss"] - want["output"]["loss"]) < 5e-3
        assert got["telemetry"]["step_ms"] > 0 and got["telemetry"]["health_status"] == "healthy"
    assert subs[0]._state.params["embed"].device.type == "cuda"
