"""PyTorch port, MLA (``models/mla.py``) and deepseek-v2-236b: the port
against the JAX package on the same parameters (``params_from_jax``) and
numpy inputs, reduced fp32 configs — the absorbed decode (contiguous and
paged), the suffix-only prefill against cached latents, the decode parity
row, and the contiguous and paged engines on the scenarios of
``tests/test_serving_paged.py``.  Tolerances are the repo's: layer outputs
1e-5, logits 2e-3, greedy tokens identical."""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_decode_step as jax_build_decode_step
from repro.models import build_prefill_step as jax_build_prefill_step
from repro.models import decode_cache as jax_decode_cache
from repro.models import mla as jmla
from repro.models import model_specs as jax_model_specs
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.cache_utils import extend_cache as jax_extend_cache
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import (build_decode_step, build_prefill_step, decode_cache,
                                full_forward_logits, paged_cache_flags, paged_support)
from repro_torch.models import mla
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.cache_utils import extend_cache
from repro_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_decode_parity import full_forward_logits as jax_full_forward_logits  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    jparams = jax_init_params(jax_model_specs(jcfg), seed=1)
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


@pytest.fixture(scope="module")
def mixer(pair):
    """The dense first layer's MLA parameters in both packages."""
    jcfg, tcfg, jparams, tparams = pair
    return (jcfg, tcfg, jparams["decoder"]["prefix"]["0"]["mixer"],
            tparams["decoder"]["prefix"]["0"]["mixer"])


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_mla_decode_matches_jax(mixer, per_row):
    """Absorbed decode into a random latent cache, written in place; a
    scalar position or one per row."""
    jcfg, tcfg, jp, tp = mixer
    a = tcfg.mla
    rng = np.random.default_rng(1)
    c0, k0 = _rand(rng, 2, 10, a.kv_lora_rank), _rand(rng, 2, 10, a.qk_rope_head_dim)
    jc = {"c_kv": jnp.asarray(c0), "k_rope": jnp.asarray(k0)}
    tc = {"c_kv": torch.from_numpy(c0.copy()), "k_rope": torch.from_numpy(k0.copy())}
    jdec = jax.jit(functools.partial(jmla.mla_decode, jcfg))
    for pos in ([3, 7], [4, 8], [6, 2]) if per_row else (3, 4, 9):
        x = _rand(rng, 2, 1, tcfg.d_model)
        jy, jc = jdec(jp, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32))
        ty, tc = mla.mla_decode(tcfg, tp, torch.from_numpy(x), tc, torch.tensor(pos))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **LAYER_TOL)


def test_mla_paged_decode_matches_jax(mixer):
    """A pool of 6 pages of 4 (row 0 the null page) read through per-row
    tables of width 3; the new latents land in the rows' write pages."""
    jcfg, tcfg, jp, tp = mixer
    a = tcfg.mla
    rng = np.random.default_rng(2)
    c0, k0 = _rand(rng, 7, 4, a.kv_lora_rank), _rand(rng, 7, 4, a.qk_rope_head_dim)
    tables = np.array([[1, 3, 0], [2, 4, 6]], np.int64)
    jc = {"c_kv": jnp.asarray(c0), "k_rope": jnp.asarray(k0)}
    tc = {"c_kv": torch.from_numpy(c0.copy()), "k_rope": torch.from_numpy(k0.copy())}
    jdec = jax.jit(functools.partial(jmla.mla_paged_decode, jcfg, page_size=4))
    for pos in ([5, 9], [6, 10], [7, 11]):
        x = _rand(rng, 2, 1, tcfg.d_model)
        jy, jc = jdec(jp, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32),
                      jnp.asarray(tables, jnp.int32))
        ty, tc = mla.mla_paged_decode(tcfg, tp, torch.from_numpy(x), tc, torch.tensor(pos),
                                      torch.from_numpy(tables), page_size=4)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **LAYER_TOL)


@pytest.mark.parametrize("past_len", [0, 8])
def test_mla_prefill_matches_jax(mixer, past_len):
    """The decompressed prefill from scratch, and a suffix of 5 tokens
    against 8 cached tokens' latents at ``q_offset = past_len``."""
    jcfg, tcfg, jp, tp = mixer
    a = tcfg.mla
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 5, tcfg.d_model)
    positions = np.arange(past_len, past_len + 5)
    kw_j, kw_t = {}, {}
    if past_len:
        past = {"c_kv": _rand(rng, 1, past_len, a.kv_lora_rank),
                "k_rope": _rand(rng, 1, past_len, a.qk_rope_head_dim)}
        kw_j = dict(past={k: jnp.asarray(v) for k, v in past.items()}, past_len=past_len)
        kw_t = dict(past={k: torch.from_numpy(v) for k, v in past.items()}, past_len=past_len)
    jy, jc = jmla.mla_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(positions), **kw_j)
    ty, tc = mla.mla_prefill(tcfg, tp, torch.from_numpy(x), torch.from_numpy(positions), **kw_t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for name in ("c_kv", "k_rope"):
        assert tc[name].shape[1] == 5                        # the suffix only
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **LAYER_TOL)


def test_decode_matches_jax_and_full_forward(pair):
    """``tests/test_decode_parity.py``'s deepseek-v2-236b row on the port."""
    jcfg, tcfg, jparams, tparams = pair
    total, prompt_len = 12, 6
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, total)).astype(np.int32)
    ref = np.asarray(jax_full_forward_logits(jcfg, jparams, {"tokens": jnp.asarray(tokens)}))
    full = full_forward_logits(tcfg, tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(full.detach().numpy(), ref, **TOL)
    jcache, jlog = jax.jit(jax_build_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :prompt_len])})
    tcache, tlog = build_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(tokens[:, :prompt_len]).long()})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jdc = jax_extend_cache(jax_decode_cache(jcfg, 2, total), jcache, prompt_len)
    tdc = extend_cache(decode_cache(tcfg, 2, total, "cpu"), tcache, prompt_len)
    jdec, tdec = jax.jit(jax_build_decode_step(jcfg)), build_decode_step(tcfg)
    for pos in range(prompt_len, total):
        tpos = pos if pos % 2 else torch.full((2,), pos)
        jpos = jnp.int32(pos) if pos % 2 else jnp.full((2,), pos, jnp.int32)
        jdc, jl = jdec(jparams, jdc, jnp.asarray(tokens[:, pos:pos + 1]), jpos)
        tdc, tl = tdec(tparams, tdc, torch.from_numpy(tokens[:, pos:pos + 1]).long(), tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), ref[:, pos], **TOL)


def _engines(pair, **kw):
    jcfg, tcfg, jparams, tparams = pair
    return (JaxServingEngine(jcfg, params=jparams, **kw),
            ServingEngine(tcfg, params=tparams, device="cpu", **kw))


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


def _run(engines, prompts, max_new):
    out = []
    for eng, req in zip(engines, (JaxRequest, Request)):
        reqs = [eng.submit(req(f"r{i}", p, max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        eng.drain()
        assert all(r.done for r in reqs)
        out.append([r.generated for r in reqs])
    return out


def test_contiguous_engines_match_jax(pair):
    """``generate``, then the continuous path with slot reuse."""
    engines = _engines(pair, batch_size=2, max_seq=32)
    prompts = _prompts(pair[1].vocab_size, [5, 7], seed=0)
    groups = [eng.generate([req(f"g{i}", p, max_new_tokens=m)
                            for i, (p, m) in enumerate(zip(prompts, [6, 3]))])
              for eng, req in zip(engines, (JaxRequest, Request))]
    assert [r.generated for r in groups[1]] == [r.generated for r in groups[0]]
    shapes = [(5, 3), (7, 6), (5, 1), (7, 4), (5, 5)]
    ref, out = _run(engines, _prompts(pair[1].vocab_size, [n for n, _ in shapes], seed=1),
                    [m for _, m in shapes])
    assert out == ref


def test_paged_engine_matches_jax_and_contiguous(pair):
    """``test_serving_paged.py::test_paged_parity_token_for_token`` on
    deepseek-v2-236b: mixed lengths and a request growing across page
    boundaries, through the paged latent pool; the port's paged engine
    gives the JAX paged engine's tokens and its own contiguous engine's."""
    assert paged_support(pair[1]) == (True, True)
    flags = paged_cache_flags(pair[1])
    assert flags["prefix"]["0"] == {"c_kv": True, "k_rope": True}
    prompts = _prompts(pair[1].vocab_size, (5, 12, 9, 17, 3), seed=11)
    max_new = [6, 6, 6, 6, 21]
    engines = _engines(pair, batch_size=3, max_seq=64, paged=True, page_size=8, pool_pages=48)
    ref, out = _run(engines, prompts, max_new)
    assert out == ref
    assert engines[1].pool_stats() == engines[0].pool_stats()
    assert engines[1]._cb_cache["blocks"]["0"]["c_kv"].shape[1:3] == (49, 8)
    contiguous = ServingEngine(pair[1], params=pair[3], device="cpu", batch_size=3, max_seq=64)
    reqs = [contiguous.submit(Request(f"c{i}", p, max_new_tokens=m))
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    contiguous.drain()
    assert [r.generated for r in reqs] == out


def test_prefix_reuse_matches_jax(pair):
    """``test_serving_paged.py::test_prefix_reuse_parity_and_suffix_only_prefill``
    on deepseek-v2-236b: four prompts sharing 24 tokens (3 pages of
    latents); the sharers prefill only their suffix."""
    rng = np.random.default_rng(12)
    common = rng.integers(1, pair[1].vocab_size, 24).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(1, pair[1].vocab_size, 4 + i)
                               .astype(np.int32)]) for i in range(4)]
    engines = _engines(pair, batch_size=2, max_seq=64, paged=True, page_size=8, pool_pages=64)
    prefilled = []
    engines[1].on_prefill_ms = lambda tokens, ms: prefilled.append(tokens)
    ref, out = _run(engines, prompts, [5] * 4)
    assert out == ref
    assert prefilled[0] == len(prompts[0])
    assert all(t <= len(p) - 24 for t, p in zip(prefilled[1:], prompts[1:]))
    assert engines[1].pool_stats() == engines[0].pool_stats()
    assert engines[1].pool_stats()["prefix_hit_rate"] > 0.5
    assert engines[1].cached_prefix_tokens(prompts[0]) >= 24
