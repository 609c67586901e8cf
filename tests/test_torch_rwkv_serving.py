"""PyTorch port, rwkv6-7b serving: ``rwkv_decode``, the prefill that keeps
the state, the rwkv cache leaves, and the engines, against the JAX package
on the same parameters (``params_from_jax``) and numpy inputs, reduced fp32
configs.  Tolerances are the repo's (ROADMAP "How a slice is held"): logits
2e-3, greedy tokens identical; the layer functions 1e-4 (states reach
O(1e2), and the port's chunks differ from the reference's in fp32 rounding
at lengths that are not a multiple of 32: ROADMAP C)."""
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
from repro.models import model_specs as jax_model_specs
from repro.models import rwkv6 as jrwkv
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.cache_utils import extend_cache as jax_extend_cache
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import (build_decode_step, build_prefill_step, decode_cache,
                                full_forward_logits)
from repro_torch.models import rwkv6
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.cache_utils import extend_cache
from repro_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_decode_parity import full_forward_logits as jax_full_forward_logits  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    jparams = jax_init_params(jax_model_specs(jcfg), seed=1)
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


@pytest.fixture(scope="module")
def mixer(pair):
    """The first layer's time-mix parameters in both packages."""
    jcfg, tcfg, jparams, tparams = pair
    jp = jax.tree.map(lambda t: t[0], jparams["decoder"]["blocks"]["0"]["mixer"])
    tp = {k: t[0] for k, t in tparams["decoder"]["blocks"]["0"]["mixer"].items()}
    return jcfg, tcfg, jp, tp


def test_rwkv_decode_matches_jax(mixer):
    """Three tokens from a random state: output, state and token shift."""
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.default_rng(1)
    st = (0.1 * rng.normal(size=(2, 4, 16, 16))).astype(np.float32)
    xp = rng.normal(size=(2, 64)).astype(np.float32)
    js, jx, ts, tx = jnp.asarray(st), jnp.asarray(xp), torch.from_numpy(st), torch.from_numpy(xp)
    for _ in range(3):
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, js, jx = jax.jit(functools.partial(jrwkv.rwkv_decode, jcfg))(
            jp, jnp.asarray(x), js, jx)
        to, ts, tx = rwkv6.rwkv_decode(tcfg, tp, torch.from_numpy(x), ts, tx)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("S", [16, 32, 45, 77, 100])
@pytest.mark.parametrize("cont", [False, True])
def test_prefill_with_state_matches_jax(mixer, S, cont):
    """``rwkv_time_mix(want_state=True)``, from scratch or continuing from a
    cached token and state: at 45, 77 and 100 tokens the port runs chunks
    of 32 and a remainder where the reference runs one-token chunks."""
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if cont:
        xp = rng.normal(size=(2, 64)).astype(np.float32)
        st = (0.1 * rng.normal(size=(2, 4, 16, 16))).astype(np.float32)
        kw_j = dict(x_prev=jnp.asarray(xp), state=jnp.asarray(st))
        kw_t = dict(x_prev=torch.from_numpy(xp), state=torch.from_numpy(st))
    jo, js, jl = jax.jit(functools.partial(jrwkv.rwkv_time_mix, jcfg))(
        jp, jnp.asarray(x), **kw_j)
    to, ts, tl = rwkv6.rwkv_time_mix(tcfg, tp, torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_decode_matches_jax_and_full_forward(pair):
    """``tests/test_decode_parity.py``'s rwkv6-7b row on the port: prefill 6
    tokens, decode 6 (scalar and per-row positions alternating), each
    step's logits against JAX's and the full forward's."""
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
    leaf = tcache["blocks"]["0"]
    assert leaf["s"].shape == (tcfg.num_layers, 2, 4, 16, 16) and leaf["s"].dtype == torch.float32
    assert leaf["ts_tm"].shape == leaf["ts_cm"].shape == (tcfg.num_layers, 2, tcfg.d_model)
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
        for name in ("s", "ts_tm", "ts_cm"):
            np.testing.assert_allclose(tdc["blocks"]["0"][name].numpy(),
                                       np.asarray(jdc["blocks"]["0"][name]), **LAYER_TOL)


def _engines(pair, batch_size, max_seq, **kw):
    jcfg, tcfg, jparams, tparams = pair
    return (JaxServingEngine(jcfg, params=jparams, batch_size=batch_size, max_seq=max_seq),
            ServingEngine(tcfg, params=tparams, device="cpu", batch_size=batch_size,
                          max_seq=max_seq, **kw))


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


def test_generate_matches_jax(pair):
    """A group left-padded to 45 tokens (a chunk of 32 and a remainder)."""
    jeng, teng = _engines(pair, 2, 64)
    prompts = _prompts(pair[1].vocab_size, [45, 20], seed=0)
    budgets = [6, 3]
    ref = jeng.generate([JaxRequest(f"g{i}", p, max_new_tokens=m)
                         for i, (p, m) in enumerate(zip(prompts, budgets))])
    out = teng.generate([Request(f"g{i}", p, max_new_tokens=m)
                         for i, (p, m) in enumerate(zip(prompts, budgets))])
    assert [r.generated for r in out] == [r.generated for r in ref]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in out)


@pytest.mark.parametrize("paged", [False, True])
def test_continuous_matches_jax_with_slot_reuse(pair, paged):
    """More requests than slots, prompts of 7, 32 and 45 tokens; the paged
    engine runs rwkv6-7b slot-granular (no pageable leaf), as the
    reference's does."""
    jeng, teng = _engines(pair, 2, 64, paged=paged, page_size=8)
    shapes = [(7, 3), (45, 6), (32, 1), (7, 4), (45, 5)]
    prompts = _prompts(pair[1].vocab_size, [n for n, _ in shapes], seed=1)
    jreqs = [jeng.submit(JaxRequest(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    treqs = [teng.submit(Request(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    jeng.drain()
    teng.drain()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.metrics["requests"] == len(shapes) and teng.live_slots() == 0
    assert teng.pool_stats() == {} and teng._pool is None


def test_flush_zeroes_the_rwkv_carries(pair):
    """``flush`` zeroes the state and token-shift leaves in place, so a
    flushed engine serves as a fresh one."""
    _, teng = _engines(pair, 2, 64)
    prompts = _prompts(pair[1].vocab_size, [9, 45], seed=2)
    first = [teng.submit(Request(f"a{i}", p, max_new_tokens=4)) for i, p in enumerate(prompts)]
    teng.drain()
    leaves = {name: teng._cb_cache["blocks"]["0"][name] for name in ("s", "ts_tm", "ts_cm")}
    assert all(t.abs().sum() > 0 for t in leaves.values())
    teng.flush()
    assert all(teng._cb_cache["blocks"]["0"][name] is t and not t.any()
               for name, t in leaves.items())
    again = [teng.submit(Request(f"b{i}", p, max_new_tokens=4)) for i, p in enumerate(prompts)]
    teng.drain()
    assert [r.generated for r in again] == [r.generated for r in first]
