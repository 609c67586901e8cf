"""PyTorch port, MoE (``models/moe.py``) and moonshot-v1-16b-a3b: the port
against the JAX package on the same parameters (``params_from_jax``) and
numpy inputs, reduced fp32 configs.  ``moe_ffn`` is held under the real
``capacity_factor`` of 1.25 (the reduced configs raise it to 8.0, where
nothing drops), so that which (token, expert) pairs drop is compared too,
and with a zero router, where every probability ties.  Tolerances are the
repo's: logits 2e-3, loss 5e-3, greedy tokens identical."""
import dataclasses
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
from repro.models import loss_fn as jax_loss_fn
from repro.models import model_specs as jax_model_specs
from repro.models import moe as jmoe
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.cache_utils import extend_cache as jax_extend_cache
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import (build_decode_step, build_prefill_step, decode_cache,
                                full_forward_logits, loss_fn)
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.cache_utils import extend_cache
from repro_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_decode_parity import full_forward_logits as jax_full_forward_logits  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v2-236b"]
TOL = dict(rtol=2e-3, atol=2e-3)


def _configs(arch, **overrides):
    return (jax_reduced(jax_get_config(arch), **overrides),
            reduced(get_config(arch), **overrides))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs(ARCH)
    jparams = jax_init_params(jax_model_specs(jcfg), seed=1)
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


def _ffn_params(pair, router_scale):
    """The first MoE layer's FFN parameters, the router scaled so that the
    routing is decisive (or zeroed, so that every probability ties)."""
    _, _, jparams, tparams = pair
    jp = jax.tree.map(lambda t: t[0], jparams["decoder"]["blocks"]["0"]["ffn"])
    jp = dict(jp, router=jp["router"] * router_scale)
    return jp, params_from_jax(_flatten(jp), device="cpu")


def _dropped(top_i, num_experts, cap):
    """(token, expert) pairs past ``cap`` in their expert, from the routing."""
    counts = np.bincount(np.asarray(top_i).reshape(-1), minlength=num_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("B,S,cap", [(1, 4, 2), (1, 12, 8), (2, 8, 10), (2, 110, 256)])
@pytest.mark.parametrize("router_scale", [50.0, 0.0])
def test_moe_ffn_drops_as_jax_under_the_real_capacity(pair, B, S, cap, router_scale):
    """``capacity_factor=1.25``: T·k/E·1.25 = 2.5 and 7.5 round half to even
    (2, 8); 10 is exact; 137.5 rounds to 138 and then up to 256, the next
    multiple of 128.  The output, aux loss and the routing match JAX's, and
    the port drops as many pairs as the reference's routing implies."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=1.25))
                  for c in pair[:2])
    m = tcfg.moe
    assert moe.capacity(B * S, m.top_k, m.num_experts, m.capacity_factor) == cap
    jp, tp = _ffn_params(pair, router_scale)
    x = np.random.default_rng(S).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(functools.partial(jmoe.moe_ffn, jcfg))(jp, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    x2d = x.reshape(B * S, -1)
    jprob, jidx, _ = jax.jit(functools.partial(jmoe._route, jcfg))(jp, jnp.asarray(x2d))
    tprob, tidx, _ = moe._route(tcfg, tp, torch.from_numpy(x2d))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-5, atol=1e-6)
    keep = moe._dispatch(tidx, m.num_experts, cap)[3]
    dropped = int((~keep).sum())
    assert dropped == _dropped(jidx, m.num_experts, cap)
    if router_scale == 0.0:
        # every probability ties: the lower expert ids win, as jax.lax.top_k's
        assert (tidx.numpy() == np.arange(m.top_k)).all()
        assert dropped == max(B * S - cap, 0) * m.top_k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_matches_jax_and_full_forward(pair, use_pallas):
    """``tests/test_decode_parity.py``'s moonshot-v1-16b-a3b row on the
    port; with ``use_pallas`` the train-path forward reaches the flash
    kernel (its plain version on the CPU, JAX's in interpret mode)."""
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, tcfg))
    total, prompt_len = 12, 6
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, total)).astype(np.int32)
    ref = np.asarray(jax_full_forward_logits(jcfg, jparams, {"tokens": jnp.asarray(tokens)}))
    full = full_forward_logits(tcfg, tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(full.detach().numpy(), ref, **TOL)
    if use_pallas:
        return
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


def _loss_and_grads(cfg, params, batch):
    leaves = {path: t.detach().clone().requires_grad_() for path, t in cm.tree_leaves(params)}
    loss, metrics = loss_fn(cfg, cm.tree_from_paths(params, leaves), batch)
    return loss, metrics, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_aux_and_grads_match_jax(arch):
    """``loss_fn`` with the aux loss (``AUX_WEIGHT · moe_aux``) and its grads
    at the configs' ``remat_policy="full"``: the loss within 5e-3, the aux
    within 1e-5, each grad leaf within rtol 1e-3 / atol 1e-4 or twice the
    JAX package's own change under a 1e-7 relative parameter nudge
    (``tests/test_torch_model.py::test_loss_and_grads_match_jax``)."""
    jcfg, tcfg = _configs(arch)
    assert tcfg.remat_policy == jcfg.remat_policy == "full"
    jparams = jax_init_params(jax_model_specs(jcfg), seed=3)
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    rng = np.random.default_rng(4)
    b = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True))
    (jloss, jmetrics), jgrads = value_and_grad(jparams)
    flat, tdef = jax.tree_util.tree_flatten(jparams)
    nudged = jax.tree_util.tree_unflatten(
        tdef, [x * (1 + 1e-7 * rng.normal(size=x.shape).astype(np.float32)) for x in flat])
    jg_nudged = _flatten(value_and_grad(nudged)[1])
    loss, metrics, grads = _loss_and_grads(tcfg, tparams,
                                           {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < 5e-3
    assert metrics["moe_aux"].item() > 0
    np.testing.assert_allclose(metrics["moe_aux"].item(), float(jmetrics["moe_aux"]), atol=1e-5)
    want = _flatten(jgrads)
    assert sorted(grads) == sorted(want)
    for key, ref in want.items():
        diff = np.abs(grads[key].numpy() - ref)
        noise = 2 * np.max(np.abs(jg_nudged[key] - ref))
        bound = np.maximum(1e-4 + 1e-3 * np.abs(ref), noise)
        assert np.all(diff <= bound), (key, float(diff.max()), noise)


def test_moe_remat_policy_is_full_on_one_device(pair):
    """``remat_policy="moe"`` saves only what the sharded dispatch names
    (ROADMAP A9); on one device it recomputes everything, so its loss and
    grads are bit-equal to ``"full"``'s."""
    _, tcfg, _, tparams = pair
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 32))).long()
             for k in ("tokens", "labels")}
    out = {policy: _loss_and_grads(dataclasses.replace(tcfg, remat_policy=policy), tparams,
                                   batch) for policy in ("full", "moe", "nothing")}
    for policy in ("moe", "nothing"):
        assert torch.equal(out[policy][0], out["full"][0])
        assert all(torch.equal(g, out["full"][2][k]) for k, g in out[policy][2].items())
    assert cm.remat_policy("moe") is cm.remat_policy("full")
    assert cm.maybe_remat(loss_fn, "nothing") is loss_fn


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


def test_engines_match_jax(pair):
    """``generate`` and the continuous path with slot reuse: with two rows
    a decode step's capacity is one slot per expert, so the rows (a dead
    one included) compete for it, as in the reference."""
    jcfg, tcfg, jparams, tparams = pair
    m = tcfg.moe
    assert moe.capacity(2, m.top_k, m.num_experts, m.capacity_factor) == 8
    jeng, teng = (JaxServingEngine(jcfg, params=jparams, batch_size=2, max_seq=32),
                  ServingEngine(tcfg, params=tparams, device="cpu", batch_size=2, max_seq=32))
    prompts = _prompts(tcfg.vocab_size, [5, 7], seed=0)
    ref = jeng.generate([JaxRequest(f"g{i}", p, max_new_tokens=m)
                         for i, (p, m) in enumerate(zip(prompts, [6, 3]))])
    out = teng.generate([Request(f"g{i}", p, max_new_tokens=m)
                         for i, (p, m) in enumerate(zip(prompts, [6, 3]))])
    assert [r.generated for r in out] == [r.generated for r in ref]
    shapes = [(5, 3), (7, 6), (5, 1), (7, 4), (5, 5)]
    prompts = _prompts(tcfg.vocab_size, [n for n, _ in shapes], seed=1)
    jreqs = [jeng.submit(JaxRequest(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    treqs = [teng.submit(Request(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    jeng.drain()
    teng.drain()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.metrics["requests"] == len(shapes) + 2 and teng.live_slots() == 0


def test_engine_under_the_real_capacity_matches_jax(pair):
    """The same continuous trace at ``capacity_factor=1.25``: a decode
    step of two rows has one slot per expert and drops pairs."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=1.25))
                  for c in pair[:2])
    assert moe.capacity(2, tcfg.moe.top_k, tcfg.moe.num_experts, 1.25) == 1
    jeng = JaxServingEngine(jcfg, params=pair[2], batch_size=2, max_seq=32)
    teng = ServingEngine(tcfg, params=pair[3], device="cpu", batch_size=2, max_seq=32)
    shapes = [(5, 4), (7, 6), (5, 3)]
    prompts = _prompts(tcfg.vocab_size, [n for n, _ in shapes], seed=2)
    jreqs = [jeng.submit(JaxRequest(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    treqs = [teng.submit(Request(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    jeng.drain()
    teng.drain()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
