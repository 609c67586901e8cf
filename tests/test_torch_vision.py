"""PyTorch port, llama-3.2-vision-90b (ROADMAP A8.5): the ``cross_only``
layers (cross-attention to the image embeddings, gated by ``tanh(xgate)``)
against the JAX package on the same parameters and numpy inputs, at the
reduced fp32 config with 4 layers (two cycles of ``attn`` + ``cross_only``).

``xgate`` starts at zero and the engine's image embeddings are zeros, and
under either a ``cross_only`` layer adds exactly nothing: every parity test
here sets ``xgate`` to non-zero values in the tree both packages load and
feeds ``image_embeds`` drawn from a seeded normal, and
``test_cross_attention_is_live`` shows that the path is live."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduced as jax_reduced
from repro.models import build_decode_step as jax_build_decode_step
from repro.models import build_prefill_step as jax_build_prefill_step
from repro.models import decode_cache as jax_decode_cache
from repro.models import loss_fn as jax_loss_fn
from repro.models import model_specs as jax_model_specs
from repro.models import paged_cache_flags as jax_paged_cache_flags
from repro.models import transformer as jtr
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.cache_utils import extend_cache as jax_extend_cache
from repro.training.checkpoint import _flatten
from test_decode_parity import full_forward_logits as jax_full_forward_logits
from repro_torch.configs import ARCH_REGISTRY, get_config, reduced
from repro_torch.models import (build_decode_step, build_prefill_step, decode_cache,
                                full_forward_logits, loss_fn, paged_cache_flags, paged_support)
from repro_torch.models import common as cm
from repro_torch.models import transformer as ttr
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.cache_utils import extend_cache
from repro_torch.weights import params_from_jax

ARCH = "llama-3.2-vision-90b"
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
#: per-repetition gates of the stacked cross_only layer (non-zero: live)
XGATES = (0.5, -0.3)
CROSS = ttr.LayerDef("cross_only", "dense")


def _unflatten_jax(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


class Vision:
    """The reduced configs of both packages and one parameter tree, with the
    stacked ``xgate`` leaf set to :data:`XGATES`."""

    def __init__(self, xgates=XGATES, seed=1):
        self.jcfg = jax_reduced(jax_get_config(ARCH), num_layers=4)
        self.tcfg = reduced(get_config(ARCH), num_layers=4)
        self.flat = _flatten(jax_init_params(jax_model_specs(self.jcfg), seed=seed))
        key = "decoder/blocks/1/xgate"
        assert self.flat[key].shape == (2, 1) and self.flat[key].dtype == np.float32
        self.flat[key] = np.asarray(xgates, np.float32).reshape(2, 1)
        self.jparams = _unflatten_jax(self.flat)
        self.tparams = params_from_jax(self.flat, device="cpu")

    def images(self, rng, batch):
        return rng.normal(size=(batch, self.tcfg.num_image_tokens,
                                self.tcfg.d_model)).astype(np.float32)

    def layer(self, rep):
        """The ``cross_only`` layer's parameters at repetition ``rep``."""
        jp = jax.tree.map(lambda a: a[rep], self.jparams["decoder"]["blocks"]["1"])
        tp = cm.tree_map(lambda t: t[rep], self.tparams["decoder"]["blocks"]["1"])
        return jp, tp


@pytest.fixture(scope="module")
def vis():
    return Vision()


def test_config_and_registry_match_the_reference():
    """The port registers every arch the reference does, llama-3.2-vision-90b
    with the reference's values, and builds its layers as 4 ``attn`` and
    1 ``cross_only`` per cycle of 5."""
    assert sorted(ARCH_REGISTRY) == list(jax_list_archs())
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        assert got == want, (f.name, got, want)
    stack = ttr.Stack(tcfg)
    assert (stack.prefix, stack.suffix, stack.reps) == ([], [], 20)
    assert stack.cycle == [ttr.LayerDef("attn", "dense")] * 4 + [CROSS]
    assert paged_support(tcfg) == (True, False)


def test_cross_only_specs_and_cache_layout(vis):
    """``xgate`` is an fp32 (1,) leaf of zeros, the mixer is full MHA
    (K = H), and the image K/V are resident, slot-grained cache leaves."""
    cfg = vis.tcfg
    specs = ttr.layer_specs(cfg, CROSS)
    assert specs["xgate"] == cm.ParamSpec((1,), (None,), torch.float32, "zeros")
    assert specs["mixer"]["wk"].shape == (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    cache = ttr.layer_cache(cfg, CROSS, 3, 40, "cpu")
    shape = (3, cfg.num_image_tokens, cfg.num_heads, cfg.resolved_head_dim)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {"ck": shape, "cv": shape}
    paged = ttr.layer_cache_paged(cfg, CROSS, 3, 40, 9, 8, "cpu")
    assert {k: tuple(v.shape) for k, v in paged.items()} == {"ck": shape, "cv": shape}
    flags = paged_cache_flags(cfg)["blocks"]
    assert flags == {"0": {"k": True, "v": True}, "1": {"ck": False, "cv": False}}
    assert flags == jax.tree.map(bool, jax_paged_cache_flags(vis.jcfg))["blocks"]


@pytest.mark.parametrize("rep", [0, 1])
def test_cross_only_branches_match_jax(vis, rep):
    """Train, prefill and decode of one ``cross_only`` layer against the
    reference's ``apply_layer_*`` (fp32, 1e-5), with the layer's own gate."""
    rng = np.random.default_rng(7 + rep)
    B, S = 2, 6
    x = rng.normal(size=(B, S, vis.tcfg.d_model)).astype(np.float32)
    ctx = vis.images(rng, B)
    pos = np.arange(S, dtype=np.int32)
    jp, tp = vis.layer(rep)
    jcfg, tcfg = vis.jcfg, vis.tcfg
    tol = dict(rtol=1e-5, atol=1e-5)
    zero = jnp.zeros((), jnp.float32)
    taux = torch.zeros(())

    jx, _ = jtr.apply_layer_train(jcfg, CROSS, jp, jnp.asarray(x), jnp.asarray(pos),
                                  jnp.asarray(ctx), zero)
    tx, _ = ttr.apply_layer_train(tcfg, CROSS, tp, torch.from_numpy(x),
                                  torch.from_numpy(pos).long(), torch.from_numpy(ctx), taux)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **tol)

    jx, jc, _ = jtr.apply_layer_prefill(jcfg, CROSS, jp, jnp.asarray(x), jnp.asarray(pos),
                                        jnp.asarray(ctx), zero)
    tx, tc, _ = ttr.apply_layer_prefill(tcfg, CROSS, tp, torch.from_numpy(x),
                                        torch.from_numpy(pos).long(),
                                        torch.from_numpy(ctx), taux)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **tol)
    assert sorted(tc) == sorted(jc) == ["ck", "cv"]
    for name in ("ck", "cv"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **tol)

    xd = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    jx, _, _ = jtr.apply_layer_decode(jcfg, CROSS, jp, jnp.asarray(xd), jc, jnp.int32(S), zero)
    cache = {k: v.clone() for k, v in tc.items()}
    tx, _ = ttr.apply_layer_decode(tcfg, CROSS, tp, torch.from_numpy(xd), cache,
                                   torch.tensor(S), taux)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **tol)
    for name in ("ck", "cv"):      # decode reads the image K/V and never writes them
        assert torch.equal(cache[name], tc[name])


def test_loss_and_grads_match_jax(vis):
    """``loss_fn`` within 5e-3 and every grad leaf (``xgate`` included)
    within rtol 1e-3 / atol 1e-4 or twice the JAX package's own change under
    a 1e-7 relative nudge, whichever is larger (``test_torch_model.py``'s
    rule), under the config's ``"full"`` remat."""
    jcfg, tcfg = vis.jcfg, vis.tcfg
    assert tcfg.remat_policy == jcfg.remat_policy == "full"
    rng = np.random.default_rng(4)
    b = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
    img = vis.images(rng, 2)
    jb = {"tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"]),
          "image_embeds": jnp.asarray(img)}
    value_and_grad = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(jcfg, p, jb)[0]))
    jloss, jgrads = value_and_grad(vis.jparams)
    flat, tdef = jax.tree_util.tree_flatten(vis.jparams)
    nudged = jax.tree_util.tree_unflatten(
        tdef, [x * (1 + 1e-7 * rng.normal(size=x.shape).astype(np.float32)) for x in flat])
    jg_nudged = _flatten(value_and_grad(nudged)[1])
    leaves = {path: t.detach().clone().requires_grad_()
              for path, t in cm.tree_leaves(vis.tparams)}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tb["image_embeds"] = torch.from_numpy(img)
    loss, _ = loss_fn(tcfg, cm.tree_from_paths(vis.tparams, leaves), tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - float(jloss)) < 5e-3
    want = _flatten(jgrads)
    assert sorted(grads) == sorted(want)
    assert np.abs(want["decoder/blocks/1/xgate"]).max() > 0
    for key, ref in want.items():
        diff = np.abs(grads[key].numpy() - ref)
        noise = 2 * np.max(np.abs(jg_nudged[key] - ref))
        bound = np.maximum(1e-4 + 1e-3 * np.abs(ref), noise)
        assert np.all(diff <= bound), (key, float(diff.max()), noise)


def test_prefill_and_decode_match_jax(vis):
    """Prefill of 6 tokens, then decode to 12, against the JAX steps and
    the full forward (2e-3), as ``tests/test_decode_parity.py``'s vision
    row; the greedy tokens of every step are identical."""
    jcfg, tcfg = vis.jcfg, vis.tcfg
    total, prompt_len = 12, 6
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (2, total)).astype(np.int32)
    img = vis.images(rng, 2)
    jb = {"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "image_embeds": torch.from_numpy(img)}
    ref = np.asarray(jax_full_forward_logits(jcfg, vis.jparams, jb))
    np.testing.assert_allclose(full_forward_logits(tcfg, vis.tparams, tb).numpy(), ref,
                               **LOGIT_TOL)

    jcache, jlog = jax.jit(jax_build_prefill_step(jcfg))(
        vis.jparams, dict(jb, tokens=jb["tokens"][:, :prompt_len]))
    tcache, tlog = build_prefill_step(tcfg)(
        vis.tparams, dict(tb, tokens=tb["tokens"][:, :prompt_len]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    assert np.array_equal(tlog.numpy().argmax(-1), np.asarray(jlog).argmax(-1))
    for name in ("ck", "cv"):
        np.testing.assert_allclose(tcache["blocks"]["1"][name].numpy(),
                                   np.asarray(jcache["blocks"]["1"][name]), rtol=1e-5, atol=1e-5)

    jdc = jax_extend_cache(jax_decode_cache(jcfg, 2, total), jcache, prompt_len)
    tdc = extend_cache(decode_cache(tcfg, 2, total, "cpu"), tcache, prompt_len)
    jdec, tdec = jax.jit(jax_build_decode_step(jcfg)), build_decode_step(tcfg)
    for pos in range(prompt_len, total):
        tpos = pos if pos % 2 else torch.full((2,), pos)
        jpos = jnp.int32(pos) if pos % 2 else jnp.full((2,), pos, jnp.int32)
        jdc, jl = jdec(vis.jparams, jdc, jnp.asarray(tokens[:, pos:pos + 1]), jpos)
        tdc, tl = tdec(vis.tparams, tdc, torch.from_numpy(tokens[:, pos:pos + 1]).long(), tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"decode diverges at pos {pos}")
        np.testing.assert_allclose(tl.numpy(), ref[:, pos], **LOGIT_TOL)
        assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


def _with_images(engine, img, to_array):
    """Give every admission of ``engine`` the same seeded image embeddings
    (the engines' own frontend stub gives zeros, under which the cross
    K/V are zero and the layers add nothing)."""
    def extras(B):
        return {"image_embeds": to_array(np.broadcast_to(img, (B,) + img.shape[1:]).copy())}
    engine._batch_extras = extras
    return engine


@pytest.mark.parametrize("images", ["zeros", "seeded"])
@pytest.mark.parametrize("paged", [False, True])
def test_engines_match_jax(vis, paged, images):
    """The CPU engine, contiguous and paged (attn K/V in the pool, the
    image K/V resident, no prefix cache), against the JAX engine on one
    continuous trace with slot reuse: identical tokens.  ``zeros`` is the
    engines as shipped; ``seeded`` gives both the same image embeddings so
    that the cross-attention is live."""
    rng = np.random.default_rng(11)
    lengths, max_new = (5, 12, 9, 17, 3), (6, 6, 6, 6, 21)
    prompts = [rng.integers(1, vis.tcfg.vocab_size, n).astype(np.int32) for n in lengths]
    kw = dict(batch_size=3, max_seq=64)
    if paged:
        kw.update(paged=True, page_size=8, pool_pages=48)
    jeng = JaxServingEngine(vis.jcfg, params=vis.jparams, **kw)
    teng = ServingEngine(vis.tcfg, params=vis.tparams, device="cpu", **kw)
    if images == "seeded":
        img = vis.images(np.random.default_rng(5), 1)
        _with_images(jeng, img, jnp.asarray)
        _with_images(teng, img, torch.from_numpy)
    else:
        extras = teng._batch_extras(2)["image_embeds"]
        assert extras.shape == (2, vis.tcfg.num_image_tokens, vis.tcfg.d_model)
        assert extras.dtype == torch.float32 and not extras.any()
    out = []
    for eng, req in ((jeng, JaxRequest), (teng, Request)):
        reqs = [eng.submit(req(f"r{i}", p, max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        eng.drain()
        out.append([r.generated for r in reqs])
    assert out[1] == out[0]
    assert all(len(g) == m for g, m in zip(out[1], max_new))
    if paged:
        assert teng.pool_stats() == jeng.pool_stats()
        assert teng.pool_stats()["pool_pages"] == 48
        assert "prefix_hit_rate" not in teng.pool_stats()       # no prefix cache


def test_cross_attention_is_live(vis):
    """Perturbing ``image_embeds`` moves the logits; with ``xgate = 0`` a
    ``cross_only`` layer's output is the layer's FFN alone, bit for bit,
    and the whole model ignores the image."""
    cfg = vis.tcfg
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10))).long()
    img = torch.from_numpy(vis.images(rng, 2))
    moved = img + 0.1 * torch.from_numpy(vis.images(rng, 2))
    logits = full_forward_logits(cfg, vis.tparams, {"tokens": tokens, "image_embeds": img})
    other = full_forward_logits(cfg, vis.tparams, {"tokens": tokens, "image_embeds": moved})
    assert (logits - other).abs().max() > 1e-3

    closed = Vision(xgates=(0.0, 0.0))
    x = torch.from_numpy(rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32))
    _, tp = closed.layer(0)
    out, _ = ttr.apply_layer_train(cfg, CROSS, tp, x, torch.arange(6), img, torch.zeros(()))
    ffn_only, _ = ttr._ffn_apply(cfg, CROSS, tp, x, torch.zeros(()))
    assert torch.equal(out, ffn_only)
    a = full_forward_logits(cfg, closed.tparams, {"tokens": tokens, "image_embeds": img})
    b = full_forward_logits(cfg, closed.tparams, {"tokens": tokens, "image_embeds": moved})
    assert torch.equal(a, b)
