"""PyTorch port, model slice: full-forward, prefill and step-by-step decode
logits of the port against the JAX package on the same parameters (JAX
``init_params`` → ``params_from_jax``) and the same numpy inputs, as in
``tests/test_decode_parity.py`` (rtol/atol 2e-3, reduced fp32 configs).
With ``use_pallas`` the JAX encoder runs the Pallas kernel in interpret mode
and the port's ``mha`` its plain version (CPU tensors)."""
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
from repro.models.model import count_params as jax_count_params
from repro.configs import ARCH_REGISTRY as JAX_ARCH_REGISTRY
from repro.models import attention as jattn
from repro.models.common import init_params as jax_init_params
from repro.serving.cache_utils import extend_cache as jax_extend_cache
from repro.training.checkpoint import _flatten
from test_decode_parity import full_forward_logits as jax_full_forward_logits
from repro_torch.configs import ARCH_REGISTRY, get_config, reduced
from repro_torch.models import (build_decode_step, build_prefill_step, count_params,
                                decode_cache, full_forward_logits, loss_fn)
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.transformer import LayerDef, Stack
from repro_torch.serving.cache_utils import extend_cache
from repro_torch.weights import params_from_jax

TOL = dict(rtol=2e-3, atol=2e-3)
# recurrentgemma-9b's 12-token sequences stay below its 16-token window and
# the K2 gate (S % 64), so JAX never reaches its broken Pallas K2 (ROADMAP C)
CASES = [("whisper-large-v3", False), ("whisper-large-v3", True), ("internlm2-20b", False),
         ("recurrentgemma-9b", False), ("recurrentgemma-9b", True),
         ("qwen2.5-32b", False), ("command-r-35b", False), ("nemotron-4-340b", False)]
#: the dense archs of this slice: qkv bias; layernorm and tied embeddings;
#: squared-ReLU with no gate, layernorm and (at full size) head dim 192
DENSE_ARCHS = ["qwen2.5-32b", "command-r-35b", "nemotron-4-340b"]


def _configs(arch, use_pallas):
    return (jax_reduced(jax_get_config(arch), use_pallas=use_pallas),
            reduced(get_config(arch), use_pallas=use_pallas))


def _batch(cfg, tokens, frames):
    b = {"tokens": tokens}
    if cfg.family == "encdec":
        b["frames"] = frames
    return b


@pytest.mark.parametrize("arch,use_pallas", CASES)
def test_forward_prefill_decode_match_jax(arch, use_pallas):
    jcfg, tcfg = _configs(arch, use_pallas)
    total, prompt_len = 12, 6
    jparams = jax_init_params(jax_model_specs(jcfg), seed=1)
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (2, total)).astype(np.int32)
    frames = rng.normal(size=(2, tcfg.encoder_frames, tcfg.d_model)).astype(np.float32)
    jb = _batch(jcfg, jnp.asarray(tokens), jnp.asarray(frames))
    tb = _batch(tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(frames))

    ref = np.asarray(jax_full_forward_logits(jcfg, jparams, jb))
    full = full_forward_logits(tcfg, tparams, tb).numpy()
    np.testing.assert_allclose(full, ref, **TOL)

    jcache, jlog = jax.jit(jax_build_prefill_step(jcfg))(
        jparams, dict(jb, tokens=jb["tokens"][:, :prompt_len]))
    tcache, tlog = build_prefill_step(tcfg)(
        tparams, dict(tb, tokens=tb["tokens"][:, :prompt_len]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tlog.numpy(), ref[:, prompt_len - 1], **TOL)

    jdc = jax_extend_cache(jax_decode_cache(jcfg, 2, total), jcache, prompt_len)
    tdc = extend_cache(decode_cache(tcfg, 2, total, "cpu"), tcache, prompt_len)
    jdec, tdec = jax.jit(jax_build_decode_step(jcfg)), build_decode_step(tcfg)
    for pos in range(prompt_len, total):
        # alternate a shared scalar position with a per-row position vector
        tpos = pos if pos % 2 else torch.full((2,), pos)
        jpos = jnp.int32(pos) if pos % 2 else jnp.full((2,), pos, jnp.int32)
        jdc, jl = jdec(jparams, jdc, jnp.asarray(tokens[:, pos:pos + 1]), jpos)
        tdc, tl = tdec(tparams, tdc, torch.from_numpy(tokens[:, pos:pos + 1]).long(), tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} decode diverges at pos {pos}")
        np.testing.assert_allclose(tl.numpy(), ref[:, pos], **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_ring_buffer_matches_jax(window):
    """Per-row timelines against a global cache and a local ring buffer."""
    jcfg, tcfg = _configs("internlm2-20b", False)
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         [("wq", (64, 4, 16)), ("wk", (64, 2, 16)), ("wv", (64, 2, 16)), ("wo", (4, 16, 64))]}
    T = window or 9
    k0, v0 = (rng.normal(size=(2, T, 2, 16)).astype(np.float32) for _ in range(2))
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    for pos in [np.array([3, 7]), np.array([4, 8]), np.array([5, 2])]:
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jy, jc = jattn.decode_attention(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), jc, jnp.asarray(pos), window=window)
        ty, tc = attn.decode_attention(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                                       torch.from_numpy(x), tc, torch.from_numpy(pos),
                                       window=window)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset,chunk", [
    (True, None, 0, 4), (False, None, 0, 5), (True, 6, 0, 4), (True, None, 3, 16)])
def test_chunked_attention_matches_jax(causal, window, q_offset, chunk):
    rng = np.random.default_rng(4)
    S, T = 11, 11 + q_offset
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, T, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    out = attn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    ref = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_extend_cache_ring_roll_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(2, 1, 4, 2, 8)).astype(np.float32)      # stacked, window 4
    tmpl = np.zeros((2, 1, 6, 2, 8), np.float32)                   # a 6-slot row
    glob = rng.normal(size=(1, 6, 2, 8)).astype(np.float32)        # global, pad 6 -> 10
    jt = {"blocks": {"0": {"k": jnp.asarray(tmpl)}}, "prefix": {"0": {"v": jnp.zeros((1, 10, 2, 8))}}}
    js = {"blocks": {"0": {"k": jnp.asarray(src)}}, "prefix": {"0": {"v": jnp.asarray(glob)}}}
    tt = {"blocks": {"0": {"k": torch.from_numpy(tmpl)}}, "prefix": {"0": {"v": torch.zeros(1, 10, 2, 8)}}}
    ts = {"blocks": {"0": {"k": torch.from_numpy(src)}}, "prefix": {"0": {"v": torch.from_numpy(glob)}}}
    # a prompt of 7 kept in a 4-slot window: rolled so slot p % 4 holds position p
    ref, out = jax_extend_cache(jt, js, 7), extend_cache(tt, ts, 7)
    for g, name in (("blocks", "k"), ("prefix", "v")):
        np.testing.assert_array_equal(out[g]["0"][name].numpy(), np.asarray(ref[g]["0"][name]))


class _StubMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


@pytest.mark.parametrize("defs,item", [
    ([LayerDef("mla", "moe")], "A9.2"),
    ([LayerDef("attn", "moe")], "A9.2"),
    ([LayerDef("recurrent", "dense")], "A9.2"),
    ([LayerDef("rwkv", "rwkv_cm")], "A9.2"),
    ([LayerDef("attn", "dense", cross=True)], "A9.2"),
])
def test_unported_layer_kinds_name_their_roadmap_item(defs, item):
    """Every layer kind is ported for one device (the cache builds); under a
    sharding context a kind whose distributed path is not ported yet raises,
    naming its ROADMAP item, and the decode step raises for any kind."""
    from repro_torch.distributed import RECIPES
    from repro_torch.distributed.ctx import sharding_ctx

    arch = {"mla": "deepseek-v2-236b", "recurrent": "recurrentgemma-9b",
            "rwkv": "rwkv6-7b"}.get(defs[0].mixer, "internlm2-20b")
    cfg = reduced(get_config(arch))
    stack = Stack(cfg, defs=defs)
    assert stack.cache(1, 8, "cpu")
    with sharding_ctx(_StubMesh(), RECIPES["baseline"]):
        with pytest.raises(NotImplementedError, match=item):
            stack.train({}, torch.zeros(1, 4, cfg.d_model), torch.arange(4))
        with pytest.raises(NotImplementedError, match=item):
            stack.decode({}, torch.zeros(1, 1, cfg.d_model), {}, 4)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax(arch, use_pallas):
    """``loss_fn`` and its grads for the slice's dense archs against the
    JAX package on the same parameters, at ``remat_policy="full"`` (the
    configs' default) in both: the loss within 5e-3, each grad leaf within
    rtol 1e-3 / atol 1e-4 (``tests/test_use_pallas.py``) or twice the JAX
    package's own change when its parameters move by 1e-7 relative,
    whichever is larger, as ``tests/test_torch_train.py::test_grads_match_jax``
    holds reduced internlm2-20b: the embedding grads under a norm over
    embeddings of std 0.02 move by up to ~7e-4 with fp32 rounding."""
    jcfg, tcfg = _configs(arch, use_pallas)
    assert tcfg.remat_policy == jcfg.remat_policy == "full"
    jparams = jax_init_params(jax_model_specs(jcfg), seed=3)
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    rng = np.random.default_rng(4)
    b = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})[0]))
    jloss, jgrads = value_and_grad(jparams)
    flat, tdef = jax.tree_util.tree_flatten(jparams)
    nudged = jax.tree_util.tree_unflatten(
        tdef, [x * (1 + 1e-7 * rng.normal(size=x.shape).astype(np.float32)) for x in flat])
    jg_nudged = _flatten(value_and_grad(nudged)[1])
    leaves = {path: t.detach().clone().requires_grad_() for path, t in cm.tree_leaves(tparams)}
    loss, _ = loss_fn(tcfg, cm.tree_from_paths(tparams, leaves),
                      {k: torch.from_numpy(v).long() for k, v in b.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - float(jloss)) < 5e-3
    want = _flatten(jgrads)
    assert sorted(grads) == sorted(want)
    if tcfg.qkv_bias:
        assert {"decoder/blocks/0/mixer/bq", "decoder/blocks/0/mixer/bk"} <= set(grads)
    if tcfg.tie_embeddings:
        assert "unembed" not in grads
    for key, ref in want.items():
        diff = np.abs(grads[key].numpy() - ref)
        noise = 2 * np.max(np.abs(jg_nudged[key] - ref))
        bound = np.maximum(1e-4 + 1e-3 * np.abs(ref), noise)
        assert np.all(diff <= bound), (key, float(diff.max()), noise)


@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_count_params_matches_jax(arch):
    """At full size, for every arch both packages register, under the four
    combinations of ``active_only`` and ``include_embed``."""
    assert arch in JAX_ARCH_REGISTRY
    for active_only in (False, True):
        for include_embed in (False, True):
            assert count_params(get_config(arch), active_only, include_embed) == jax_count_params(
                jax_get_config(arch), active_only, include_embed)
    assert count_params(get_config(arch), include_embed=False) < count_params(get_config(arch))
