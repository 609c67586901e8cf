"""PyTorch port, paged serving slice: the port's paged ``ServingEngine`` on
``device="cpu"`` against the JAX paged engine with the same parameters, on
the scenarios of ``tests/test_serving_paged.py``; the paged functions
(``write_prefill_paged``, ``gather_pages``, ``paged_decode_attention``,
``prefill_attention(past=...)``, ``build_prefill_past_step``,
``build_decode_step_paged``) against JAX's on the same inputs; and the
port's copy of ``kv_pages`` against the reference's under one random
operation sequence.

Greedy tokens must be identical.  The scatter and gather must be exact,
attention within 2e-5 and logits within 2e-3 + 2e-3·|ref| (fp32).
recurrentgemma-9b prompts stay within its 16-token window: past it the
reference's ``extend_cache`` skips the ring roll that the port makes
(ROADMAP §C), so the two engines would differ by design.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.errors import AdmissionRefused as JaxAdmissionRefused
from repro.core.simclock import VirtualClock
from repro.models import attention as jattn
from repro.models import build_decode_step_paged as jax_decode_paged
from repro.models import build_prefill_past_step as jax_prefill_past
from repro.models import build_prefill_step as jax_prefill
from repro.models import decode_cache_paged as jax_cache_paged
from repro.models import model_specs as jax_model_specs
from repro.models import paged_cache_flags as jax_flags
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import cache_utils as jcu
from repro.serving import kv_pages as jkv
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.core.errors import AdmissionRefused, ErrorCode
from repro_torch.models import (build_decode_step_paged, build_prefill_past_step,
                                build_prefill_step, decode_cache_paged, paged_cache_flags)
from repro_torch.models import attention as tattn
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import cache_utils as tcu
from repro_torch.serving import kv_pages as tkv
from repro_torch.weights import params_from_jax

LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def _unflatten_jax(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


class Pair:
    """A reduced arch's configs and one set of parameters in both packages."""

    def __init__(self, arch, **overrides):
        self.jcfg = jax_reduced(jax_get_config(arch), **overrides)
        self.tcfg = reduced(get_config(arch), **overrides)
        self.flat = _flatten(jax_init_params(jax_model_specs(self.jcfg), seed=1))
        if self.jcfg.family == "encdec":
            # with zero frames and a 0.02-scale embedding the position
            # embedding swamps the prompt; a larger one makes tokens depend on it
            self.flat["embed"] = self.flat["embed"] * 30.0
        self.jparams = _unflatten_jax(self.flat)
        self.tparams = params_from_jax(self.flat, device="cpu")

    def engines(self, **kw):
        return (JaxServingEngine(self.jcfg, params=self.jparams, **kw),
                ServingEngine(self.tcfg, params=self.tparams, device="cpu", **kw))

    def prompt(self, rng, n):
        return rng.integers(1, self.tcfg.vocab_size, size=n).astype(np.int32)


@pytest.fixture(scope="module")
def attn_pair():
    return Pair("internlm2-20b")


def run_both(engines, prompts, max_new):
    """The same trace through the JAX engine and the port's; returns each
    engine's requests."""
    out = []
    for eng, req in zip(engines, (JaxRequest, Request)):
        reqs = [eng.submit(req(f"r{i}", p, max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        eng.drain()
        out.append(reqs)
    return out


def tokens(reqs):
    return [r.generated for r in reqs]


# -- engine -------------------------------------------------------------------

@pytest.mark.parametrize("arch,lengths", [
    ("internlm2-20b", (5, 12, 9, 17, 3)),
    ("recurrentgemma-9b", (5, 12, 9, 16, 3)),        # within the 16-token window
])
def test_paged_parity_token_for_token(arch, lengths):
    pair = Pair(arch)
    rng = np.random.default_rng(11)
    prompts = [pair.prompt(rng, n) for n in lengths]
    max_new = [6, 6, 6, 6, 21]                       # 3 + 21 crosses 2 page boundaries
    engines = pair.engines(batch_size=3, max_seq=64, paged=True, page_size=8,
                           pool_pages=48)
    jreqs, treqs = run_both(engines, prompts, max_new)
    assert tokens(treqs) == tokens(jreqs)
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    # paging changes where the bytes live, never what attention reads
    contiguous = ServingEngine(pair.tcfg, params=pair.tparams, device="cpu", batch_size=3,
                               max_seq=64)
    reqs = [contiguous.submit(Request(f"c{i}", p, max_new_tokens=m))
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    contiguous.drain()
    assert tokens(reqs) == tokens(treqs)
    if arch == "recurrentgemma-9b":
        # no pageable leaves: paged mode falls back to slot-granular
        assert engines[1].pool_stats() == engines[0].pool_stats() == {}
    else:
        assert engines[1].pool_stats() == engines[0].pool_stats()
        assert engines[1].pool_stats()["pool_pages"] == 48


def test_prefix_reuse_parity_and_suffix_only_prefill(attn_pair):
    rng = np.random.default_rng(12)
    common = attn_pair.prompt(rng, 24)
    prompts = [np.concatenate([common, attn_pair.prompt(rng, 4 + i)]) for i in range(4)]
    engines = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8,
                                pool_pages=64)
    prefilled = ([], [])
    for eng, seen in zip(engines, prefilled):
        eng.on_prefill_ms = lambda n, ms, seen=seen: seen.append(n)
    jreqs, treqs = run_both(engines, prompts, [5] * 4)
    assert tokens(treqs) == tokens(jreqs)
    assert prefilled[1] == prefilled[0]
    # the first request prefills everything, the sharers only their suffix
    assert prefilled[1][0] == len(prompts[0])
    assert all(t <= len(p) - 24 for t, p in zip(prefilled[1][1:], prompts[1:]))
    assert engines[1].pool_stats() == engines[0].pool_stats()
    assert engines[1].pool_stats()["prefix_hit_rate"] > 0.5
    for p in prompts:
        assert engines[1].cached_prefix_tokens(p) == engines[0].cached_prefix_tokens(p) >= 24


def test_request_longer_than_slot_granular_cap_completes(attn_pair):
    """Same KV budget (64 cacheable tokens): the slot-granular engine caps a
    request at 32 tokens; the paged engine serves one of 49 in 7 of its 8
    pages."""
    rng = np.random.default_rng(13)
    prompt = attn_pair.prompt(rng, 40)
    old = ServingEngine(attn_pair.tcfg, params=attn_pair.tparams, device="cpu",
                        batch_size=2, max_seq=32)
    with pytest.raises(AdmissionRefused) as ei:
        old.submit(Request("long", prompt, max_new_tokens=9))
    assert ei.value.code == ErrorCode.BAD_REQUEST
    engines = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8,
                                pool_pages=8, prefix_sharing=False)
    (jr,), (tr,) = run_both(engines, [prompt], [9])
    assert tr.done and tr.generated == jr.generated
    [ref] = ServingEngine(attn_pair.tcfg, params=attn_pair.tparams, device="cpu",
                          batch_size=1, max_seq=64).generate(
        [Request("ref", prompt, max_new_tokens=9)])
    assert tr.generated == ref.generated
    assert engines[1].audit_pages()["used"] == 0


def test_pool_exhaustion_refuses_queue_saturated(attn_pair):
    engines = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8,
                                pool_pages=8, prefix_sharing=False)
    refusals = []
    for eng, req, refused in zip(engines, (JaxRequest, Request),
                                 (JaxAdmissionRefused, AdmissionRefused)):
        rng = np.random.default_rng(14)
        held = [eng.submit(req(f"h{i}", attn_pair.prompt(rng, 20), max_new_tokens=12))
                for i in range(2)]
        backlog = eng.backlog_tokens()
        with pytest.raises(refused) as ei:
            eng.submit(req("over", attn_pair.prompt(rng, 20), max_new_tokens=12))
        refusals.append(ei.value)
        assert eng.backlog_tokens() == backlog        # the refusal touched no state
        eng.drain()
        assert all(r.done for r in held)
        # capacity freed: the refused request now admits and completes
        again = eng.submit(req("retry", attn_pair.prompt(rng, 20), max_new_tokens=12))
        eng.drain()
        assert again.done and len(again.generated) == 12
        assert eng.audit_pages() == {"pool_pages": 8, "used": 0, "free": 8, "reserved": 0}
    jax_err, err = refusals
    assert err.code == ErrorCode.QUEUE_SATURATED
    assert err.code.value == jax_err.code.value
    assert err.message == jax_err.message and "queue saturated" in err.message
    assert sorted(err.detail) == sorted(jax_err.detail)
    assert err.detail["retry_after_s"] > 0
    assert {k: v for k, v in err.detail.items() if k != "retry_after_s"} == \
        {k: v for k, v in jax_err.detail.items() if k != "retry_after_s"}


def test_no_page_leaks_after_drain_and_flush(attn_pair):
    rng = np.random.default_rng(15)
    engines = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8,
                                pool_pages=64)
    jreqs, treqs = run_both(engines, [attn_pair.prompt(rng, n) for n in (5, 12, 9)],
                            [4, 4, 4])
    assert tokens(treqs) == tokens(jreqs)
    # after drain the only live pages are the prefix cache's references
    audit = engines[1].audit_pages()
    assert audit == engines[0].audit_pages()
    assert audit["reserved"] == 0
    assert audit["used"] == engines[1].pool_stats()["pool_pages_used"] == len(
        engines[1]._prefix)
    for eng in engines:
        eng.flush()
    assert engines[1].audit_pages() == engines[0].audit_pages()
    assert engines[1].audit_pages()["used"] == 0


def test_flush_releases_reservations_of_queued_work(attn_pair):
    rng = np.random.default_rng(16)
    _, eng = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8,
                               pool_pages=8, prefix_sharing=False)
    for i in range(2):
        eng.submit(Request(f"q{i}", attn_pair.prompt(rng, 20), max_new_tokens=12))
    assert eng.audit_pages()["reserved"] == 8
    eng.flush()
    assert eng.audit_pages() == {"pool_pages": 8, "used": 0, "free": 8, "reserved": 0}
    assert eng.backlog_tokens() == 0


def test_backlog_counts_unprefilled_prompt_tokens(attn_pair):
    rng = np.random.default_rng(17)
    engines = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8)
    prompts = [attn_pair.prompt(rng, 10), attn_pair.prompt(rng, 7)]
    for eng, req in zip(engines, (JaxRequest, Request)):
        eng.submit(req("a", prompts[0], max_new_tokens=4))
        eng.submit(req("b", prompts[1], max_new_tokens=3))
    assert engines[1].backlog() == engines[0].backlog() == {"prefill_tokens": 17,
                                                            "decode_tokens": 7}
    assert engines[1].backlog_tokens() == 24
    engines[1].step()                                # both admitted, one token each
    assert engines[1].backlog() == {"prefill_tokens": 0, "decode_tokens": 3}
    engines[1].drain()
    assert engines[1].backlog_tokens() == 0


def test_engine_stamps_requests_on_injected_clock(attn_pair):
    clk = VirtualClock()
    _, eng = attn_pair.engines(batch_size=2, max_seq=64, paged=True, page_size=8, clock=clk)
    r = eng.submit(Request("v", attn_pair.prompt(np.random.default_rng(18), 6),
                           max_new_tokens=3))
    clk.advance(1.5)                                 # queue wait, in virtual time
    eng.drain()
    assert r.arrived_s == 0.0
    assert r.first_token_s == pytest.approx(1.5)
    assert r.ttft_ms == pytest.approx(1500.0)
    assert r.finished_s == pytest.approx(1.5) and r.done


def test_paged_whisper_matches_jax_with_the_kernel():
    """Paged whisper-large-v3 with ``use_pallas=True``: JAX's encoder through
    its Pallas kernel in interpret mode, the port's through K1's plain
    version.  Cross K/V stay resident; encdec has no prefix cache."""
    pair = Pair("whisper-large-v3", use_pallas=True)
    rng = np.random.default_rng(19)
    prompts = [pair.prompt(rng, n) for n in (5, 7, 5)]
    engines = pair.engines(batch_size=2, max_seq=32, paged=True, page_size=4)
    jreqs, treqs = run_both(engines, prompts, [6, 3, 9])
    assert tokens(treqs) == tokens(jreqs)
    stats = engines[1].pool_stats()
    assert stats == engines[0].pool_stats() and "prefix_hit_rate" not in stats
    assert engines[1].audit_pages()["used"] == 0


# -- functions ----------------------------------------------------------------

def _tree(leaves, lib):
    """{"blocks": {...}, "prefix": {...}} of numpy leaves as jnp or torch."""
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {g: {k: {n: conv(np.ascontiguousarray(a)) for n, a in layer.items()}
                for k, layer in grp.items()} for g, grp in leaves.items()}


def _np(tree):
    return {g: {k: {n: np.asarray(a) for n, a in layer.items()} for k, layer in grp.items()}
            for g, grp in tree.items()}


def test_write_prefill_paged_and_gather_pages_match_jax():
    """A stacked pageable group beside a resident cross leaf, and an
    unstacked pageable layer: scatter of a 13-token prefill into 4 pages of
    4 (zero-padded), then a gather of 3 of them."""
    rng = np.random.default_rng(20)
    reps, P, ps, K, hd, B, T = 2, 9, 4, 2, 8, 3, 5
    flags = {"blocks": {"0": {"k": True, "v": True, "cross_k": False}},
             "prefix": {"0": {"k": True, "v": True}}}
    cache = {"blocks": {"0": {"k": rng.normal(size=(reps, P + 1, ps, K, hd)),
                              "v": rng.normal(size=(reps, P + 1, ps, K, hd)),
                              "cross_k": rng.normal(size=(reps, B, T, 4, hd))}},
             "prefix": {"0": {"k": rng.normal(size=(P + 1, ps, K, hd)),
                              "v": rng.normal(size=(P + 1, ps, K, hd))}}}
    pre = {"blocks": {"0": {"k": rng.normal(size=(reps, 1, 13, K, hd)),
                            "v": rng.normal(size=(reps, 1, 13, K, hd)),
                            "cross_k": rng.normal(size=(reps, 1, T, 4, hd))}},
           "prefix": {"0": {"k": rng.normal(size=(1, 13, K, hd)),
                            "v": rng.normal(size=(1, 13, K, hd))}}}
    cache = {g: {k: {n: a.astype(np.float32) for n, a in layer.items()}
                 for k, layer in grp.items()} for g, grp in cache.items()}
    pre = {g: {k: {n: a.astype(np.float32) for n, a in layer.items()}
               for k, layer in grp.items()} for g, grp in pre.items()}
    pages, slot = [7, 2, 9, 4], 1
    want = _np(jcu.write_prefill_paged(flags, _tree(cache, "jax"), _tree(pre, "jax"),
                                       pages, [slot], 13, ps))
    tcache = _tree(cache, "torch")
    got = tcu.write_prefill_paged(flags, tcache, _tree(pre, "torch"), pages, slot, 13, ps)
    assert got is tcache                                # written in place
    for g in want:
        for n in want[g]["0"]:
            np.testing.assert_array_equal(got[g]["0"][n].numpy(), want[g]["0"][n])
    gflags = {"blocks": {"0": {"k": True, "v": True}}, "prefix": {"0": {"k": True, "v": True}}}
    gcache = {g: {"0": {n: got[g]["0"][n] for n in ("k", "v")}} for g in got}
    jg = jcu.gather_pages(gflags, {g: {"0": {n: jnp.asarray(t.numpy()) for n, t in
                                             layer["0"].items()}} for g, layer in gcache.items()},
                          [2, 9, 4])
    tg = tcu.gather_pages(gflags, gcache, [2, 9, 4])
    for g in jg:
        for n in ("k", "v"):
            np.testing.assert_array_equal(tg[g]["0"][n].numpy(), np.asarray(jg[g]["0"][n]))
    assert tg["blocks"]["0"]["k"].shape == (reps, 1, 12, K, hd)
    with pytest.raises(ValueError, match="non-paged"):
        tcu.gather_pages({"prefix": {"0": {"k": False}}}, {"prefix": {"0": {"k": gcache[
            "prefix"]["0"]["k"]}}}, [1])


def _mixer_params(pair):
    """Layer 0's attention params as (jax dict, torch dict)."""
    flat = {k.rsplit("/", 1)[-1]: v[0] for k, v in pair.flat.items()
            if k.startswith("decoder/blocks/0/mixer/")}
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in flat.items()})


def test_pool_rows_sharing_a_slot_write_the_last_rows_value():
    """Dead rows all write the null page's first slot: the slot gets the
    last such row's value (the reference's in-order scatter), whatever
    order the writes run in; the other rows write their own slots."""
    pool = torch.zeros((3, 4, 2))
    pid, off = torch.tensor([0, 2, 0, 0]), torch.tensor([0, 1, 0, 0])
    values = torch.arange(8.0).reshape(4, 2)
    tattn.write_pool_rows(pool, pid, off, values)
    assert torch.equal(pool[0, 0], values[3]) and torch.equal(pool[2, 1], values[1])
    assert int((pool != 0).any(-1).sum()) == 2


def test_paged_decode_attention_matches_jax(attn_pair):
    """Rows on their own timelines, a dead row (pos 0, table all null), a
    row whose table is zero past its pages; the write lands in the pool in
    place at the same page and offset as JAX's."""
    cfg, jcfg = attn_pair.tcfg, attn_pair.jcfg
    jp, tp = _mixer_params(attn_pair)
    rng = np.random.default_rng(21)
    ps, P, K, hd = 4, 12, cfg.num_kv_heads, cfg.resolved_head_dim
    pool = rng.normal(size=(2, P + 1, ps, K, hd)).astype(np.float32)
    pool[:, 0] = 0.0                                    # the null page
    tables = np.array([[3, 5, 7, 0], [0, 0, 0, 0], [2, 9, 11, 4], [6, 0, 0, 0]], np.int32)
    pos = np.array([9, 0, 15, 2], np.int32)
    x = rng.normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jattn.paged_decode_attention(jcfg, jp, jnp.asarray(x),
                                          {"k": jnp.asarray(pool[0]), "v": jnp.asarray(pool[1])},
                                          jnp.asarray(pos), jnp.asarray(tables), page_size=ps)
    tk, tv = torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy())
    ty, tc = tattn.paged_decode_attention(cfg, tp, torch.from_numpy(x), {"k": tk, "v": tv},
                                          torch.from_numpy(pos).long(),
                                          torch.from_numpy(tables).long(), page_size=ps)
    assert tc["k"] is tk and tc["v"] is tv
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    live = np.ones(P + 1, bool)
    live[0] = False                                     # dead rows race on the null page
    for name, t in (("k", tk), ("v", tv)):
        np.testing.assert_allclose(t.numpy()[live], np.asarray(jc[name])[live],
                                   rtol=2e-5, atol=2e-5)
    assert np.isfinite(tk.numpy()).all()


def test_prefill_attention_with_past_matches_jax(attn_pair):
    cfg, jcfg = attn_pair.tcfg, attn_pair.jcfg
    jp, tp = _mixer_params(attn_pair)
    rng = np.random.default_rng(22)
    K, hd, past_len, S = cfg.num_kv_heads, cfg.resolved_head_dim, 24, 7
    past = {n: rng.normal(size=(1, past_len, K, hd)).astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    pos = past_len + np.arange(S)
    jy, jkv = jattn.prefill_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                      past={n: jnp.asarray(a) for n, a in past.items()},
                                      past_len=past_len)
    ty, tkv = tattn.prefill_attention(cfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                      past={n: torch.from_numpy(a) for n, a in past.items()},
                                      past_len=past_len)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    for n in ("k", "v"):
        assert tkv[n].shape == (1, S, K, hd)            # the suffix's K/V only
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]), rtol=2e-5, atol=2e-5)


def test_prefill_past_and_paged_decode_steps_match_jax(attn_pair):
    """A 16-token prefix prefilled, written into pages, gathered back as
    ``past``; the suffix prefilled against it; then 6 paged decode steps
    growing into a new page — every step's logits against JAX's."""
    cfg, jcfg = attn_pair.tcfg, attn_pair.jcfg
    jparams, tparams = attn_pair.jparams, attn_pair.tparams
    rng = np.random.default_rng(23)
    ps, pool_pages, prefix, S = 8, 8, 16, 21
    prompt = attn_pair.prompt(rng, S)
    jcache = jax_cache_paged(jcfg, 2, 64, pool_pages, ps)
    tcache = decode_cache_paged(cfg, 2, 64, pool_pages, ps, "cpu")
    jfl, tfl = jax_flags(jcfg), paged_cache_flags(cfg)
    assert tfl == jfl
    shared, fresh, slot = [3, 6], [1], 1
    pre = {"tokens": prompt[None, :prefix]}
    jpc, _ = jax_prefill(jcfg)(jparams, {"tokens": jnp.asarray(pre["tokens"])})
    tpc, _ = build_prefill_step(cfg)(tparams, {"tokens": torch.from_numpy(pre["tokens"]).long()})
    jcache = jcu.write_prefill_paged(jfl, jcache, jpc, shared, [slot], prefix, ps)
    tcu.write_prefill_paged(tfl, tcache, tpc, shared, slot, prefix, ps)
    jpast = jcu.gather_pages(jfl, jcache, shared)
    tpast = tcu.gather_pages(tfl, tcache, shared)
    suffix = prompt[None, prefix:]
    jsc, jl = jax_prefill_past(jcfg)(jparams, {"tokens": jnp.asarray(suffix)}, jpast)
    tsc, tl = build_prefill_past_step(cfg)(tparams, {"tokens": torch.from_numpy(suffix).long()},
                                           tpast)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jcache = jcu.write_prefill_paged(jfl, jcache, jsc, fresh, [slot], S - prefix, ps)
    tcu.write_prefill_paged(tfl, tcache, tsc, fresh, slot, S - prefix, ps)
    jstep, tstep = jax_decode_paged(jcfg, ps), build_decode_step_paged(cfg, ps)
    tables = np.zeros((2, 4), np.int32)
    tables[slot, :3] = shared + fresh
    tok = np.array([[0], [int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    for step in range(6):
        pos = np.array([0, S + step], np.int32)
        if (S + step) // ps == 3:
            tables[slot, 3] = 5                         # growth into a new page
        jcache, jl = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(tables))
        tcache, tl = tstep(tparams, tcache, torch.from_numpy(tok).long(),
                           torch.from_numpy(pos).long(), torch.from_numpy(tables).long())
        np.testing.assert_allclose(tl[slot].numpy(), np.asarray(jl)[slot], **LOGIT_TOL)
        tok = np.array([[0], [int(np.argmax(np.asarray(jl)[slot]))]], np.int32)
    assert tables[slot, 3] == 5


# -- kv_pages copy ------------------------------------------------------------

def _drive(mod, seed, n_ops=300):
    """One random operation sequence on one copy of ``kv_pages``; returns
    everything it observed, errors by type and text."""
    rng = np.random.default_rng(seed)
    pool = mod.PagePool(24, 4)
    cache = mod.PrefixCache(pool)
    base = rng.integers(1, 50, size=40).astype(np.int32)
    held, log = [], []
    for _ in range(n_ops):
        op = rng.integers(0, 8)
        try:
            if op == 0:
                log.append(("reserve", pool.reserve(int(rng.integers(0, 10)))))
            elif op == 1:
                log.append(("unreserve", pool.unreserve(int(rng.integers(0, 6)))))
            elif op == 2:
                pages = pool.alloc(int(rng.integers(0, 6)))
                held += pages
                log.append(("alloc", pages))
            elif op == 3 and held:
                pid = held.pop(int(rng.integers(0, len(held))))
                log.append(("decref", pid, pool.decref(pid)))
            elif op == 4:
                # prompts share base's prefix at a random depth
                n = int(rng.integers(1, 40))
                cut = int(rng.integers(0, n + 1))
                prompt = np.concatenate([base[:cut],
                                         rng.integers(1, 50, size=n - cut).astype(np.int32)])
                k, pages = cache.lookup(prompt, 4)
                held += pages
                log.append(("lookup", k, pages, cache.probe(prompt, 4)))
                fresh = pool.alloc(-(-n // 4) - k)
                held += fresh
                log.append(("insert", cache.insert(prompt, pages + fresh, 4)))
            elif op == 5:
                log.append(("evict", cache.evict_one()))
            elif op == 6 and held:
                pid = held[int(rng.integers(0, len(held)))]
                held.append(pid)
                log.append(("incref", pool.incref(pid)))
            elif op == 7 and rng.random() < 0.1:
                cache.flush()
                log.append(("flush", len(cache)))
        except (mod.PoolExhausted, AssertionError, ValueError) as e:
            log.append(("error", type(e).__name__, str(e)))
        log.append(("state", pool.audit(), round(cache.hit_rate(), 12),
                    {pid: pool.refcount(pid) for pid in range(25)}))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_kv_pages_copy_matches_reference(seed):
    got, want = _drive(tkv, seed), _drive(jkv, seed)
    assert got == want
    assert any(entry[0] == "error" for entry in got)      # the error paths ran too
    assert any(entry[0] == "lookup" and entry[1] > 0 for entry in got)
