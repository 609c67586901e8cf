"""PyTorch port, serving slice: the port's ``ServingEngine`` on
``device="cpu"`` against the JAX ``ServingEngine`` with the same parameters.
Greedy tokens must be identical for fixed-batch ``generate`` and for
continuous ``submit``/``step``/``drain`` with mixed prompt lengths and slot
reuse, and both engines must refuse the same malformed requests with the
same ``BAD_REQUEST`` text.  At most three prompt lengths per engine keep the
JAX recompiles cheap."""
import threading

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.errors import AdmissionRefused as JaxAdmissionRefused
from repro.core.simclock import VirtualClock
from repro.models import model_specs as jax_model_specs
from repro.models.common import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.core.errors import AdmissionRefused, ErrorCode
from repro_torch.serving import Request, ServingEngine
from repro_torch.weights import params_from_jax

MAX_SEQ = 32
CASES = [("whisper-large-v3", True), ("internlm2-20b", False)]


@pytest.fixture(scope="module", params=CASES, ids=[a for a, _ in CASES])
def pair(request):
    """(JAX engine factory, port engine factory, vocab) over shared params."""
    arch, use_pallas = request.param
    jcfg = jax_reduced(jax_get_config(arch), use_pallas=use_pallas)
    tcfg = reduced(get_config(arch), use_pallas=use_pallas)
    flat = _flatten(jax_init_params(jax_model_specs(jcfg), seed=1))
    if jcfg.family == "encdec":
        # with zero frames and a 0.02-scale embedding the position embedding
        # swamps the prompt; a larger embedding makes tokens depend on it
        flat["embed"] = flat["embed"] * 30.0
    jparams = _unflatten_jax(flat)
    tparams = params_from_jax(flat, device="cpu")

    def jax_engine(batch_size):
        return JaxServingEngine(jcfg, params=jparams, batch_size=batch_size,
                                max_seq=MAX_SEQ)

    def port_engine(batch_size, **kw):
        return ServingEngine(tcfg, params=tparams, device="cpu",
                             batch_size=batch_size, max_seq=MAX_SEQ, **kw)

    return jax_engine, port_engine, tcfg.vocab_size


def _unflatten_jax(flat):
    import jax.numpy as jnp
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


def test_generate_matches_jax(pair):
    jax_engine, port_engine, vocab = pair
    prompts = _prompts(vocab, [5, 7], seed=0)
    budgets = [6, 3]
    ref = jax_engine(2).generate([JaxRequest(f"g{i}", p, max_new_tokens=m)
                                  for i, (p, m) in enumerate(zip(prompts, budgets))])
    eng = port_engine(2)
    out = eng.generate([Request(f"g{i}", p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, budgets))])
    assert [r.generated for r in out] == [r.generated for r in ref]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in out)
    assert eng.metrics["tokens"] == sum(budgets)
    assert eng.metrics["decode_steps"] == max(budgets) - 1


def test_continuous_matches_jax_with_slot_reuse(pair):
    jax_engine, port_engine, vocab = pair
    shapes = [(5, 3), (7, 6), (5, 1), (7, 4), (5, 5)]       # > 2x slots: reuse
    prompts = _prompts(vocab, [n for n, _ in shapes], seed=1)
    jeng, teng = jax_engine(2), port_engine(2)
    jreqs = [jeng.submit(JaxRequest(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    treqs = [teng.submit(Request(f"r{i}", p, max_new_tokens=m))
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    jeng.drain()
    teng.drain()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    assert teng.metrics["tokens"] == sum(m for _, m in shapes)
    assert teng.metrics["requests"] == len(shapes) and teng.live_slots() == 0


def test_refusals_match_jax(pair):
    jax_engine, port_engine, _ = pair
    jeng, teng = jax_engine(2), port_engine(2)
    bad = [("long", np.ones(MAX_SEQ + 8, np.int32), 8),
           ("empty", np.zeros(0, np.int32), 8),
           ("zero", np.ones(4, np.int32), 0),
           ("ovf", np.ones(MAX_SEQ - 2, np.int32), 10)]
    for rid, prompt, m in bad:
        with pytest.raises(JaxAdmissionRefused) as je:
            jeng.submit(JaxRequest(rid, prompt, max_new_tokens=m))
        with pytest.raises(AdmissionRefused) as te:
            teng.submit(Request(rid, prompt, max_new_tokens=m))
        assert te.value.code == ErrorCode.BAD_REQUEST
        assert te.value.code.value == je.value.code.value
        assert str(te.value) == str(je.value)
    group = [Request(f"x{i}", np.ones(4, np.int32)) for i in range(3)]
    jgroup = [JaxRequest(f"x{i}", np.ones(4, np.int32)) for i in range(3)]
    with pytest.raises(JaxAdmissionRefused) as je:
        jeng.generate(jgroup)
    with pytest.raises(AdmissionRefused) as te:
        teng.generate(group)
    assert str(te.value) == str(je.value)
    assert teng.backlog_tokens() == 0


def test_hooks_clock_and_driver_thread(pair):
    _, port_engine, vocab = pair
    clock = VirtualClock()                  # any object with the Clock methods
    eng = port_engine(2, clock=clock)
    seen = {"prefill": [], "step": 0, "done": []}
    eng.on_prefill_ms = lambda n, ms: seen["prefill"].append(n)
    eng.on_step_ms = lambda ms: seen.__setitem__("step", seen["step"] + 1)
    all_done = threading.Event()
    eng.on_complete = lambda r: (seen["done"].append(r.request_id),
                                 all_done.set() if len(seen["done"]) == 3 else None)
    refused = []

    def admission(r, engine):
        if r.request_id == "no":
            refused.append(r.request_id)
            raise AdmissionRefused(ErrorCode.DEADLINE, f"{r.request_id}: over deadline budget")

    eng.admission = admission
    with pytest.raises(AdmissionRefused) as ei:
        eng.submit(Request("no", np.ones(4, np.int32)))
    assert ei.value.code == ErrorCode.DEADLINE and eng.backlog_tokens() == 0
    stop = threading.Event()
    driver = threading.Thread(target=eng.serve_forever, args=(stop,), daemon=True)
    driver.start()
    reqs = [eng.submit(Request(f"p{i}", p, max_new_tokens=3))
            for i, p in enumerate(_prompts(vocab, [5, 5, 5], seed=2))]
    assert all_done.wait(60.0), "driver thread did not finish the queue"
    stop.set()
    eng.wake()
    driver.join(timeout=5.0)
    assert not driver.is_alive()
    assert sorted(seen["done"]) == ["p0", "p1", "p2"] and seen["prefill"] == [5, 5, 5]
    assert seen["step"] == eng.metrics["decode_steps"] > 0
    assert all(r.ttft_ms == 0.0 for r in reqs)           # virtual time stood still
    eng.flush()
    assert eng.live_slots() == 0 and eng.backlog_tokens() == 0


def test_engine_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    cfg = reduced(get_config("internlm2-20b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, paged=True)
    # the paged layout runs on the CPU when asked, with the default pool
    eng = ServingEngine(cfg, device="cpu", paged=True)
    assert eng.pool_stats()["pool_pages"] == eng.batch_size * -(-eng.max_seq // 16)


def test_decode_graphs_need_a_card():
    cfg = reduced(get_config("internlm2-20b"))
    with pytest.raises(ValueError, match="decode_graphs=True needs a CUDA device"):
        ServingEngine(cfg, device="cpu", decode_graphs=True)
    assert not ServingEngine(cfg, device="cpu").decode_graphs
    assert not ServingEngine(cfg, device="cpu", decode_graphs=False).decode_graphs


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_flushed_engine_serves_as_a_fresh_one(pair, paged):
    """``flush`` zeroes the decode cache in place (a graphed engine's graphs
    bind its buffers): an engine flushed mid-trace serves the same tokens
    as a fresh engine on the same parameters."""
    _, port_engine, vocab = pair
    prompts = _prompts(vocab, [5, 9, 5, 7], seed=4)
    budgets = [6, 3, 8, 5]

    def serve(eng):
        reqs = [eng.submit(Request(f"f{i}", p, max_new_tokens=m))
                for i, (p, m) in enumerate(zip(prompts, budgets))]
        eng.drain()
        return [r.generated for r in reqs]

    want = serve(port_engine(2, paged=paged))
    eng = port_engine(2, paged=paged)
    for i, p in enumerate(prompts[:3]):
        eng.submit(Request(f"x{i}", p[::-1].copy(), max_new_tokens=9))
    for _ in range(4):
        eng.step()
    cache = eng._cb_cache
    eng.flush()
    assert eng._cb_cache is cache and eng.live_slots() == 0 and eng.backlog_tokens() == 0
    assert all(not leaf.any() for leaf in _leaves(cache))
    assert serve(eng) == want


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]
