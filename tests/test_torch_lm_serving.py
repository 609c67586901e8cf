"""PyTorch port, LM serving substrate: ``repro_torch.substrates.LmServingAdapter``
on a ``repro`` control plane, against the reference's ``LmServingAdapter``.

The plane drives the port's adapter duck-typed.  Its refusals reach the
plane as the plane's own ``AdmissionRefused`` through the ``refusal=``
keyword (ROADMAP C4): the port imports nothing of ``repro``, and the plane
catches refusals by class.  The reference's four adapter tests
(``tests/test_serving.py``) run here on the port's adapter, on the CPU with
the reduced fp32 internlm2-20b; with parameters carried by
``params_from_jax`` both resources on one plane answer the same tasks with
the same greedy tokens."""
import types

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.errors import AdmissionRefused as JaxAdmissionRefused
from repro.core.errors import ErrorCode as JaxErrorCode
from repro.core.orchestrator import Orchestrator
from repro.core.tasks import TaskRequest
from repro.models import model_specs as jax_model_specs
from repro.models.common import init_params as jax_init_params
from repro.substrates import LmServingAdapter as JaxLmServingAdapter
from repro.training.checkpoint import _flatten
from repro_torch.core.errors import AdmissionRefused, ErrorCode
from repro_torch.serving import Request
from repro_torch.substrates import LmServingAdapter
from repro_torch.weights import params_from_jax

MAX_SEQ = 64
DETAIL_KEYS = {"predicted_ms", "remaining_ms", "backlog_tokens", "backlog_prefill_tokens",
               "prefix_cached_tokens"}


def plane_refusal(code, message, detail):
    """What a host that imports both packages passes as ``refusal=``."""
    return JaxAdmissionRefused(JaxErrorCode(code), message, detail)


def _task(task_id, prompt_len=6, max_new=4, budget_ms=None, prefer=None):
    return TaskRequest(
        task_id=task_id, function="generate",
        input_modality="tokens", output_modality="tokens",
        payload={"prompt": list(range(1, prompt_len + 1)),
                 "max_new_tokens": max_new},
        latency_budget_ms=budget_ms, backend_preference=prefer)


@pytest.fixture(scope="module")
def serving_orchestrator():
    orch = Orchestrator(plane="serving-test")
    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu",
                               refusal=plane_refusal)
    orch.register(adapter)
    yield orch, adapter
    adapter.close()


@pytest.mark.parametrize("paged", [False, True])
def test_descriptor_matches_reference(paged):
    port = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu", paged=paged,
                            page_size=8).descriptor().to_dict()
    ref = JaxLmServingAdapter(batch_size=2, max_seq=MAX_SEQ, paged=paged,
                              page_size=8).descriptor().to_dict()
    assert port["resource_id"] == "lm-serving-torch-internlm2-20b"
    assert port["twin_binding"] == "twin-lm-serving-torch-internlm2-20b"
    for key in ("resource_id", "twin_binding", "description"):
        port.pop(key)
        ref.pop(key)
    assert port == ref


def test_adapter_serves_with_telemetry(serving_orchestrator):
    orch, adapter = serving_orchestrator
    res, trace = orch.execute(_task("ok-1"))
    assert res.status == "completed"
    assert trace.selected == adapter.resource_id
    assert len(res.output["tokens"]) == 4
    for field in ("ttft_ms", "tokens_per_s", "step_ms", "drift_score"):
        assert field in res.telemetry
    assert res.telemetry["deadline_expired"] is False


def test_adapter_refuses_doomed_deadline_as_structured_DEADLINE(serving_orchestrator):
    orch, adapter = serving_orchestrator
    res, trace = orch.execute(_task("doom-1", max_new=40, budget_ms=0.2))
    assert res.status == "rejected"
    assert res.error_code == JaxErrorCode.DEADLINE.value
    assert "deadline budget" in trace.rejected_reason
    # a refusal is admission control, not substrate failure: the plane's
    # health record counts no failed attempt, and the next request serves
    health = orch.health.status()[adapter.resource_id]
    assert health["error_rate"] == 0.0 and health["consecutive_failures"] == 0
    assert health["state"] == "healthy"
    res2, _ = orch.execute(_task("ok-2"))
    assert res2.status == "completed"


def test_adapter_rejects_overlong_prompt_as_BAD_REQUEST(serving_orchestrator):
    orch, _ = serving_orchestrator
    res, _ = orch.execute(_task("long-1", prompt_len=MAX_SEQ + 10))
    assert res.status == "rejected"
    assert res.error_code == JaxErrorCode.BAD_REQUEST.value


def test_adapter_descriptor_and_twin(serving_orchestrator):
    orch, adapter = serving_orchestrator
    desc = adapter.descriptor()
    assert "generate" in desc.capability.functions
    assert desc.capability.input_signal.modality == "tokens"
    twin = orch.twins.get(adapter.resource_id)
    assert twin is not None and twin.surrogate is not None
    sim = twin.surrogate.simulate(_task("sim-1"))
    assert sim["output"]["predicted"] is True
    assert sim["telemetry"]["step_ms"] > 0.0


@pytest.fixture(scope="module")
def both():
    """The reference's adapter and the port's, on one plane, serving the
    same parameters (the reference engine's own draw, carried across)."""
    jax_adapter = JaxLmServingAdapter(batch_size=2, max_seq=MAX_SEQ)
    flat = _flatten(jax_init_params(jax_model_specs(jax_reduced(jax_get_config(
        "internlm2-20b"))), 0))
    port = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu",
                            params=params_from_jax(flat, device="cpu"), refusal=plane_refusal)
    orch = Orchestrator(plane="two-resources")
    orch.register(jax_adapter)
    orch.register(port)
    yield orch, jax_adapter, port
    jax_adapter.close()
    port.close()


def test_both_resources_give_the_same_tokens(both):
    orch, jax_adapter, port = both
    for i, (n, m) in enumerate(((6, 4), (11, 7), (3, 9))):
        out = {}
        for adapter in (jax_adapter, port):
            res, trace = orch.execute(_task(f"t{i}-{adapter.resource_id}", n, m,
                                            prefer=adapter.resource_id))
            assert res.status == "completed" and trace.selected == adapter.resource_id
            out[adapter.resource_id] = res.output["tokens"]
        assert len(out[port.resource_id]) == m
        assert out[port.resource_id] == out[jax_adapter.resource_id]


def test_refusal_without_injection_is_the_ports_own(both):
    """Without ``refusal=`` the port raises its own ``AdmissionRefused``,
    with the reference's code and detail keys."""
    _, jax_adapter, _ = both
    own = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu")
    own.prepare(None)
    try:
        session = types.SimpleNamespace(task=_task("doom-2", max_new=40, budget_ms=0.2))
        with pytest.raises(AdmissionRefused) as port_err:
            own.invoke(session)
        with pytest.raises(JaxAdmissionRefused) as ref_err:
            jax_adapter.invoke(session)
    finally:
        own.close()
    assert not isinstance(port_err.value, JaxAdmissionRefused)
    assert port_err.value.code == ErrorCode.DEADLINE and port_err.value.code == "DEADLINE"
    assert set(port_err.value.detail) == set(ref_err.value.detail) == DETAIL_KEYS
    assert "deadline budget" in port_err.value.message


def test_refusal_without_injection_counts_as_a_failure_on_a_repro_plane():
    """The seam ``refusal=`` closes (ROADMAP C4): the plane catches
    refusals by its own class, so the port's falls through to its failure
    path.  The code still reads DEADLINE (the prose classifier), but the
    attempt is recorded as failed."""
    orch = Orchestrator(plane="no-injection")
    own = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu")
    orch.register(own)
    try:
        res, _ = orch.execute(_task("doom-3", max_new=40, budget_ms=0.2))
    finally:
        own.close()
    assert res.status == "rejected" and res.error_code == JaxErrorCode.DEADLINE.value
    assert orch.health.status()[own.resource_id]["consecutive_failures"] == 1


def test_adapter_snapshot_and_twin_state():
    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu", paged=True,
                               page_size=8)
    assert adapter.snapshot().extra == {}
    adapter.prepare(None)
    try:
        snap = adapter.snapshot()
        assert snap.resource_id == adapter.resource_id and snap.health_status == "healthy"
        # the calibration: an 8-token prefill and a second of max_seq // 4
        # tokens (ROADMAP C5), 4 tokens each, decoded together
        assert snap.extra["requests"] == 2 and snap.extra["live_slots"] == 0
        assert snap.extra["observed_prefills"] == 2 and snap.extra["observed_steps"] == 3
        assert snap.extra["prefill_fixed_ms"] >= 0.0
        assert snap.extra["prefill_ms_per_token"] >= snap.extra["prefill_lb_ms_per_token"]
        assert snap.extra["bytes_per_page"] > 0 and snap.extra["pool_pages"] == 16
        assert snap.to_dict()["age_of_information_ms"] == 0.0
        twin = adapter.make_twin()
        assert twin.twin_id == f"twin-{adapter.resource_id}" and twin.kind == "roofline"
        assert twin.valid(None) == (True, "ok")
        real = adapter.invoke(types.SimpleNamespace(task=_task("real", 6, 4)))
        sim = twin.surrogate.simulate(_task("sim", 6, 4))
        d = twin.surrogate.divergence(real["output"], sim["output"])
        assert 0.0 <= d <= 1.0
        adapter.reset()
        assert adapter.engine.live_slots() == 0 and adapter.engine.audit_pages()["used"] == 0
    finally:
        adapter.close()


def test_closed_adapter_frees_its_engine_without_the_cycle_collector():
    """ROADMAP C6: ``close`` drops the engine and the hooks that refer back
    to the adapter, so the engine (its parameters and cache) goes with the
    last outside reference, the cycle collector off."""
    import gc
    import weakref

    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu", paged=True,
                               page_size=8)
    adapter.prepare(None)
    adapter.invoke(types.SimpleNamespace(task=_task("c6", 6, 4)))
    held = adapter.engine
    engine, params = weakref.ref(held), weakref.ref(held.params["embed"])
    enabled = gc.isenabled()
    gc.disable()
    try:
        adapter.close()
        assert adapter.engine is None
        assert held.on_complete is None and held.admission is None
        del held
        assert engine() is None and params() is None
        del adapter
    finally:
        if enabled:
            gc.enable()


def test_twin_prices_the_backlog_of_the_bound_engine():
    """ROADMAP C7: the surrogate of a prepared adapter prices a request
    behind the live engine's backlog, as the admission check does, so a
    request submitted behind queued work costs more than one alone; the
    backlog it saw is reported.  A closed adapter's surrogate prices a lone
    request, as before, and holds no engine (cycle collector off)."""
    import gc
    import weakref

    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu")
    twin = adapter.make_twin()
    task = _task("price", 6, 4)
    lone = adapter.cost.predict_request_ms(6, 4)
    assert twin.surrogate.simulate(task)["output"]["predicted_total_ms"] == round(lone, 3)
    adapter.prepare(None)
    engine = adapter.engine
    try:
        idle = twin.surrogate.simulate(task)
        assert idle["telemetry"]["backlog_tokens"] == 0
        assert idle["output"]["predicted_total_ms"] == round(
            adapter.cost.predict_request_ms(6, 4), 3)
        with engine._lock:           # no step can run: the work stays queued
            for i in range(3):
                engine.submit(Request(f"queued-{i}", np.arange(1, 11, dtype=np.int32),
                                      max_new_tokens=8))
            busy = twin.surrogate.simulate(task)
        assert busy["telemetry"]["backlog_tokens"] == 24
        assert busy["telemetry"]["backlog_prefill_tokens"] == 30
        assert busy["telemetry"]["prefix_cached_tokens"] == 0
        assert busy["output"]["predicted_total_ms"] == round(adapter.cost.predict_request_ms(
            6, 4, 24, backlog_prefill_tokens=30), 3)
        assert busy["output"]["predicted_total_ms"] > idle["output"]["predicted_total_ms"]
    finally:
        adapter.close()
    held = weakref.ref(engine)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del engine
        assert held() is None
        closed = twin.surrogate.simulate(task)
        assert closed["telemetry"]["backlog_tokens"] == 0
        assert closed["output"]["predicted_total_ms"] == round(
            adapter.cost.predict_request_ms(6, 4), 3)
    finally:
        if enabled:
            gc.enable()


def test_twin_and_admission_check_price_alike():
    """ROADMAP C7: behind the same backlog, the twin's price is the one the
    admission check refuses a doomed deadline with, and the backlog the
    twin reports is the refusal's."""
    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu")
    twin = adapter.make_twin()
    adapter.prepare(None)
    engine = adapter.engine
    try:
        with engine._lock:           # no step can run: the work stays queued
            for i in range(3):
                engine.submit(Request(f"queued-{i}", np.arange(1, 11, dtype=np.int32),
                                      max_new_tokens=8))
            sim = twin.surrogate.simulate(_task("price", 6, 4))
            with pytest.raises(AdmissionRefused) as refused:
                engine.submit(Request("doomed", np.arange(1, 7, dtype=np.int32),
                                      max_new_tokens=4,
                                      deadline_s=adapter.clock.monotonic() + 1e-3))
        assert refused.value.code == ErrorCode.DEADLINE
        detail = refused.value.detail
        assert detail["predicted_ms"] == round(sim["output"]["predicted_total_ms"], 1)
        for key in ("backlog_tokens", "backlog_prefill_tokens", "prefix_cached_tokens"):
            assert detail[key] == sim["telemetry"][key]
    finally:
        adapter.close()


def test_twin_prices_a_prefix_hit_of_the_bound_engine():
    """ROADMAP C7: on a paged adapter with the prefix cache, the twin sees
    the pages a served prompt left cached and prices only the suffix of a
    prompt that shares them; a prompt that shares none is priced whole."""
    adapter = LmServingAdapter(batch_size=2, max_seq=MAX_SEQ, device="cpu", paged=True,
                               page_size=8)
    twin = adapter.make_twin()
    adapter.prepare(None)
    try:
        served = adapter.invoke(types.SimpleNamespace(task=_task("warm", 24, 2)))
        assert len(served["output"]["tokens"]) == 2
        adapter.engine.drain()
        hit = twin.surrogate.simulate(_task("hit", 24, 4))
        miss = twin.surrogate.simulate(types.SimpleNamespace(payload={
            "prompt": list(range(100, 124)), "max_new_tokens": 4}))
        assert hit["telemetry"]["prefix_cached_tokens"] == 16
        assert miss["telemetry"]["prefix_cached_tokens"] == 0
        assert hit["output"]["predicted_total_ms"] == round(
            adapter.cost.predict_request_ms(24, 4, cached_prefix_tokens=16), 3)
        assert miss["output"]["predicted_total_ms"] == round(
            adapter.cost.predict_request_ms(24, 4), 3)
    finally:
        adapter.close()
