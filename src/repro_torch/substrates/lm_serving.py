"""LM serving substrate: the port's serving engine as a plane member — the
port of ``repro/substrates/lm_serving.py``.

Exposes ``repro_torch.serving.ServingEngine`` (continuous batching, decode
steps as CUDA graphs on the card) through the same descriptor / twin
surface as every substrate: a task with ``function="generate"`` and
``modality="tokens"`` matches this resource and returns per-request TTFT /
tokens-per-second telemetry.

The roofline cost model (``repro_torch.roofline.serving.ServingCostModel``,
with the card's figures) is the admission oracle: before a request joins
the waiting queue its completion time is predicted from the
roofline-floored, measurement-tightened step cost and the engine's
backlog, and a request that cannot finish inside its deadline budget is
refused as a structured ``DEADLINE`` instead of timing out mid-decode.

One driver thread owns the decode loop (``ServingEngine.serve_forever``);
``invoke`` is called concurrently by many workers, each blocking on its
request's completion event.

Keywords beyond the reference's (each a deliberate difference):

- ``device`` — the card unless ``"cpu"`` is asked for;
- ``cfg`` — the configuration to serve (default ``reduced(get_config(arch))``,
  as in the reference);
- ``params`` — parameters to serve (default: drawn from ``seed``), so that
  several engines or adapters share one copy;
- ``refusal`` — ``(code value, message, detail) -> Exception``: when given,
  ``invoke`` re-raises the engine's ``AdmissionRefused`` through it, so a
  host whose plane catches refusals by its own class (a ``repro``
  ``Orchestrator`` catches ``repro.core.errors.AdmissionRefused``) sees a
  refusal and not a substrate failure.

The resource id is ``lm-serving-torch-{arch}``, so one plane can hold this
resource beside the reference's ``lm-serving-{arch}``.

Three behaviours differ from the reference's on purpose: ``prepare``'s
calibration prefills a second, longer prompt, so that the cost model fits
a prefill's fixed and per-token parts (ROADMAP C5); ``close`` lets go of
the engine, which the reference keeps in a reference cycle (ROADMAP C6);
and the twin prices a request behind the live engine's backlog, as the
admission check does, where the reference's prices it alone (ROADMAP C7).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import SYSTEM_CLOCK, Clock
from repro_torch.core.descriptors import (CapabilityDescriptor, LifecycleSemantics,
                                          Observability, PolicyConstraints,
                                          ResourceDescriptor, SignalSpec,
                                          TimingSemantics)
from repro_torch.core.errors import AdmissionRefused, ErrorCode
from repro_torch.core.telemetry import RuntimeSnapshot
from repro_torch.core.twin import TwinNotReady, TwinState, TwinSurrogate
from repro_torch.models import paged_support
from repro_torch.models.common import resolve_device
from repro_torch.roofline.serving import ServingCostModel
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.substrates.base import SubstrateAdapter

#: generous hard cap on how long one invoke may wait for its tokens (the
#: admission model bounds the realistic wait well below this)
MAX_WAIT_S = 120.0
#: the calibration's second prefill takes min(max_seq // 4, this) tokens
CALIBRATION_LONG_PREFILL = 512


def price_request(cost: ServingCostModel, engine: Optional[ServingEngine], prompt,
                  max_new_tokens: int) -> Tuple[float, Dict[str, int]]:
    """-> (predicted ms, the backlog it was priced behind) for a request
    joining ``engine`` now: the decode tokens owed to queued and live
    requests, the waiting prompts' tokens and the prompt's prefix-cache hit
    (a lone request's price with no engine).  The admission check and the
    twin both price this way (ROADMAP C7)."""
    seen = dict(backlog_tokens=0, backlog_prefill_tokens=0, prefix_cached_tokens=0)
    if engine is not None:
        backlog = engine.backlog()
        seen.update(backlog_tokens=backlog["decode_tokens"],
                    backlog_prefill_tokens=backlog["prefill_tokens"],
                    prefix_cached_tokens=engine.cached_prefix_tokens(prompt))
    pred_ms = cost.predict_request_ms(
        len(prompt), max_new_tokens, seen["backlog_tokens"],
        backlog_prefill_tokens=seen["backlog_prefill_tokens"],
        cached_prefix_tokens=seen["prefix_cached_tokens"])
    return pred_ms, seen


class ServingSurrogate(TwinSurrogate):
    """Executable serving twin = the admission cost model made answerable.

    It cannot produce real tokens (the surrogate holds no parameters), so a
    twin-served answer carries ``predicted: True`` with the cost model's
    timing estimates; divergence scores the *timing* prediction against
    real serves, which is exactly the fidelity the admission decision
    depends on.

    ``engine`` (a callable returning the live engine or ``None``) lets it
    price a request behind the backlog it would join — queued and in-flight
    decode tokens, the waiting prompts, the prompt's prefix-cache hit — as
    the adapter's admission check does.  It is read at every ``simulate``,
    so the surrogate holds no engine: with none bound (before ``prepare``,
    after ``close``) it prices a lone request."""

    kind = "roofline"
    tolerance = 0.5

    def __init__(self, cost: ServingCostModel,
                 engine: Callable[[], Optional[ServingEngine]]):
        self.cost = cost
        self.engine = engine

    def observe(self, task, raw: Dict) -> None:
        pass   # the cost model is fed live by the engine's step observers

    def simulate(self, task) -> Dict:
        payload = task.payload if isinstance(task.payload, dict) else {}
        prompt = payload.get("prompt") or []
        max_new = int(payload.get("max_new_tokens", 8))
        if not prompt:
            raise TwinNotReady("serving twin needs a prompt to price")
        pred_ms, seen = price_request(self.cost, self.engine(), prompt, max_new)
        step_ms = self.cost.step_ms()
        ttft_ms = self.cost.prefill_ms(len(prompt))
        tps = 1e3 / max(step_ms, 1e-9)
        return {
            "output": {"predicted": True, "tokens": [],
                       "predicted_total_ms": round(pred_ms, 3)},
            "telemetry": {
                "ttft_ms": round(ttft_ms, 3),
                "tokens_per_s": round(tps, 2),
                "step_ms": round(step_ms, 4),
                "drift_score": 0.0,
                "health_status": "healthy",
                "observation_ms": pred_ms,
                **seen,
            },
            "artifacts": {"cost_model": self.cost.snapshot()},
            "backend_ms": 0.0,
        }

    def divergence(self, real_output, twin_output) -> float:
        r = real_output if isinstance(real_output, dict) else {}
        t = twin_output if isinstance(twin_output, dict) else {}
        real_ms = r.get("total_ms")
        pred_ms = t.get("predicted_total_ms")
        if real_ms is None or pred_ms is None:
            return 1.0
        real_ms, pred_ms = float(real_ms), float(pred_ms)
        return float(min(1.0, abs(real_ms - pred_ms)
                         / max(real_ms, pred_ms, 1e-6)))


class LmServingAdapter(SubstrateAdapter):
    """Continuous-batching LM serving engine behind the substrate surface."""

    def __init__(self, arch: str = "internlm2-20b", *, batch_size: int = 4,
                 max_seq: int = 128, seed: int = 0,
                 max_concurrent: int = 256, safety: Optional[float] = None,
                 calibrate: bool = True, paged: bool = False,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 clock: Optional[Clock] = None, device=None, cfg=None,
                 params=None,
                 refusal: Optional[Callable[[str, str, Dict], Exception]] = None):
        super().__init__()
        self.arch = arch
        self.resource_id = f"lm-serving-torch-{arch}"
        self.cfg = cfg if cfg is not None else reduced(get_config(arch))
        self.device = resolve_device(device)
        self.params = params
        self.refusal = refusal
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.seed = seed
        self.max_concurrent = max_concurrent
        self.calibrate = calibrate
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.paged = paged
        self.page_size = page_size
        self.pool_pages = pool_pages
        self.prefix_sharing = prefix_sharing
        kw = {} if safety is None else {"safety": safety}
        if paged and paged_support(self.cfg)[0]:
            max_pages = -(-max_seq // page_size)
            self.pool_pages = (pool_pages if pool_pages is not None
                               else batch_size * max_pages)
            kw.update(page_size=page_size, pool_pages=self.pool_pages)
        self.cost = ServingCostModel(self.cfg, batch_size=batch_size,
                                     max_seq=max_seq, **kw)
        self.engine: Optional[ServingEngine] = None
        self._events: Dict[str, threading.Event] = {}
        self._events_lock = threading.Lock()
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None
        self._req_seq = 0

    # -- descriptor -----------------------------------------------------------
    def descriptor(self) -> ResourceDescriptor:
        step_ms = self.cost.step_ms()
        cap = CapabilityDescriptor(
            functions=("generate", "decode"),
            input_signal=SignalSpec("tokens", "int32_tokens",
                                    (0.0, float(self.cfg.vocab_size))),
            output_signal=SignalSpec("tokens", "int32_tokens",
                                     (0.0, float(self.cfg.vocab_size))),
            timing=TimingSemantics(
                "fast_ms",
                expected_latency_ms=max(
                    self.cost.predict_request_ms(16, 8), 1.0),
                observation_window_ms=max(step_ms, 1.0),
                freshness_ms=600_000.0),
            lifecycle=LifecycleSemantics(
                warmup_ms=2_000.0,        # first prefill + decode graph capture
                resetable=True,
                reset_modes=("flush_queue",),
                reset_cost_ms=100.0,
                recovery_modes=("flush_queue",)),
            programmability="configurable",
            observability=Observability(
                output_channels=("tokens",),
                telemetry_fields=("ttft_ms", "tokens_per_s", "step_ms",
                                  "drift_score"),
                drift_indicators=("drift_score", "step_ms"),
                twin_linked_fields=("step_ms", "ttft_ms")),
            policy=PolicyConstraints(exclusive=False,
                                     max_concurrent=self.max_concurrent),
            supports_repeated_invocation=True,
        )
        kv = (f"paged kv pool={self.pool_pages}x{self.page_size}tok"
              if self.paged and self.pool_pages else "slot-granular kv")
        return ResourceDescriptor(
            resource_id=self.resource_id, substrate_class="lm_serving",
            adapter_type="in_process", location="cloud",
            twin_binding=f"twin-{self.resource_id}", capability=cap,
            description=f"{self.arch} continuous-batching LM serving, PyTorch "
                        f"on {self.device} (batch={self.batch_size}, "
                        f"max_seq={self.max_seq}, {kv}, roofline admission)")

    # -- engine lifecycle -----------------------------------------------------
    def _on_complete(self, r: Request) -> None:
        with self._events_lock:
            ev = self._events.pop(r.request_id, None)
        if ev is not None:
            ev.set()

    def _admission(self, r: Request, engine: ServingEngine) -> None:
        if r.deadline_s is None:
            return
        remaining_ms = (r.deadline_s - self.clock.monotonic()) * 1e3
        pred_ms, seen = price_request(self.cost, engine, r.prompt, r.max_new_tokens)
        if pred_ms > remaining_ms:
            raise AdmissionRefused(
                ErrorCode.DEADLINE,
                f"{r.request_id}: predicted completion {pred_ms:.0f}ms "
                f"exceeds remaining deadline budget {remaining_ms:.0f}ms "
                f"(backlog {seen['backlog_tokens']} decode + "
                f"{seen['backlog_prefill_tokens']} prefill tokens)",
                detail={"predicted_ms": round(pred_ms, 1),
                        "remaining_ms": round(remaining_ms, 1),
                        **seen})

    def prepare(self, session) -> None:
        self._check_prepare_fault()
        if self.engine is not None:
            return
        engine = ServingEngine(self.cfg, self.params, device=self.device,
                               batch_size=self.batch_size,
                               max_seq=self.max_seq, seed=self.seed,
                               paged=self.paged, page_size=self.page_size,
                               pool_pages=self.pool_pages,
                               prefix_sharing=self.prefix_sharing,
                               clock=self.clock)
        engine.on_complete = self._on_complete
        engine.admission = self._admission
        engine.on_step_ms = self.cost.observe_step
        engine.on_prefill_ms = self.cost.observe_prefill
        if self.calibrate:
            # the first prefill and the first decode graph's capture run
            # here, and seed the cost model with measured step times BEFORE
            # the first real admission decision (the first sample carries
            # the capture; the admission median washes it out).  Unlike the
            # reference, a second, longer prefill follows the 8-token one,
            # so the prefill fit has two lengths: its fixed part and its
            # per-token part (ROADMAP C5)
            engine.submit(Request("calib-0",
                                  np.arange(1, 9, dtype=np.int32) %
                                  self.cfg.vocab_size,
                                  max_new_tokens=4))
            long_len = min(self.max_seq // 4, CALIBRATION_LONG_PREFILL)
            engine.submit(Request(
                "calib-1", np.random.default_rng(self.seed).integers(
                    0, self.cfg.vocab_size, long_len).astype(np.int32),
                max_new_tokens=4))
            engine.drain()
        self.engine = engine
        self._stop.clear()
        self._driver = threading.Thread(
            target=engine.serve_forever, args=(self._stop,),
            name=f"{self.resource_id}-driver", daemon=True)
        self._driver.start()

    def invoke(self, session) -> Dict:
        payload = session.task.payload if isinstance(session.task.payload,
                                                     dict) else {}
        prompt = np.asarray(payload.get("prompt") or [], np.int32)
        max_new = int(payload.get("max_new_tokens", 8))
        with self._events_lock:
            self._req_seq += 1
            req_id = f"{session.task.task_id}#{self._req_seq}"
            ev = threading.Event()
            self._events[req_id] = ev
        deadline_s = None
        budget_ms = session.task.latency_budget_ms
        if budget_ms is not None:
            deadline_s = self.clock.monotonic() + budget_ms / 1e3
        r = Request(req_id, prompt, max_new_tokens=max_new,
                    deadline_s=deadline_s)
        t0 = time.perf_counter()
        try:
            self.engine.submit(r)
        except AdmissionRefused as e:
            with self._events_lock:
                self._events.pop(req_id, None)
            if self.refusal is None:
                raise
            raise self.refusal(e.code.value, e.message, e.detail) from e
        wait_s = MAX_WAIT_S if budget_ms is None \
            else min(MAX_WAIT_S, budget_ms / 1e3 + 30.0)
        if not ev.wait(wait_s):
            with self._events_lock:
                self._events.pop(req_id, None)
            raise RuntimeError(f"{req_id}: serving engine did not complete "
                               f"within {wait_s:.0f}s")
        total_ms = (time.perf_counter() - t0) * 1e3
        step_ms = self.cost.step_ms()
        telemetry = self._apply_telemetry_faults({
            "ttft_ms": round(r.ttft_ms or 0.0, 3),
            "tokens_per_s": round(r.tokens_per_s or 0.0, 2),
            "step_ms": round(step_ms, 4),
            "drift_score": 0.0,
            "health_status": "healthy",
            "observation_ms": total_ms,
            "deadline_expired": bool(r.expired),
            **self.engine.pool_stats(),
        })
        return {
            "output": {"request_id": req_id, "tokens": list(r.generated),
                       "total_ms": round(total_ms, 3)},
            "telemetry": telemetry,
            "artifacts": {"cost_model": self.cost.snapshot()},
            "backend_ms": total_ms,
            "needs_reset": False,
        }

    def reset(self, mode: str = "flush_queue") -> None:
        """Flush queued work and free every slot (runs only while idle —
        the lifecycle manager guarantees no sessions in flight)."""
        if self.engine is None:
            return
        self.engine.flush()

    def close(self) -> None:
        """Stop the driver and let go of the engine.  The engine's hooks
        refer back to this adapter, so they are dropped with it: a closed
        adapter's engine (its parameters, cache and graphs) is freed as
        soon as the last outside reference goes, with no wait for the cycle
        collector (ROADMAP C6; the reference keeps the engine)."""
        self._stop.set()
        engine = self.engine
        if engine is not None:
            engine.wake()           # the idle driver parks unbounded
        if self._driver is not None:
            self._driver.join(timeout=2.0)
            self._driver = None
        if engine is not None:
            engine.on_complete = engine.admission = None
            self.engine = None

    def snapshot(self) -> Optional[RuntimeSnapshot]:
        if self.engine is None:
            return RuntimeSnapshot(self.resource_id)
        m = self.engine.metrics
        backlog = self.engine.backlog()
        return RuntimeSnapshot(
            self.resource_id,
            health_status="healthy",
            extra={"backlog_tokens": self.engine.backlog_tokens(),
                   "backlog_prefill_tokens": backlog["prefill_tokens"],
                   "live_slots": self.engine.live_slots(),
                   "requests": m["requests"],
                   "deadline_expired": m["deadline_expired"],
                   **self.engine.pool_stats(),
                   **self.cost.snapshot()})

    def make_twin(self) -> Optional[TwinState]:
        return TwinState(f"twin-{self.resource_id}", self.resource_id,
                         kind="roofline",
                         model={"admission": "roofline",
                                **self.cost.snapshot()},
                         surrogate=ServingSurrogate(self.cost, self._bound_engine))

    def _bound_engine(self) -> Optional[ServingEngine]:
        """The live engine, for the twin to read at call time (ROADMAP C7)."""
        return self.engine
