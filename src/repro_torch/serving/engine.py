"""LM serving engine: prefill + decode over the KV cache — PyTorch port of
``repro/serving/engine.py`` (slot-granular layout).

Two serving modes share the prefill and decode steps:

- :meth:`ServingEngine.generate` — fixed-batch run-to-completion: one group
  is left-padded to a common length, prefilled together, and decoded until
  every member is done.
- continuous batching — :meth:`submit` puts a request on the waiting queue;
  :meth:`step` advances the shared decode batch one token.  Each batch slot
  owns an independent timeline: a freed slot is re-primed from a fresh B=1
  prefill and the per-row position vector keeps every other sequence exact.

Every batch slot owns a contiguous ``max_seq`` row of the decode cache.  The
paged layout (``paged=True`` in the reference) is the next slice of the port.

The engine runs on the card unless it is given ``device="cpu"``.  Per-request
telemetry (TTFT, decode tokens/s) is stamped through the injected ``clock``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core.clock import SYSTEM_CLOCK, Clock
from repro_torch.core.errors import AdmissionRefused, ErrorCode
from repro_torch.models import (build_decode_step, build_prefill_step,
                                decode_cache, model_specs)
from repro_torch.models.common import init_params, resolve_device, tree_leaves
from repro_torch.serving.cache_utils import extend_cache, write_slots


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 8
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: optional absolute deadline (engine-clock monotonic seconds)
    deadline_s: Optional[float] = None
    #: serving telemetry (engine-clock monotonic stamps, engine-filled)
    arrived_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    #: True when the request finished after its deadline
    expired: bool = False

    @property
    def ttft_ms(self) -> Optional[float]:
        """Time to first token (arrival → first emitted token)."""
        if self.arrived_s is None or self.first_token_s is None:
            return None
        return (self.first_token_s - self.arrived_s) * 1e3

    @property
    def tokens_per_s(self) -> Optional[float]:
        """Decode throughput over the request's full residency."""
        if (self.arrived_s is None or self.finished_s is None
                or not self.generated):
            return None
        dur = self.finished_s - self.arrived_s
        return len(self.generated) / dur if dur > 0 else None


@dataclasses.dataclass
class _Slot:
    """One row of the shared decode batch."""

    index: int
    request: Optional[Request] = None
    pos: int = 0                        # next cache position this row writes
    token: int = 0                      # last emitted token (next decode input)


class ServingEngine:
    """Serving engine on one device.

    ``generate`` (fixed-batch) and the continuous path (``submit`` /
    ``step`` / ``drain``) may be used on the same engine, but not
    concurrently with each other — they share the steps and metrics.
    Continuous-path entry points are thread-safe; ``submit`` may be called
    from many threads while a driver thread runs ``step``.
    """

    def __init__(self, cfg, params=None, *, device=None, batch_size: int = 2,
                 max_seq: int = 128, seed: int = 0, paged: bool = False,
                 clock: Optional[Clock] = None):
        if paged:
            raise NotImplementedError(
                "paged KV serving is the next slice of the port (ROADMAP A5/A6: "
                "write_prefill_paged, gather_pages, paged_decode_attention)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        if params is None:
            params = init_params(model_specs(cfg), seed, self.device)
        for path, leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"parameter {path} is on {leaf.device}, the "
                                 f"engine on {self.device}")
        self.params = params
        self._prefill = build_prefill_step(cfg)
        self._decode = build_decode_step(cfg)
        self.metrics: Dict[str, float] = {
            "prefill_ms": 0.0, "decode_ms": 0.0, "decode_steps": 0,
            "tokens": 0, "requests": 0, "deadline_expired": 0}
        # continuous-batching state
        self._slots = [_Slot(i) for i in range(batch_size)]
        self._waiting: Deque[Request] = collections.deque()
        self._cb_cache = None           # shared decode cache, built lazily
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        #: called with each finished Request (adapter → telemetry/waiters)
        self.on_complete: Optional[Callable[[Request], None]] = None
        #: admission hook: called with (request, engine) before enqueue;
        #: raises AdmissionRefused to refuse (e.g. roofline deadline check)
        self.admission: Optional[Callable[[Request, "ServingEngine"], None]] = None
        #: observers feeding a cost model (ms per decode step / per prefill)
        self.on_step_ms: Optional[Callable[[float], None]] = None
        self.on_prefill_ms: Optional[Callable[[int, float], None]] = None

    def _batch_extras(self, B):
        extras = {}
        if self.cfg.family == "encdec":
            # the audio frontend is a stub: zero frames, encoded per admission
            extras["frames"] = torch.zeros(
                (B, self.cfg.encoder_frames, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.param_dtype), device=self.device)
        return extras

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.int64).to(self.device)

    # -- validation -----------------------------------------------------------
    def _validate(self, r: Request) -> None:
        """Structured refusal instead of silent cache truncation."""
        n = len(r.prompt)
        if n == 0:
            raise AdmissionRefused(ErrorCode.BAD_REQUEST,
                                   f"{r.request_id}: empty prompt")
        if n > self.max_seq:
            raise AdmissionRefused(
                ErrorCode.BAD_REQUEST,
                f"{r.request_id}: prompt length {n} exceeds max_seq "
                f"{self.max_seq}")
        if r.max_new_tokens < 1:
            raise AdmissionRefused(
                ErrorCode.BAD_REQUEST,
                f"{r.request_id}: bad request: max_new_tokens "
                f"{r.max_new_tokens} < 1")
        if n + r.max_new_tokens > self.max_seq:
            raise AdmissionRefused(
                ErrorCode.BAD_REQUEST,
                f"{r.request_id}: kv cache overflow: prompt {n} + "
                f"max_new_tokens {r.max_new_tokens} exceeds max_seq "
                f"{self.max_seq}")

    def _emit(self, r: Request, tok: int) -> None:
        """Append one generated token; done flips at exactly max_new_tokens
        so the continuous loop can free the KV slot immediately."""
        r.generated.append(int(tok))
        if r.first_token_s is None:
            r.first_token_s = self.clock.monotonic()
        if len(r.generated) >= r.max_new_tokens:
            r.done = True
            r.finished_s = self.clock.monotonic()
            if r.deadline_s is not None and r.finished_s > r.deadline_s:
                r.expired = True
                self.metrics["deadline_expired"] += 1

    # -- fixed-batch baseline -------------------------------------------------
    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve one group to completion (greedy decoding).  Prompts are
        left-padded to the group's longest; the batch decodes in lockstep
        until every member is done."""
        if not requests:
            return []
        if len(requests) > self.batch_size:
            raise AdmissionRefused(
                ErrorCode.BAD_REQUEST,
                f"bad request: group of {len(requests)} exceeds batch_size "
                f"{self.batch_size}")
        for r in requests:
            self._validate(r)
        B = self.batch_size
        S = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        if S + max_new > self.max_seq:
            # padded group timeline: every member decodes from position S
            raise AdmissionRefused(
                ErrorCode.BAD_REQUEST,
                f"kv cache overflow: padded prompt {S} + max_new_tokens "
                f"{max_new} exceeds max_seq {self.max_seq}")
        now = self.clock.monotonic()
        for r in requests:
            if r.arrived_s is None:
                r.arrived_s = now
        prompts = np.zeros((B, S), np.int32)
        for i, r in enumerate(requests):
            prompts[i, S - len(r.prompt):] = r.prompt     # left-pad
        batch = {"tokens": self._tokens(prompts), **self._batch_extras(B)}

        t0 = time.perf_counter()
        prefill_cache, logits = self._prefill(self.params, batch)
        token = torch.argmax(logits, dim=-1)[:, None]
        tok_np = token[:, 0].cpu().numpy()              # waits for the device
        self.metrics["prefill_ms"] += (time.perf_counter() - t0) * 1e3

        # decode continues in a max_seq cache primed from the prefill cache
        cache = extend_cache(decode_cache(self.cfg, B, self.max_seq, self.device),
                             prefill_cache, S)
        # the prefill already predicts each sequence's next token: emit it
        for i, r in enumerate(requests):
            self._emit(r, tok_np[i])
        self.metrics["tokens"] += len(requests)
        step = 0
        while any(not r.done for r in requests):
            t0 = time.perf_counter()
            cache, logits = self._decode(self.params, cache, token, S + step)
            token = torch.argmax(logits, dim=-1)[:, None]
            tok_np = token[:, 0].cpu().numpy()
            self.metrics["decode_ms"] += (time.perf_counter() - t0) * 1e3
            self.metrics["decode_steps"] += 1
            emitted = 0
            for i, r in enumerate(requests):
                if not r.done:
                    self._emit(r, tok_np[i])
                    emitted += 1
            # only still-generating rows are billable work
            self.metrics["tokens"] += emitted
            step += 1
        self.metrics["requests"] += len(requests)
        return requests

    # -- continuous batching --------------------------------------------------
    def submit(self, r: Request) -> Request:
        """Validate, run admission, and enqueue.

        Raises :class:`AdmissionRefused`: ``BAD_REQUEST`` for malformed work,
        or whatever the admission hook raises — without touching engine
        state."""
        self._validate(r)
        if r.arrived_s is None:
            r.arrived_s = self.clock.monotonic()
        if self.admission is not None:
            self.admission(r, self)
        with self._work:
            self._waiting.append(r)
            self._work.notify_all()
        return r

    def backlog(self) -> Dict[str, int]:
        """Work owed to queued + in-flight requests, split by phase:
        ``decode_tokens`` (tokens still to generate) and ``prefill_tokens``
        (un-prefilled prompt tokens of waiting requests)."""
        with self._lock:
            decode = sum(r.max_new_tokens for r in self._waiting)
            decode += sum(s.request.max_new_tokens - len(s.request.generated)
                          for s in self._slots if s.request is not None)
            prefill = sum(len(r.prompt) for r in self._waiting)
            return {"decode_tokens": decode, "prefill_tokens": prefill}

    def backlog_tokens(self) -> int:
        """Total tokens of owed work (decode + un-prefilled prompt)."""
        b = self.backlog()
        return b["decode_tokens"] + b["prefill_tokens"]

    def live_slots(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s.request is not None)

    def _prime_fn(self, batch, slot: int) -> torch.Tensor:
        """Admission: B=1 prefill → fit into a max_seq row → write the row
        into the shared decode cache at ``slot`` → argmax first token.  The
        write is in place, which is what the reference gets from donating
        the cache buffer to its jitted prime.  The encoder runs anew for
        every admission, as in the reference."""
        S = batch["tokens"].shape[1]
        pcache, logits = self._prefill(self.params, batch)
        row = extend_cache(decode_cache(self.cfg, 1, self.max_seq, self.device),
                           pcache, S)
        write_slots(self._cb_cache, row, [slot])
        return torch.argmax(logits, dim=-1)

    def _prime_slot(self, slot: _Slot, r: Request) -> None:
        """B=1 prefill at the prompt's natural length, written into the
        slot's row."""
        S = len(r.prompt)
        if self._cb_cache is None:
            self._cb_cache = decode_cache(self.cfg, self.batch_size, self.max_seq,
                                          self.device)
        batch = {"tokens": self._tokens(np.asarray(r.prompt, np.int32)[None, :]),
                 **self._batch_extras(1)}
        t0 = time.perf_counter()
        tok = int(self._prime_fn(batch, slot.index)[0])   # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics["prefill_ms"] += ms
        if self.on_prefill_ms is not None:
            self.on_prefill_ms(S, ms)
        slot.request, slot.pos, slot.token = r, S, tok
        self._emit(r, tok)
        self.metrics["tokens"] += 1
        if r.done:                       # max_new_tokens == 1
            self._finish(slot)

    def _finish(self, slot: _Slot) -> None:
        r = slot.request
        slot.request, slot.pos, slot.token = None, 0, 0
        self.metrics["requests"] += 1
        if self.on_complete is not None:
            self.on_complete(r)

    def _admit_locked(self) -> None:
        for slot in self._slots:
            if slot.request is None and self._waiting:
                self._prime_slot(slot, self._waiting.popleft())

    @torch.inference_mode()
    def step(self) -> int:
        """Advance the shared decode batch one token.  Freed slots are
        re-primed from the waiting queue first, so sequences join and leave
        the batch every step.  Returns the number of live tokens emitted
        (0 = engine idle)."""
        with self._lock:
            self._admit_locked()
            live = [s for s in self._slots if s.request is not None]
            if not live:
                return 0
            tokens = np.zeros((self.batch_size, 1), np.int32)
            posv = np.zeros((self.batch_size,), np.int32)
            for s in self._slots:
                tokens[s.index, 0] = s.token
                posv[s.index] = s.pos
            t0 = time.perf_counter()
            self._cb_cache, logits = self._decode(
                self.params, self._cb_cache, self._tokens(tokens), self._tokens(posv))
            tok = torch.argmax(logits, dim=-1).cpu().numpy()   # waits for the device
            ms = (time.perf_counter() - t0) * 1e3
            self.metrics["decode_ms"] += ms
            self.metrics["decode_steps"] += 1
            if self.on_step_ms is not None:
                self.on_step_ms(ms)
            for s in live:
                self._emit(s.request, int(tok[s.index]))
                s.token = int(tok[s.index])
                s.pos += 1
                if s.request.done:
                    self._finish(s)
            self.metrics["tokens"] += len(live)
            return len(live)

    def drain(self) -> None:
        """Run ``step`` until the queue and every slot are empty."""
        while True:
            with self._lock:
                busy = bool(self._waiting) or any(
                    s.request is not None for s in self._slots)
            if not busy:
                return
            self.step()

    def flush(self) -> None:
        """Drop all queued and in-flight work and reset the decode cache.
        Callers guarantee no invoker is waiting on the flushed requests."""
        with self._work:
            self._waiting.clear()
            for s in self._slots:
                s.request, s.pos, s.token = None, 0, 0
            self._cb_cache = None
            self._work.notify_all()

    def wake(self) -> None:
        """Nudge a parked ``serve_forever`` driver (call after setting its
        stop event — the idle park is unbounded, not a poll)."""
        with self._work:
            self._work.notify_all()

    def serve_forever(self, stop: threading.Event,
                      idle_wait_s: Optional[float] = None) -> None:
        """Driver loop for a serving thread: step while there is work, park
        on the condition variable while idle (``submit`` wakes it; pair
        ``stop.set()`` with :meth:`wake`)."""
        def has_work() -> bool:
            return (stop.is_set() or bool(self._waiting)
                    or any(s.request is not None for s in self._slots))

        while not stop.is_set():
            if self.step() == 0:
                with self._work:
                    self.clock.wait_for(self._work, has_work,
                                        timeout=idle_wait_s)
