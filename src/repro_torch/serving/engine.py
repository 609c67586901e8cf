"""LM serving engine: prefill + decode over the KV cache — PyTorch port of
``repro/serving/engine.py``.

Two serving modes share the prefill and decode steps:

- :meth:`ServingEngine.generate` — fixed-batch run-to-completion: one group
  is left-padded to a common length, prefilled together, and decoded until
  every member is done.
- continuous batching — :meth:`submit` puts a request on the waiting queue;
  :meth:`step` advances the shared decode batch one token.  Each batch slot
  owns an independent timeline: a freed slot is re-primed from a fresh B=1
  prefill and the per-row position vector keeps every other sequence exact.

KV storage comes in two layouts:

- **slot-granular** (default) — every batch slot owns a contiguous
  ``max_seq`` row of the decode cache, whether the request uses 9 tokens or
  all of them.
- **paged** (``paged=True``) — global-attention K/V live in a shared pool
  of fixed-size token pages (``serving/kv_pages.py``) addressed through
  per-row page tables; pages are allocated on demand as sequences grow and
  refcounted so requests sharing a prompt prefix share its pages (prefix
  cache: suffix-only prefill).  Admission reserves a request's worst-case
  page need and refuses with a structured ``QUEUE_SATURATED`` (and
  ``retry_after_s``) when the pool cannot hold it; the reservation is what
  guarantees that mid-decode page allocation never fails.  Bounded per-row
  state (ring-buffer windows, recurrent and rwkv carries, cross K/V) stays
  slot-granular, and archs with no pageable leaves (recurrentgemma-9b,
  rwkv6-7b) fall back to the slot-granular path.  The pool is written in
  place on the engine's device; the page tables are uploaded once per
  change.

The engine runs on the card unless it is given ``device="cpu"``.  Per-request
telemetry (TTFT, decode tokens/s) is stamped through the injected ``clock``.

On the card the continuous path's decode step runs as CUDA graphs — the
counterpart of the reference's jitted step (``decode_graphs``): one graph
for the contiguous step, one per page-table width for the paged step, each
captured on its first use into one shared memory pool.  A graph binds
buffer addresses, so the step reads its tokens, positions and page table
from static device buffers filled before each replay, the cache is zeroed
in place by ``flush`` rather than rebuilt, and ``params`` are bound at
capture.  The fixed-batch ``generate`` stays eager.
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
from repro_torch.models import (build_decode_step, build_decode_step_paged,
                                build_prefill_past_step, build_prefill_step,
                                decode_cache, decode_cache_paged, model_specs,
                                paged_cache_flags, paged_support)
from repro_torch.models.common import init_params, resolve_device, tree_leaves
from repro_torch.serving.cache_utils import (extend_cache, gather_pages,
                                             write_prefill_paged, write_slots)
from repro_torch.serving.kv_pages import PagePool, PrefixCache

#: cache leaves the decode step reads and rewrites (the RG-LRU's and rwkv's
#: carries): the one part of a step that is not idempotent, so a graph's
#: warm-up restores it
_CARRIES = ("h", "conv", "s", "ts_tm", "ts_cm")

#: one side stream per device for every engine's graph warm-ups: cuBLAS keeps
#: a workspace (32 MiB on Hopper) for each stream it has run on, for the
#: life of the process
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


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
    #: pages reserved against the kv pool at admission (paged mode only;
    #: engine bookkeeping, not wire state)
    reserved_pages: int = 0

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
    #: page ids owned by this row, in block order (paged mode; includes
    #: shared prefix pages — every page holds one of the request's refs)
    pages: List[int] = dataclasses.field(default_factory=list)


class ServingEngine:
    """Serving engine on one device.

    ``generate`` (fixed-batch) and the continuous path (``submit`` /
    ``step`` / ``drain``) may be used on the same engine, but not
    concurrently with each other — they share the steps and metrics.
    Continuous-path entry points are thread-safe; ``submit`` may be called
    from many threads while a driver thread runs ``step``.

    In paged mode ``max_seq`` is the per-request token cap (the page-table
    width); aggregate capacity is the page pool, not ``batch_size ×
    max_seq``, so one request may exceed what one slot-granular row could
    hold.
    """

    def __init__(self, cfg, params=None, *, device=None, batch_size: int = 2,
                 max_seq: int = 128, seed: int = 0, paged: bool = False,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 prefix_sharing: bool = True, clock: Optional[Clock] = None,
                 decode_graphs: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if decode_graphs and not on_card:
            raise ValueError(f"decode_graphs=True needs a CUDA device, not {self.device}")
        #: the continuous path's decode step runs as CUDA graphs (default: on
        #: the card); ``False`` keeps it eager, the baseline
        self.decode_graphs = on_card if decode_graphs is None else bool(decode_graphs)
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
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.pool_pages = 0
        self._pool: Optional[PagePool] = None
        self._prefix: Optional[PrefixCache] = None
        self._tables: Optional[np.ndarray] = None
        if self.paged:
            any_paged, prefix_ok = paged_support(cfg)
            if any_paged:
                self.max_pages = -(-max_seq // self.page_size)
                self.pool_pages = (pool_pages if pool_pages is not None
                                   else batch_size * self.max_pages)
                self._flags = paged_cache_flags(cfg)
                self._pool = PagePool(self.pool_pages, self.page_size)
                self._tables = np.zeros((batch_size, self.max_pages), np.int32)
                #: bumped on every table change; each width's static device
                #: table is refreshed in place when its copy is older
                self._tables_version = 0
                self._decode = build_decode_step_paged(cfg, self.page_size)
                if prefix_sharing and prefix_ok:
                    self._prefix = PrefixCache(self._pool)
                    self._prefill_past = build_prefill_past_step(cfg)
            # archs with no pageable leaves (pure recurrent/ring stacks)
            # fall through to the slot-granular path below
        if self._pool is None:
            self._decode = build_decode_step(cfg)
        # fixed-batch ``generate`` always decodes contiguously (it owns a
        # private cache and is the baseline the paged path is judged against)
        self._decode_dense = build_decode_step(cfg) if self._pool is not None else None
        self.metrics: Dict[str, float] = {
            "prefill_ms": 0.0, "decode_ms": 0.0, "decode_steps": 0,
            "tokens": 0, "requests": 0, "deadline_expired": 0}
        # continuous-batching state
        self._slots = [_Slot(i) for i in range(batch_size)]
        self._waiting: Deque[Request] = collections.deque()
        self._cb_cache = None           # shared decode cache, built lazily
        # the step's static inputs: row 0 the tokens, row 1 the positions,
        # filled through one pinned host buffer (one copy per step); page
        # tables by width, each with the table version it holds
        self._io_host = torch.zeros((2, batch_size), dtype=torch.int64,
                                    pin_memory=on_card)
        self._io = torch.zeros((2, batch_size), dtype=torch.int64, device=self.device)
        self._table_in: Dict[int, tuple] = {}
        #: decode graphs by key (``None``: contiguous; else the table width),
        #: each ``(graph, logits, tokens)``; one memory pool for all
        self._graphs: Dict[Optional[int], tuple] = {}
        self._graph_pool = None
        #: capture ms by graph key
        self.graph_capture_ms: Dict[Optional[int], float] = {}
        #: logits of the latest continuous decode step (a graph's output
        #: buffer on a graphed engine: the next replay overwrites it)
        self.last_logits: Optional[torch.Tensor] = None
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
        if self.cfg.family == "vision":
            # so is the vision frontend: zero patch embeddings
            extras["image_embeds"] = torch.zeros(
                (B, self.cfg.num_image_tokens, self.cfg.d_model),
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
        decode = self._decode_dense or self._decode
        step = 0
        while any(not r.done for r in requests):
            t0 = time.perf_counter()
            cache, logits = decode(self.params, cache, token, S + step)
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
        """Validate, run admission, reserve kv pages, and enqueue.

        Raises :class:`AdmissionRefused`: ``BAD_REQUEST`` for malformed work,
        ``QUEUE_SATURATED`` (with ``retry_after_s``) when the page pool
        cannot hold the request's worst-case need, or whatever the admission
        hook raises — all without touching engine state."""
        self._validate(r)
        if r.arrived_s is None:
            r.arrived_s = self.clock.monotonic()
        if self.admission is not None:
            self.admission(r, self)
        with self._work:
            if self._pool is not None:
                need = self._pages_needed(len(r.prompt) + r.max_new_tokens)
                if not self._pool.reserve(need):
                    raise AdmissionRefused(
                        ErrorCode.QUEUE_SATURATED,
                        f"{r.request_id}: queue saturated: kv page pool "
                        f"cannot hold {need} more pages "
                        f"({self._pool.reserved_pages}/{self._pool.num_pages}"
                        f" reserved)",
                        detail={"retry_after_s": self._retry_after_s(),
                                "needed_pages": need,
                                "pool_pages": self._pool.num_pages,
                                "pool_pages_used": self._pool.used_pages(),
                                "reserved_pages": self._pool.reserved_pages})
                r.reserved_pages = need
            self._waiting.append(r)
            self._work.notify_all()
        return r

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _retry_after_s(self) -> float:
        """Back-off hint for a saturated pool: roughly one batch drain of
        the decode tokens currently owed, at the observed step rate."""
        steps = self.metrics["decode_steps"]
        step_s = (self.metrics["decode_ms"] / steps / 1e3) if steps else 0.05
        b = self.backlog()
        drain_steps = max(1.0, b["decode_tokens"] / max(1, self.batch_size))
        return round(max(0.05, drain_steps * step_s), 3)

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

    def cached_prefix_tokens(self, prompt) -> int:
        """Prompt tokens a submit would serve from the prefix cache (pure
        probe: no refs taken, no LRU touch — safe for admission pricing)."""
        if self._prefix is None:
            return 0
        with self._lock:
            return self._prefix.probe(np.asarray(prompt, np.int32), self.page_size)

    def pool_stats(self) -> Dict[str, float]:
        """Paged-capacity telemetry for the descriptor/snapshot (empty dict
        on slot-granular engines)."""
        if self._pool is None:
            return {}
        with self._lock:
            stats: Dict[str, float] = {
                "page_size": self.page_size,
                "pool_pages": self._pool.num_pages,
                "pool_pages_used": self._pool.used_pages(),
                "pool_pages_free": self._pool.free_pages(),
                "pool_utilization": round(self._pool.utilization(), 4),
            }
            if self._prefix is not None:
                stats["prefix_hit_rate"] = round(self._prefix.hit_rate(), 4)
                stats["prefix_cached_tokens"] = self._prefix.hit_tokens
            return stats

    def audit_pages(self) -> Dict[str, int]:
        """Leak audit of the page pool (consistency asserted inside)."""
        if self._pool is None:
            return {}
        with self._lock:
            return self._pool.audit()

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

    def _prime_paged_fn(self, batch, pages: List[int], slot: int) -> torch.Tensor:
        """Paged admission: B=1 prefill → scatter its token blocks into pool
        pages (resident leaves into the batch row) → argmax first token."""
        S = batch["tokens"].shape[1]
        pcache, logits = self._prefill(self.params, batch)
        write_prefill_paged(self._flags, self._cb_cache, pcache, pages, slot, S,
                            self.page_size)
        return torch.argmax(logits, dim=-1)

    def _prime_past_fn(self, batch, pages: List[int], shared: List[int],
                       slot: int) -> torch.Tensor:
        """Prefix-hit admission: gather the shared prefix pages into
        contiguous past K/V → suffix-only prefill against it → scatter the
        suffix blocks into the request's private pages."""
        S = batch["tokens"].shape[1]
        past = gather_pages(self._flags, self._cb_cache, shared)
        pcache, logits = self._prefill_past(self.params, batch, past)
        write_prefill_paged(self._flags, self._cb_cache, pcache, pages, slot, S,
                            self.page_size)
        return torch.argmax(logits, dim=-1)

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate for already-reserved work, evicting cache-only prefix
        pages as needed.  Conservative reservations guarantee success: live
        usage never exceeds the reserved total, and everything else in the
        pool is an evictable cache reference."""
        if n == 0:
            return []
        while (self._pool.free_pages() < n and self._prefix is not None
               and self._prefix.evict_one()):
            pass
        return self._pool.alloc(n)

    def _set_table_row(self, index: int, pages: List[int]) -> None:
        self._tables[index, :] = 0
        self._tables[index, :len(pages)] = pages
        self._tables_version += 1

    def _prime_slot(self, slot: _Slot, r: Request) -> None:
        """B=1 prefill at the prompt's natural length, written into the
        slot's row (slot-granular) or the request's pages (paged)."""
        S = len(r.prompt)
        prompt = np.asarray(r.prompt, np.int32)
        if self._cb_cache is None:
            self._cb_cache = (
                decode_cache_paged(self.cfg, self.batch_size, self.max_seq,
                                   self.pool_pages, self.page_size, self.device)
                if self._pool is not None
                else decode_cache(self.cfg, self.batch_size, self.max_seq, self.device))
        t0 = time.perf_counter()
        if self._pool is not None:
            shared: List[int] = []
            if self._prefix is not None:
                _, shared = self._prefix.lookup(prompt, self.page_size)
            prefix_tokens = len(shared) * self.page_size
            fresh = self._alloc_pages(self._pages_needed(S) - len(shared))
            slot.pages = list(shared) + fresh
            self._set_table_row(slot.index, slot.pages)
            suffix = prompt[prefix_tokens:]
            batch = {"tokens": self._tokens(suffix[None, :]), **self._batch_extras(1)}
            if shared:
                tok = self._prime_past_fn(batch, fresh, shared, slot.index)
            else:
                tok = self._prime_paged_fn(batch, fresh, slot.index)
            if self._prefix is not None:
                # register this prompt's full blocks for future sharers
                self._prefix.insert(prompt, slot.pages, self.page_size)
            pf_tokens = len(suffix)
        else:
            batch = {"tokens": self._tokens(prompt[None, :]), **self._batch_extras(1)}
            tok = self._prime_fn(batch, slot.index)
            pf_tokens = S
        tok = int(tok[0])                                 # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics["prefill_ms"] += ms
        if self.on_prefill_ms is not None:
            self.on_prefill_ms(pf_tokens, ms)
        slot.request, slot.pos, slot.token = r, S, tok
        self._emit(r, tok)
        self.metrics["tokens"] += 1
        if r.done:                       # max_new_tokens == 1
            self._finish(slot)

    def _release(self, slot: _Slot) -> None:
        """Return a row's page refs and its request's reservation."""
        for pid in slot.pages:
            self._pool.decref(pid)
        slot.pages = []
        self._pool.unreserve(slot.request.reserved_pages)
        slot.request.reserved_pages = 0
        self._set_table_row(slot.index, [])

    def _finish(self, slot: _Slot) -> None:
        r = slot.request
        if self._pool is not None:
            self._release(slot)
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
            width = self._grow_tables(live) if self._pool is not None else None
            t0 = time.perf_counter()
            inputs = self._step_inputs(width)
            if self.decode_graphs:
                graph = self._graphs.get(width) or self._capture(width, inputs)
                graph[0].replay()
                logits, tok = graph[1], graph[2]
            else:
                self._cb_cache, logits = self._decode(self.params, self._cb_cache, *inputs)
                tok = torch.argmax(logits, dim=-1)
            self.last_logits = logits
            tok = tok.cpu().numpy()                  # the step's one wait for the device
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

    def _grow_tables(self, live: List[_Slot]) -> int:
        """Grow each live row into the page its write position reaches, and
        return the page-table width of this step: the widest live row."""
        width = 0
        for s in live:
            blk = s.pos // self.page_size
            if blk >= len(s.pages):
                # on-demand growth: this step's write position crossed into
                # a new block; the admission-time reservation guarantees
                # the allocation succeeds
                s.pages.extend(self._alloc_pages(1))
                self._tables[s.index, blk] = s.pages[-1]
                self._tables_version += 1
            width = max(width, len(s.pages))
        # attend only over live pages: short requests read a few pages
        # instead of a max_seq-shaped row.  Wide tables round up to powers
        # of two, as the reference's do to bound its compiled variants, so
        # the gather reads the same columns (and a few graphs cover them)
        if self.max_pages > 16:
            width = 1 << (width - 1).bit_length()
        return min(width, self.max_pages)

    def _step_inputs(self, width: Optional[int]) -> tuple:
        """Fill the step's static device inputs from the slots and return
        ``(tokens (B, 1), positions (B,)[, page table (B, width)])``.  Dead
        rows read token 0 at position 0 through the null page, as the
        reference's step does.  A width's table is copied only when the
        host table changed since (admission, growth, finish)."""
        host = self._io_host.numpy()
        for s in self._slots:
            host[0, s.index], host[1, s.index] = s.token, s.pos
        self._io.copy_(self._io_host, non_blocking=True)
        inputs = (self._io[0].unsqueeze(1), self._io[1])
        if width is None:
            return inputs
        table, staged, version = self._table_in.get(width, (None, None, -1))
        if table is None:
            table = torch.zeros((self.batch_size, width), dtype=torch.int64,
                                device=self.device)
            staged = torch.zeros((self.batch_size, width), dtype=torch.int64,
                                 pin_memory=self._io_host.is_pinned())
        if version != self._tables_version:
            staged.numpy()[:] = self._tables[:, :width]
            table.copy_(staged, non_blocking=True)
            self._table_in[width] = (table, staged, self._tables_version)
        return inputs + (table,)

    def _capture(self, key: Optional[int], inputs: tuple) -> tuple:
        """Capture the decode step for ``key`` (the table width, or ``None``)
        on the current inputs, with the argmax inside the graph.  One eager
        warm-up on a side stream comes first; it writes the same K/V the
        step will, and the recurrent and rwkv carries it advances are put back.  A
        failed capture raises: there is no eager fallback."""
        t0 = time.perf_counter()
        carries = [(t, t.clone()) for path, t in tree_leaves(self._cb_cache)
                   if path.rsplit("/", 1)[-1] in _CARRIES]
        main = torch.cuda.current_stream(self.device)
        side = _WARMUP_STREAMS.get(self.device)
        if side is None:
            side = _WARMUP_STREAMS[self.device] = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._decode(self.params, self._cb_cache, *inputs)
        main.wait_stream(side)
        for t, saved in carries:
            t.copy_(saved)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode="thread_local"):
            _, logits = self._decode(self.params, self._cb_cache, *inputs)
            tokens = torch.argmax(logits, dim=-1)
        self._graphs[key] = (graph, logits, tokens)
        self.graph_capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return self._graphs[key]

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
        """Drop all queued and in-flight work: release every reservation and
        page, clear the prefix cache, zero the decode cache.  Callers
        guarantee no invoker is waiting on the flushed requests."""
        with self._work:
            if self._pool is not None:
                for r in self._waiting:
                    self._pool.unreserve(r.reserved_pages)
                    r.reserved_pages = 0
            self._waiting.clear()
            for s in self._slots:
                if s.request is not None and self._pool is not None:
                    self._release(s)
                s.request, s.pos, s.token = None, 0, 0
            if self._prefix is not None:
                self._prefix.flush()
            if self._cb_cache is not None:
                # zeroed in place, not rebuilt: the decode graphs bind its
                # buffers, and a zeroed cache is a fresh one
                with torch.inference_mode():
                    for _, leaf in tree_leaves(self._cb_cache):
                        leaf.zero_()
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
