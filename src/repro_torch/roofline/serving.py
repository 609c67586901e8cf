"""Predictive serving cost model: the roofline as an admission oracle — the
port of ``repro/roofline/serving.py``.

A request that cannot finish inside its deadline must be refused at
admission (structured ``DEADLINE``) instead of timing out mid-decode after
burning batch slots.  The model prices one decode step of the whole batch
from first principles — 2·N FLOPs per token (``model_flops`` inference
form) against parameter + KV-cache memory traffic (``roofline_terms``) —
which gives a hardware lower bound, then tightens it with measured step and
prefill medians (the lower bound stays a floor: a noisy fast sample can
never make the model optimistic beyond physics).

Predicted completion for a new arrival =

    prefill(prompt) + queue_drain(backlog / batch_size) + steps · step_ms

scaled by a safety factor.

Three differences from the reference:

- the cache's bytes are counted from the port's ``decode_cache`` /
  ``decode_cache_paged`` built on the ``meta`` device: shapes and dtypes,
  no allocation;
- the prefill floor reads the weights once per prefill, not once per
  token.  The reference floors a prompt of n tokens at n one-token forwards
  (``n · max(2N/peak, weight_bytes/hbm_bw)``); a prefill is one forward over
  n tokens, whose least time is ``max(2N·n/peak, weight_bytes/hbm_bw)``.
  ``prefill_lb_ms_per_token`` keeps its key and holds the per-token compute
  term; ``prefill_weight_read_ms`` is the one weight read;
- a prefill is priced as a fixed part plus a per-token part, fitted to the
  observed ``(tokens, ms)`` pairs, not as n times the median ms per token.
  The reference's median, learnt from a short calibration prefill that is
  almost all fixed cost (the weight read, the host's launches), prices a
  long prompt several times too high.  The fit is Theil-Sen (the median of
  the pairwise slopes, then the median intercept), as robust to a
  capture-time outlier as the reference's median; the slope is held at or
  above ``prefill_lb_ms_per_token`` and the intercept at or above 0.  With
  fewer than two distinct lengths observed, the slope is that floor and the
  intercept takes the rest.  Where every observation has one per-token rate
  the fit is that rate with no fixed part, and the two packages agree.
  ``snapshot()`` adds ``prefill_fixed_ms`` and ``prefill_ms_per_token``.
"""
from __future__ import annotations

import collections
import statistics
import threading
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.models import (count_params, decode_cache, decode_cache_paged,
                                paged_cache_flags)
from repro_torch.models.common import tree_leaves
from repro_torch.roofline.analysis import HW, Hardware, model_flops, roofline_terms

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def _dtype_bytes(name: str) -> int:
    try:
        return _DTYPE_BYTES.get(str(name)) or np.dtype(name).itemsize
    except TypeError:
        return 4


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _cache_bytes_per_row(cfg, max_seq: int) -> int:
    """Device footprint of one batch row's decode cache (meta tensors:
    never allocates)."""
    return sum(_nbytes(t) for _, t in tree_leaves(decode_cache(cfg, 1, max_seq, "meta")))


def _paged_cache_bytes(cfg, batch: int, max_seq: int, pool_pages: int, page_size: int):
    """-> (pool_bytes, resident_bytes) of the paged decode cache (meta
    tensors).  ``pool_bytes`` spans all ``pool_pages + 1`` rows (incl. the
    null page); resident leaves keep the slot-granular batch layout."""
    tree = decode_cache_paged(cfg, batch, max_seq, pool_pages, page_size, "meta")
    pool_b = resident_b = 0
    for (_, flag), (_, t) in zip(tree_leaves(paged_cache_flags(cfg)), tree_leaves(tree)):
        if flag:
            pool_b += _nbytes(t)
        else:
            resident_b += _nbytes(t)
    return pool_b, resident_b


class ServingCostModel:
    """Roofline-prior, measurement-tightened cost model for one engine."""

    #: headroom multiplier on every prediction (scheduling jitter, GC, the
    #: prose reason a refusal carries shows the *scaled* number)
    SAFETY = 1.25
    #: observation windows (medians are robust to capture-time outliers)
    WINDOW = 64

    def __init__(self, cfg, *, batch_size: int, max_seq: int,
                 hw: Hardware = HW, safety: float = SAFETY,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None):
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.safety = safety
        self.page_size = page_size
        self.pool_pages = pool_pages
        n_params = count_params(cfg)
        pbytes = n_params * _dtype_bytes(cfg.param_dtype)
        if page_size is not None and pool_pages:
            # paged engine: KV memory is priced in pages — a full pool for
            # the static step bound (conservative), live + predicted-growth
            # pages for dynamic capacity questions (page_hbm_bytes)
            pool_b, resident_b = _paged_cache_bytes(
                cfg, batch_size, max_seq, pool_pages, page_size)
            self.bytes_per_page = pool_b // (pool_pages + 1)
            self.resident_cache_bytes = resident_b
            kv_bytes = resident_b + pool_pages * self.bytes_per_page
        else:
            self.bytes_per_page = 0
            self.resident_cache_bytes = 0
            kv_bytes = _cache_bytes_per_row(cfg, max_seq) * batch_size
        self.kv_hbm_bytes = kv_bytes
        # one decode step of the full batch: 2·N FLOPs per live token, one
        # full parameter read, one KV-cache sweep
        flops = model_flops(n_params, batch_size, kind="inference")
        self._terms = roofline_terms(flops, pbytes + kv_bytes, 0.0, hw)
        self.step_lb_ms = self._terms["step_time_lb_s"] * 1e3
        # prefill floor of n tokens: max(n · compute per token, one weight read)
        self.prefill_lb_ms_per_token = roofline_terms(
            model_flops(n_params, 1, kind="inference"), 0.0, 0.0, hw)["step_time_lb_s"] * 1e3
        self.prefill_weight_read_ms = roofline_terms(0.0, pbytes, 0.0, hw)["step_time_lb_s"] * 1e3
        self._lock = threading.Lock()
        self._step_ms: Deque[float] = collections.deque(maxlen=self.WINDOW)
        self._prefills: Deque[Tuple[int, float]] = collections.deque(maxlen=self.WINDOW)
        # the fitted prefill price: fixed ms, ms per token (None: nothing observed)
        self._prefill_fit: Optional[Tuple[float, float]] = None

    # -- measurement feed (engine on_step_ms / on_prefill_ms hooks) -----------
    def observe_step(self, ms: float) -> None:
        with self._lock:
            self._step_ms.append(ms)

    def observe_prefill(self, prompt_len: int, ms: float) -> None:
        if prompt_len > 0:
            with self._lock:
                self._prefills.append((prompt_len, ms))
                self._prefill_fit = self._fit_prefill()

    def _fit_prefill(self) -> Tuple[float, float]:
        """-> (fixed ms, ms per token) of the observed prefills: Theil-Sen
        with the slope floored at the per-token compute bound and the
        intercept at 0 (see the module docstring)."""
        n = np.array([p[0] for p in self._prefills], np.float64)
        ms = np.array([p[1] for p in self._prefills], np.float64)
        i, j = np.triu_indices(len(n), k=1)
        distinct = n[i] != n[j]
        slope = (float(np.median((ms[j] - ms[i])[distinct] / (n[j] - n[i])[distinct]))
                 if distinct.any() else 0.0)
        slope = max(slope, self.prefill_lb_ms_per_token)
        return max(float(np.median(ms - slope * n)), 0.0), slope

    # -- predictions ----------------------------------------------------------
    def step_ms(self) -> float:
        with self._lock:
            obs = statistics.median(self._step_ms) if self._step_ms else 0.0
        return max(obs, self.step_lb_ms)

    def prefill_ms(self, prompt_len: int) -> float:
        if prompt_len <= 0:
            return 0.0
        with self._lock:
            fixed, per_token = self._prefill_fit or (0.0, 0.0)
        # the floor of one prefill: its compute, or one read of the weights
        return max(fixed + prompt_len * per_token,
                   prompt_len * self.prefill_lb_ms_per_token,
                   self.prefill_weight_read_ms)

    def page_hbm_bytes(self, live_pages: int, growth_pages: int = 0) -> int:
        """KV memory footprint at ``live_pages`` pool pages in use plus a
        predicted-growth allowance — what a paged engine actually touches,
        as opposed to the ``batch × max_seq`` worst case."""
        return int(self.resident_cache_bytes
                   + (live_pages + growth_pages) * self.bytes_per_page)

    def predict_request_ms(self, prompt_len: int, max_new_tokens: int,
                           backlog_tokens: int = 0, *,
                           backlog_prefill_tokens: int = 0,
                           cached_prefix_tokens: int = 0) -> float:
        """Predicted arrival→completion time for a new request given the
        engine's current backlog.  ``backlog_tokens`` is decode work owed
        to queued + live requests; ``backlog_prefill_tokens`` is un-prefilled
        prompt work of waiting requests (priced at prefill rate, not decode
        rate).  ``cached_prefix_tokens`` are prompt tokens the prefix cache
        already holds — only the suffix is prefilled."""
        step = self.step_ms()
        decode_steps = max(max_new_tokens - 1, 0)   # first token: prefill
        drain_steps = backlog_tokens / max(1, self.batch_size)
        suffix = max(prompt_len - cached_prefix_tokens, 1)
        total = (self.prefill_ms(suffix)
                 + self.prefill_ms(backlog_prefill_tokens)
                 + (drain_steps + decode_steps) * step)
        return self.safety * total

    def snapshot(self) -> Dict:
        with self._lock:
            n_step, n_pf = len(self._step_ms), len(self._prefills)
            fixed, per_token = self._prefill_fit or (0.0, self.prefill_lb_ms_per_token)
        snap = {
            "step_lb_ms": round(self.step_lb_ms, 6),
            "step_ms": round(self.step_ms(), 4),
            "prefill_lb_ms_per_token": round(self.prefill_lb_ms_per_token, 6),
            "prefill_weight_read_ms": round(self.prefill_weight_read_ms, 6),
            "prefill_fixed_ms": round(fixed, 6),
            "prefill_ms_per_token": round(per_token, 6),
            "dominant": self._terms["dominant"],
            "observed_steps": n_step,
            "observed_prefills": n_pf,
        }
        if self.bytes_per_page:
            snap["bytes_per_page"] = self.bytes_per_page
        return snap
