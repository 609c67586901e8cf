"""Decode-cache utilities — PyTorch port of ``repro/serving/cache_utils.py``.

Prefill emits caches sized to the prompt; decode wants ``max_seq`` slots.
``extend_cache`` right-pads the sequence axis of global KV leaves and
re-rolls ring-buffered local-window leaves so that slot ``p % window`` holds
absolute position ``p`` (the invariant ``decode_attention`` relies on).
Unlike the reference, a sequence leaf is fitted even when its prefill shape
already equals the template's: a local layer's prompt longer than its window
fills the window exactly and still needs the roll (the reference returns it
in prompt order, and decode then reads the wrong positions).

``write_slots`` is the continuous-batching primitive: it scatters the batch
rows of one cache into chosen batch slots of the shared decode cache.  It
writes in place, which is what the reference's buffer donation buys it.
"""
from __future__ import annotations

import torch

# leaf name -> seq axis (in the unstacked (B, S, ...) layout); stacked leaves
# gain a leading layer axis
_SEQ_LEAVES = {"k": 1, "v": 1, "c_kv": 1, "k_rope": 1}


def _map_with_path(fn, *trees, path=()):
    if isinstance(trees[0], dict):
        return {k: _map_with_path(fn, *(t[k] for t in trees), path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def _stacked(path) -> bool:
    return "blocks" in path


def _fit_seq(name, tmpl, src, prompt_len: int):
    """Fit a prefill seq leaf into a decode-shaped template (pad the seq
    axis, or ring-roll + keep-latest for bounded windows)."""
    base_rank = 3 if name in ("c_kv", "k_rope") else 4
    ax = _SEQ_LEAVES[name] + (src.ndim - base_rank)
    src_len = src.shape[ax]
    tmpl_len = tmpl.shape[ax]
    if src_len < prompt_len:
        # ring buffer (local window): slot p % w must hold position p
        src = torch.roll(src, prompt_len % src_len, dims=ax)
    if src.shape[ax] <= tmpl_len:
        out = torch.zeros_like(tmpl)
        out.narrow(ax, 0, src.shape[ax]).copy_(src)
        return out
    # template window smaller than source: keep the latest slots
    return src.narrow(ax, src.shape[ax] - tmpl_len, tmpl_len)


def extend_cache(template, prefill_cache, prompt_len: int):
    """Fit ``prefill_cache`` into ``template`` (zeros of decode shape)."""

    def f(path, tmpl, src):
        name = path[-1]
        src = src.to(tmpl.dtype)
        if name in _SEQ_LEAVES:         # before the shape test: a full window rolls
            return _fit_seq(name, tmpl, src, prompt_len)
        if src.shape == tmpl.shape:
            return src
        raise ValueError(
            f"cache leaf {name!r}: prefill shape {tuple(src.shape)} does not fit "
            f"decode template {tuple(tmpl.shape)}")

    return _map_with_path(f, template, prefill_cache)


def write_slots(cache, rows, slots):
    """Scatter the batch rows of ``rows`` into ``cache`` at indices ``slots``,
    in place; returns ``cache``.

    ``rows`` has the tree structure and per-leaf trailing shape of ``cache``
    with batch size ``len(slots)``.  Leaves under the stacked ``"blocks"``
    group carry a leading layer axis, so their batch axis is 1.
    """
    def f(path, dst, src):
        idx = torch.as_tensor(slots, dtype=torch.int64, device=dst.device)
        src = src.to(dst.dtype)
        if _stacked(path):
            dst[:, idx] = src
        else:
            dst[idx] = src

    _map_with_path(f, cache, rows)
    return cache
