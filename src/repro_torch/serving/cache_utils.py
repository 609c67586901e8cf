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

``write_prefill_paged`` / ``gather_pages`` are the paged-serving variants:
pageable leaves (global attn K/V, MLA latents) live in a shared ``(num_pages+1,
page_size, ...)`` pool indexed through per-row page tables, while resident
leaves (ring-buffer window, recurrent and rwkv carries, cross K/V) keep the
slot-granular layout.  A bool ``flags`` tree (from
``repro_torch.models.paged_cache_flags``) tells the two layouts apart —
leaf names alone cannot (``k``/``v`` is paged under global attention but
resident under a local ring buffer).  The scatter writes the pool in place.
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


def _index(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def write_prefill_paged(flags, cache, prefill_cache, pages, slot, prompt_len: int,
                        page_size: int):
    """Scatter one B=1 prefill into the paged decode cache, in place;
    returns ``cache``.

    Pageable leaves: the prefilled tokens, zero-padded to whole pages, go
    into pool rows ``pages`` — one page id per token block, in block order.
    Prefix reuse passes only the *suffix* prefill here with the suffix's
    private pages; the suffix always starts page-aligned because only whole
    pages are ever shared.  Resident leaves: the row is fitted
    (``extend_cache`` semantics, ring roll included) and written at batch
    ``slot``.
    """
    def f(path, flag, dst, src):
        src = src.to(dst.dtype)
        stacked = _stacked(path)
        if flag:
            s = src[:, 0] if stacked else src[0]        # drop the B=1 axis
            ax = 1 if stacked else 0                    # seq axis after the drop
            n = len(pages)
            pad = n * page_size - s.shape[ax]
            if pad:
                shape = list(s.shape)
                shape[ax] = pad
                s = torch.cat([s, s.new_zeros(shape)], dim=ax)
            s = s.reshape(s.shape[:ax] + (n, page_size) + s.shape[ax + 1:])
            idx = _index(pages, dst.device)
            if stacked:
                dst[:, idx] = s
            else:
                dst[idx] = s
            return
        name = path[-1]
        tmpl = dst[:, :1] if stacked else dst[:1]
        if name in _SEQ_LEAVES:          # before the shape test: a full window rolls
            src = _fit_seq(name, tmpl, src, prompt_len)
        elif src.shape != tmpl.shape:
            raise ValueError(
                f"cache leaf {name!r}: prefill shape {tuple(src.shape)} does not fit "
                f"decode row {tuple(tmpl.shape)}")
        idx = _index([slot], dst.device)
        if stacked:
            dst[:, idx] = src
        else:
            dst[idx] = src

    _map_with_path(f, flags, cache, prefill_cache)
    return cache


def gather_pages(flags, cache, pages):
    """Gather pool pages into contiguous past leaves for prefix reuse.

    Every leaf must be pageable (prefix sharing is gated to pure attn/mla
    stacks); returns ``(1, n_pages * page_size, ...)`` leaves (with the
    leading layer axis kept for stacked ``blocks`` leaves) shaped like a B=1
    prefill of the shared prefix.  The gather copies.
    """
    def f(path, flag, leaf):
        if not flag:
            raise ValueError(f"prefix gather hit a non-paged leaf {path[-1]!r}")
        idx = _index(pages, leaf.device)
        if _stacked(path):
            g = leaf[:, idx]                            # (reps, n, ps, ...)
            return g.reshape((g.shape[0], 1, g.shape[1] * g.shape[2]) + g.shape[3:])
        g = leaf[idx]                                   # (n, ps, ...)
        return g.reshape((1, g.shape[0] * g.shape[1]) + g.shape[2:])

    return _map_with_path(f, flags, cache)
