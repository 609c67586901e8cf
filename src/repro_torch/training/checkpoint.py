"""Checkpointing: atomic save/restore of train state, async writer, retention
— PyTorch port of ``repro/training/checkpoint.py``.

No external deps: trees (nested dicts, NamedTuples such as ``TrainState``)
are flattened with path-derived keys into ``.npz`` archives, with the
reference's key scheme (``.params/decoder/blocks/0/mixer/w_r``,
``.opt/.step``, …), so either package restores the other's checkpoints.
Saves are atomic (tmp + rename), optionally asynchronous (the state is
copied to host memory before the writer thread starts, so the in-place
optimizer step may run on), and retention keeps the newest K checkpoints.

numpy has no bfloat16: a bf16 leaf is written as fp32 (exact) and cast back
to the template's dtype on restore; a bf16 leaf written by the reference
(``ml_dtypes``, read back by numpy as raw 2-byte records) is read as bf16.
A sharded (DTensor) state is gathered whole for the save (a collective:
every rank of the group takes part), rank 0 alone writes and retains, and
every rank waits for the write before it goes on or restores (a barrier);
a restore reads the file on every rank into the template's placements.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """Children of a tree node with their key segment (JAX's path names:
    dict keys sorted, ``.field`` for a NamedTuple), or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return None


def _paths(tree, prefix=""):
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for key, child in items:
        out += _paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):           # sharded state: every rank gathers
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # ml_dtypes bfloat16
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(like, DTensor):
        return distribute_tensor(t.to(device=like.device, dtype=like.dtype),
                                 like.device_mesh, like.placements)
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(template, leaves: Dict[str, Any], prefix=""):
    items = _items(template)
    if items is None:
        return leaves[prefix]
    built = [(k, _rebuild(c, leaves, f"{prefix}/{k}" if prefix else k)) for k, c in items]
    if isinstance(template, dict):
        return dict(built)
    return type(template)(*(v for _, v in built))


def _unflatten(template, flat: Dict[str, np.ndarray]):
    leaves = {}
    for key, leaf in _paths(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        leaves[key] = _from_numpy(arr, leaf)
    return _rebuild(template, leaves)


def _host_copy(tree):
    return _rebuild(tree, {k: _to_numpy(v) for k, v in _paths(tree)})


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier_due = False

    # -- save -------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[Dict] = None) -> Path:
        self.wait()
        final = self.dir / f"ckpt-{step:08d}.npz"
        self._barrier_due = _group_size() > 1
        if self._barrier_due and dist.get_rank() > 0:
            for _, leaf in _paths(state):       # rank 0's gathers need this rank's shards
                if isinstance(leaf, DTensor):
                    leaf.full_tensor()
        elif self.async_save:
            host_state = _host_copy(state)  # snapshot now
            t = threading.Thread(target=self._write_caught,
                                 args=(step, host_state, metadata or {}))
            t.start()
            self._pending = t
        else:
            self._write(step, state, metadata or {})
        if not self.async_save:
            self.wait()
        return final

    def _write_caught(self, step: int, state, metadata: Dict) -> None:
        try:
            self._write(step, state, metadata)
        except BaseException as e:          # raised again by wait()
            self._error = e

    def _write(self, step: int, state, metadata: Dict) -> Path:
        flat = _flatten(state)
        final = self.dir / f"ckpt-{step:08d}.npz"
        tmp = self.dir / f".tmp-{step:08d}-{os.getpid()}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        meta = dict(metadata, step=step, saved_at=time.time(),
                    leaves=len(flat))
        tmp_meta = self.dir / f".tmp-{step:08d}-{os.getpid()}.json"
        tmp_meta.write_text(json.dumps(meta))
        os.replace(tmp, final)                      # atomic
        os.replace(tmp_meta, self.dir / f"ckpt-{step:08d}.json")
        self._retain()
        return final

    def wait(self) -> None:
        """Wait for the last save: its writer thread, and in a group of
        ranks every rank for rank 0's write.  A failed write raises here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._barrier_due:
            self._barrier_due = False
            dist.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _retain(self) -> None:
        ckpts = self.list_steps()
        for s in ckpts[:-self.keep] if self.keep else []:
            (self.dir / f"ckpt-{s:08d}.npz").unlink(missing_ok=True)
            (self.dir / f"ckpt-{s:08d}.json").unlink(missing_ok=True)

    # -- restore ------------------------------------------------------------
    def list_steps(self) -> List[int]:
        return sorted(int(p.stem.split("-")[1]) for p in
                      self.dir.glob("ckpt-*.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Restore into ``template``'s structure, dtypes and devices."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self.dir / f"ckpt-{step:08d}.npz") as z:
            flat = {k: z[k] for k in z.files}
        meta_path = self.dir / f"ckpt-{step:08d}.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return _unflatten(template, flat), meta
