"""Load parameters made by the JAX package into the port.

``params_from_jax`` takes the flat numpy dict that
``repro/training/checkpoint.py::_flatten`` makes from a JAX params tree
(keys such as ``decoder/blocks/0/mixer/wq``) and returns the port's nested
dict of tensors with the same layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``,
stacked ``blocks`` leaves with a leading layer axis).  Arrays are copied:
JAX hands out read-only buffers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes: numpy has no bf16
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(flat: Dict[str, np.ndarray], *, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Flat ``{"a/b/c": array}`` -> nested ``{"a": {"b": {"c": tensor}}}`` on
    ``device`` (default: the card).  ``dtype`` casts floating leaves;
    ``None`` keeps each leaf's own dtype."""
    dev = resolve_device(device)
    tree: dict = {}
    for key, arr in flat.items():
        t = _to_tensor(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.to(dev)
    return tree
