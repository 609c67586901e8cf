"""ctypes binding of the Hopper RG-LRU scan kernel
(``repro_torch/csrc/rglru_scan.cu``).

The kernel replaces the Pallas TPU kernel
``repro/kernels/rglru/rglru_scan.py::_rglru_kernel``.  It reads a and b in
the model layout ``(B, S, W)`` through their batch and time strides (the
channel axis must be contiguous) and writes a new contiguous h.  The library
is built on the first call, never at import (the CPU tests import this
module).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _entry():
    lib = ctypes.CDLL(str(build(SOURCE)))
    fn = lib.rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"rglru_scan: {name} is on {t.device}, not a CUDA device")
    if a.device != b.device:
        raise ValueError("rglru_scan: a and b must be on one device")
    if a.dtype not in _DTYPES:
        raise ValueError(f"rglru_scan: dtype {a.dtype} not in {list(_DTYPES)}")
    if b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: b is {b.dtype}, a is {a.dtype}")
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "share one (B, S, W) shape")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rglru_scan: the channel axis of a and b must be contiguous")
    if min(a.shape) == 0:
        raise ValueError("rglru_scan: empty input")


def rglru_scan(a, b):
    """a, b: (B, S, W) CUDA tensors, fp32 or bf16.  Returns h (B, S, W) in
    a's dtype with h_t = a_t·h_{t-1} + b_t and h = 0 before the first step."""
    _check(a, b)
    B, S, W = a.shape
    fn = _entry()
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    strides = (ctypes.c_int64 * 6)(*a.stride()[:2], *b.stride()[:2], *h.stride()[:2])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPES[a.dtype], B, S, W,
                strides, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error {rc}")
    rglru_scan.launches += 1
    return h


#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
rglru_scan.launches = 0
