"""ctypes binding of the Hopper RG-LRU scan kernel
(``repro_torch/csrc/rglru_scan.cu``).

The kernel replaces the Pallas TPU kernel
``repro/kernels/rglru/rglru_scan.py::_rglru_kernel``.  It reads a and b in
the model layout ``(B, S, W)`` through their batch and time strides (the
channel axis must be contiguous) and writes a new contiguous h.  The library
is built on the first call, never at import (the CPU tests import this
module).

Which path a call takes (:func:`path_for`): the TMA path when TMA can
describe a, b and h alike — each base 16-byte aligned, and the time and
batch strides of each multiples of 16 bytes below 2^40 (a stride of a
size-1 axis is never stepped along and does not count).  Contiguous inputs
at a width whose row is a multiple of 16 bytes (every model width) take it.
Any other view, such as one element off (``x[..., 1:]``), takes the plain
loads path of the same kernel.  Both compute the same function; neither is
a fallback for the other, and a launch error raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("tma", "loads")
#: the library's return code when cuTensorMapEncodeTiled refuses a layout
_TENSOR_MAP_REFUSED = -1


def load_library(path):
    """The built library at ``path``, its C entry typed for ctypes."""
    lib = ctypes.CDLL(str(path))
    lib.rglru_scan_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                                      ctypes.c_void_p])
    lib.rglru_scan_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return load_library(build(SOURCE))


def tma_describes(ptr: int, shape, strides, elem_size: int) -> bool:
    """Whether a TMA tensor map can describe a (B, S, W) tensor at ``ptr``
    with element ``strides`` (batch, time, channel = 1)."""
    sb, st = strides[0] * elem_size, strides[1] * elem_size
    return not ptr % 16 and (shape[0] == 1 or (not sb % 16 and 0 < sb < 2 ** 40)) and (
        shape[1] == 1 or (not st % 16 and 0 < st < 2 ** 40))


def path_for(*tensors) -> str:
    """``"tma"`` if TMA can describe every one of ``tensors``, else ``"loads"``."""
    for t in tensors:
        if not tma_describes(t.data_ptr(), t.shape, t.stride(), t.element_size()):
            return PATHS[1]
    return PATHS[0]


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
    h, path = launch(_lib(), a, b)
    rglru_scan.launches += 1
    rglru_scan.path_launches[path] += 1
    return h


def launch(lib, a, b, path=None):
    """Run ``lib``'s kernel on inputs ``_check`` accepts; returns (h, the path
    taken).  ``path`` forces a path (the breakdown times both); by default it
    is :func:`path_for` of a, b and h.  Counts nothing: ``rglru_scan`` is the
    path's entry."""
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    path = path or path_for(a, b, h)
    strides = (ctypes.c_int64 * 6)(*a.stride()[:2], *b.stride()[:2], *h.stride()[:2])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPES[a.dtype],
                                B, S, W, strides, int(path == PATHS[0]), stream)
    if rc == _TENSOR_MAP_REFUSED:
        raise RuntimeError("rglru_scan: cuTensorMapEncodeTiled refused the strides "
                           f"{a.stride()}, {b.stride()}, {h.stride()}")
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error {rc}")
    return h, path


#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
rglru_scan.launches = 0
#: the same launches by path (``PATHS``)
rglru_scan.path_launches = dict.fromkeys(PATHS, 0)
