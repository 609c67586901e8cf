"""ctypes binding of the Hopper flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``).

The kernel replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``.  It
reads and writes the model layout ``(B, S, H, hd)`` through strides, so the
wrapper neither transposes nor pads: in bf16 at head dim 64, 128 and 192
the library encodes TMA tensor maps over those strides for each call.  The
library is built on the first call, never at import (the CPU tests import
this module).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the library's return code when cuTensorMapEncodeTiled refuses a layout
_TENSOR_MAP_REFUSED = -1
#: the bf16 paths read 16-byte vectors and TMA boxes: base pointers and
#: strides must allow it
_VEC_ELEMS = {torch.float32: 1, torch.bfloat16: 8}


def load_library(path):
    """The built library at ``path``, its C entries typed for ctypes."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                        + [ctypes.c_int64] * 12
                                        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return load_library(build(SOURCE))


def smem_bytes(dtype, hd: int) -> int:
    """Dynamic shared memory of the kernel launched for ``dtype`` at ``hd``."""
    return _lib().flash_attention_smem_bytes(_DTYPES[dtype], hd)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D (B, S, heads, hd)")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
        vec = _VEC_ELEMS.get(q.dtype, 1)
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned "
                             f"per row (strides {t.stride()})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(_DTYPES)}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} q heads over {k.shape[2]} kv heads")
    if min(B, S, k.shape[1]) == 0:
        raise ValueError("flash_attention: empty input")


def launch(lib, q, k, v, causal: bool):
    """Run ``lib``'s kernel on inputs ``_check`` accepts; returns the output.
    Counts nothing: ``flash_attention`` is the path's entry."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     _DTYPES[q.dtype], B, S, T, H, K, hd,
                                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                     *o.stride()[:3], int(causal), 1.0 / math.sqrt(hd), stream)
    if rc == _TENSOR_MAP_REFUSED:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled refused a TMA tensor map for "
                           f"strides q {q.stride()}, k {k.stride()}, v {v.stride()}")
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {rc}")
    return o


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, T, K, hd) CUDA tensors, H = K·G.
    Returns (B, S, H, hd) in q's dtype.  Causal masking is bottom-right
    aligned (row i sees columns <= i + T - S), as in ``attention_ref``."""
    _check(q, k, v)
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"flash_attention: causal with S={q.shape[1]} > T={k.shape[1]}")
    o = launch(_lib(), q, k, v, causal)
    flash_attention.launches += 1
    return o


#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
flash_attention.launches = 0
