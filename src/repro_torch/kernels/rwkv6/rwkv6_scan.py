"""ctypes binding of the Hopper RWKV-6 chunked-scan kernel
(``repro_torch/csrc/rwkv6_scan.cu``).

The kernel replaces the Pallas TPU kernel
``repro/kernels/rwkv6/rwkv6_scan.py::_rwkv_kernel``.  It reads r, k, v, lw
and writes y in the model layout ``(B, S, H, hd)`` through strides, so the
wrapper does not transpose (the reference's ``ops.py`` does).  It works in
tiles of the chunk, or of the chunk's largest divisor up to ``MAX_TILE``
tokens for a longer chunk (the chunked form is exact for any chunk).  The
library is built on the first call, never at import (the CPU tests import
this module).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "rwkv6_scan.cu"
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 128
#: tokens per tile inside the kernel (``MAX_TILE`` in the CUDA source)
MAX_TILE = 32
#: dynamic shared memory one Hopper block may use
MAX_SMEM = 232_448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(hd: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block (``Smem`` in the CUDA source), for
    r's dtype; the same for every chunk.  A block takes all hd value
    columns (``Cfg``).  Rows are padded by 16 bytes, the buffers read
    transposed by 8 elements."""
    es = 2 if dtype == torch.bfloat16 else 4
    pad, tile = 16 // es, MAX_TILE
    row = tile * (hd + pad) * es                       # r, k, r'
    stage = 2 * row + tile * (hd + 8) * es + (tile + 1) * (hd + 4) * 4   # + v, prefix sums
    return (3 * stage + 2 * (row + tile * (hd + 8) * es      # r', k' of two tiles
                             + tile * (tile + pad) * es)     # A of two tiles
            + 2 * hd * (hd + pad) * es                      # two copies of the state
            + 4 * hd + 8 * hd)                              # u, two tiles' decay


def load_library(path):
    """The built library at ``path``, its C entry typed for ctypes."""
    lib = ctypes.CDLL(str(path))
    lib.rwkv6_scan_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    lib.rwkv6_scan_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return load_library(build(SOURCE))


def _check(r, k, v, lw, u, chunk):
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)):
        if t.device.type != "cuda":
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}, not a CUDA device")
        if t.device != r.device:
            raise ValueError("rwkv6_scan: all inputs must be on one device")
    if r.dtype not in _DTYPES:
        raise ValueError(f"rwkv6_scan: dtype {r.dtype} not in {list(_DTYPES)}")
    for name, t, want in (("k", k, r.dtype), ("v", v, r.dtype),
                          ("lw", lw, torch.float32), ("u", u, torch.float32)):
        if t.dtype != want:
            raise ValueError(f"rwkv6_scan: {name} is {t.dtype}, expected {want}")
    if r.ndim != 4:
        raise ValueError("rwkv6_scan: r must be 4-D (B, S, H, hd)")
    B, S, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (H, hd):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} != (H, hd) = {(H, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {hd} not in {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_scan: chunk {chunk} not in 1..{MAX_CHUNK}")
    if S % chunk:
        raise ValueError(f"rwkv6_scan: sequence {S} is not a multiple of chunk {chunk}")
    if min(B, S, H) == 0:
        raise ValueError("rwkv6_scan: empty input")


def rwkv6_scan(r, k, v, lw, u, *, chunk: int = 32):
    """r, k, v: (B, S, H, hd) fp32 or bf16; lw: (B, S, H, hd) fp32 log-decay
    (<= 0); u: (H, hd) fp32 — CUDA tensors.  Returns y (B, S, H, hd) in r's
    dtype.  S must be a multiple of ``chunk``."""
    _check(r, k, v, lw, u, chunk)
    y = launch(_lib(), r, k, v, lw, u, chunk)
    rwkv6_scan.launches += 1
    return y


def launch(lib, r, k, v, lw, u, chunk: int):
    """Run ``lib``'s kernel on inputs ``_check`` accepts; returns y.  Counts
    nothing: ``rwkv6_scan`` is the path's entry."""
    B, S, H, hd = r.shape
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 22)(*r.stride(), *k.stride(), *v.stride(), *lw.stride(),
                                    *y.stride(), *u.stride())
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_scan_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                                u.data_ptr(), y.data_ptr(), _DTYPES[r.dtype], B, S, H, hd,
                                chunk, strides, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan: kernel launch failed with CUDA error {rc}")
    return y


#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
rwkv6_scan.launches = 0
