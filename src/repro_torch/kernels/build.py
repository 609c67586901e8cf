"""Build a CUDA source of ``repro_torch/csrc`` into a shared library.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into the
repository's ``build/`` directory (listed in ``.gitignore``) at first use,
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  The library has a plain C
interface and is loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  ``ptxas`` register and shared-memory usage is kept beside the
library as ``<name>.log``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

#: <repo>/build — this file is <repo>/src/repro_torch/kernels/build.py
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
CSRC = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(src: Path) -> Path:
    """Compile ``src`` (once per content) and return the library's path."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per process and thread: two threads may build the same source at once
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file
    return out
