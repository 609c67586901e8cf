"""Where K3's time goes on the card: the kernel against copies of its source
with one part taken out, timed on the same inputs at the rwkv6-7b training
shape (B=2, S=4096, H=64, hd=64, chunk 32, bf16).

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.breakdown

Each variant edits ``csrc/rwkv6_scan.cu`` as text (an ablation's output is
wrong, and only its time is read): ``no pairwise`` drops the diagonal
8-blocks' terms and the off-diagonal products of A, ``no diagonal`` the
former alone, ``no A.v`` and ``no
state`` drop y's A·v and the state products (r'·S and the update), ``no
prefetch`` waits for the next tile's copies right after issuing them, and
``no products`` drops every tensor-core product, leaving the loads, the
prefix sums and the exponentials.  ``phase clocks`` reads ``clock64`` in
warp 0 of block 0 around the two parts of an iteration (the next tile's
state-free work, this tile's products) and the barrier after them, and
reports the cycles per tile of each.  ``sliced`` is not an ablation: it splits
the value columns over two blocks of 8 warps per (b, h) in place of one
block of 16 (step 1 of the source's design note), and is checked against
the kernel.  The copies are built into ``build/ablations/``.  Times are
device times: 20 launches captured in a CUDA graph, replayed twice between
CUDA events, per launch.  One JSON line after the card's name and power
limit.  Needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels.build import BUILD_DIR, build
from repro_torch.kernels.rwkv6 import rwkv6_scan as k3

_PAIRWISE = [("if (live) {\n#pragma unroll 1", "if (false) {\n#pragma unroll 1"),
             ("for (int ti = warp - q0; ti < nq; ti += qn)",
              "for (int ti = warp - q0; ti < 0; ti += qn)")]
_AV = [("for (int j16 = 0; j16 <= I16; ++j16)", "for (int j16 = 0; j16 < 0; ++j16)")]
_STATE = [("for (int d16 = 0; d16 < D / 16; ++d16) {\n          MM::a_mk(a, rp",
           "for (int d16 = 0; d16 < 0; ++d16) {\n          MM::a_mk(a, rp"),
          ("for (int j16 = 0; j16 < n16; ++j16) {\n            MM::a_km",
           "for (int j16 = 0; j16 < 0; ++j16) {\n            MM::a_km")]
_PREFETCH = [("if (c + 2 < ntiles) stage(c + 2, (c + 2) % 3, HALF, HALF);",
              "if (c + 2 < ntiles) stage(c + 2, (c + 2) % 3, HALF, HALF);\n"
              "        cp_async_wait_all();")]
_SLICED = [("  static constexpr int E = D;\n  static constexpr int NW = D / 4;",
            "  static constexpr int E = D == 64 ? 32 : D;\n  static constexpr int NW = D == 64 ? 8 : D / 4;")]
_CLK = "\n    {{ const long long t = clock64(); tclk[{0}] += t - tprev; tprev = t; }}"
_CLOCKS = [("  for (int c = -1; c < ntiles; ++c) {",
            "  long long tclk[3] = {0, 0, 0}, tprev = clock64();\n"
            "  for (int c = -1; c < ntiles; ++c) {"),
           ("    __syncthreads();             // tile c+1 scanned; every warp is done with the last iteration",
            "    __syncthreads();" + _CLK.format(2)),
           ("    }\n    if (c >= 0) {", "    }" + _CLK.format(0) + "\n    if (c >= 0) {"),
           ("\n\n    // 5. tile c+2's prefix sums", _CLK.format(1) + "\n\n    // 5. tile c+2's prefix sums"),
           ("      scan(cs((c + 2) % 3));\n    }\n  }\n}",
            "      scan(cs((c + 2) % 3));\n    }\n  }\n  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
            "    for (int i = 0; i < 3; ++i) reinterpret_cast<float*>(p.y)[i] = (float)tclk[i] / ntiles;\n}")]
#: cycles per tile of warp 0 (a lower-half warp), by part of an iteration
#: (the clock variant writes them into y)
PHASES = ("state-free part of the next tile", "products of this tile", "waiting at the barrier")
VARIANTS = {"no pairwise": _PAIRWISE, "no diagonal": _PAIRWISE[:1], "no A.v": _AV,
            "no state": _STATE, "no prefetch": _PREFETCH,
            "no products": [*_PAIRWISE[1:], *_AV, *_STATE], "sliced": _SLICED,
            "phase clocks": _CLOCKS}
TRAIN_SHAPE = (2, 4096, 64, 64)            # B, S, H, hd of one rwkv6-7b microbatch


def variant_source(edits) -> str:
    text = k3.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def graph_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def build_variants() -> dict:
    """Build the kernel and each variant (one nvcc each, all together)."""
    out_dir = BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"kernel": k3.SOURCE}
    for name, edits in VARIANTS.items():
        src = out_dir / f"rwkv6_scan_{name.replace(' ', '_').replace('.', '')}.cu"
        src.write_text(variant_source(edits))
        sources[name] = src
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(build, sources.values())))
    return {name: k3.load_library(path) for name, path in paths.items()}


def breakdown(libs=None) -> dict:
    """Device ms of the kernel and of each variant at the training shape;
    ``sliced_max_abs_diff`` is the sliced variant's largest difference from
    the kernel (both compute the same function)."""
    libs = libs or build_variants()
    B, S, H, hd = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lw = -(0.01 + 3.99 * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
    u = torch.randn((H, hd), generator=gen, device="cuda")
    row = {name: graph_ms(lambda lib=lib: k3.launch(lib, r, k, v, lw, u, 32))
           for name, lib in libs.items() if name != "phase clocks"}
    diff = (k3.launch(libs["sliced"], r, k, v, lw, u, 32).float()
            - k3.launch(libs["kernel"], r, k, v, lw, u, 32).float()).abs().max().item()
    clocks = k3.launch(libs["phase clocks"], r, k, v, lw, u, 32).flatten()[:2 * len(PHASES)]
    cycles = dict(zip(PHASES, clocks.view(torch.float32).tolist()))
    return {"shape": [B, S, H, hd], "chunk": 32, "device_ms": row, "sliced_max_abs_diff": diff,
            "phase_cycles_per_tile": cycles, "card": torch.cuda.get_device_name(0)}


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps(breakdown()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
