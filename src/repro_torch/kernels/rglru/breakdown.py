"""Where K2's time goes on the card: the kernel against copies of its source
with one part taken out or changed, timed on the same inputs at
recurrentgemma-9b's training shape (B=2, S=4096, W=4096) and one serving
prefill (B=1, S=2112, W=4096), both fp32.

    PYTHONPATH=src python -m repro_torch.kernels.rglru.breakdown

Each variant edits ``csrc/rglru_scan.cu`` as text: ``copy only`` keeps the
ring and the TMA stores but drops the recurrence (h = b; its output is
wrong, and only its time is read); ``no prefetch`` and ``full prefetch``
fix the number of chunks in flight per block at 1 and at the ring's depth
(the kernel takes 1 when the grid has more blocks than the card has SMs,
as at the training shape, and the ring's depth otherwise, as at the
prefill); ``look-back`` builds the design that was not kept (``LOOKBACK_CHUNKS``
in the source: time split across blocks in tiles of 4 chunks, with a
single-pass chained scan), which computes the same function and is checked
against the kernel; ``2 stages`` and ``8 stages`` change the depth of the
ring (4 in the kernel).  ``plain loads`` is the kernel's own second path, forced
on the same contiguous inputs.  The copies are built into
``build/ablations/``.  Times are device times: 20 launches captured in a CUDA
graph, replayed twice between CUDA events, per launch.  One JSON line after
the card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels.build import BUILD_DIR, build
from repro_torch.kernels.rglru import rglru_scan as k2

_STAGES = "constexpr int STAGES = 4;"
_DEPTH = "p.depth = LOOKBACK_CHUNKS || (int)(grid.x * grid.y) <= sms ? STAGES : 1;"
VARIANTS = {
    "copy only": [("h[e] = step(av[u][e], h[e], bv[u][e]);", "h[e] = bv[u][e];")],
    "no prefetch": [(_DEPTH, "p.depth = 1;")],
    "full prefetch": [(_DEPTH, "p.depth = STAGES;")],
    "look-back": [("#define LOOKBACK_CHUNKS 0", "#define LOOKBACK_CHUNKS 4")],
    "2 stages": [(_STAGES, "constexpr int STAGES = 2;")],
    "8 stages": [(_STAGES, "constexpr int STAGES = 8;")],
}
#: (B, S, W) of one recurrentgemma-9b training microbatch and of one prefill
SHAPES = {"train": (2, 4096, 4096), "prefill": (1, 2112, 4096)}


def variant_source(edits) -> str:
    text = k2.SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
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
    sources = {"kernel": k2.SOURCE}
    for name, edits in VARIANTS.items():
        src = out_dir / f"rglru_scan_{name.replace(' ', '_').replace('-', '_')}.cu"
        src.write_text(variant_source(edits))
        sources[name] = src
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(build, sources.values())))
    return {name: k2.load_library(path) for name, path in paths.items()}


def breakdown(libs=None) -> dict:
    """Device ms of the kernel, each variant and the plain-loads path at
    each shape; ``look_back_max_abs_diff`` is the look-back design's largest
    difference from the kernel (both compute the same function)."""
    libs = libs or build_variants()
    res = {"device_ms": {}, "look_back_max_abs_diff": {}}
    for tag, (B, S, W) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = 0.2 + 0.799 * torch.rand((B, S, W), generator=gen, device="cuda")
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        row = {name: graph_ms(lambda lib=lib: k2.launch(lib, a, b)) for name, lib in libs.items()}
        row["plain loads"] = graph_ms(lambda: k2.launch(libs["kernel"], a, b, path="loads"),
                                      iters=3)
        res["device_ms"][tag] = row
        want = k2.launch(libs["kernel"], a, b)[0]
        res["look_back_max_abs_diff"][tag] = (
            k2.launch(libs["look-back"], a, b)[0] - want).abs().max().item()
    return {"shapes": {tag: list(s) for tag, s in SHAPES.items()}, **res,
            "card": torch.cuda.get_device_name(0)}


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
