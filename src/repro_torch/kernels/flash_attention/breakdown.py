"""Where K1's time goes on the card: the kernel against copies of its source
with one part taken out, timed on the same inputs.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.breakdown

Each ablation edits ``csrc/flash_attention.cu`` as text (its outputs are
wrong, and only its time is read): ``no exp`` keeps the softmax but not its
exponentials, ``no softmax`` feeds the raw scores to P·V, ``no PV`` and ``no
QK`` drop one product, ``loads only`` keeps the TMA loads, the barriers and
the epilogue.  The copies are built into ``build/ablations/``.  Times are
device times: 20 launches captured in a CUDA graph, replayed twice between
CUDA events, per launch.  PyTorch's ``scaled_dot_product_attention`` is
timed beside them as the yardstick.  One JSON line per shape, after the
card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from repro_torch.kernels.build import BUILD_DIR, build
from repro_torch.kernels.flash_attention import flash_attention as fa

_QK = ("      for (int kk = 0; kk < HD / 16; ++kk)\n        wgmma_ss(",
       "      for (int kk = 0; kk < 0; ++kk)\n        wgmma_ss(")
_PV = ("        wgmma_rs_tb(o, pf[kt], sw128_desc(vs + kt * 16 * 128, L::KV_BOX, 1024), 1);",
       "        ;")
_SOFTMAX = [("    softmax_tile(sc, m, l, alpha, p, 0, row0, t, edge(0));", ""),
            ("      softmax_tile(sc, m, l, alpha, p, i * BN, row0, t, edge(i * BN));", "")]
_EXP = ("    float pe = ex2(fmaf(sc[e], p.scale_log2, -mc[r]));",
        "    float pe = fmaf(sc[e], p.scale_log2, -mc[r]);")
ABLATIONS = {"no exp": [_EXP], "no softmax": _SOFTMAX, "no PV": [_PV], "no QK": [_QK],
             "loads only": [_QK, _PV, *_SOFTMAX]}
#: (B, S, H, K, hd, causal): the whisper-large-v3 encoder, internlm2-20b's layer
SHAPES = {"whisper-large-v3": (1, 1500, 20, 20, 64, False),
          "internlm2-20b": (1, 4096, 48, 8, 128, True)}


def ablation_source(edits) -> str:
    text = fa.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"ablation no longer matches the source: {old!r}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, edits in ABLATIONS.items():
        src = out_dir / f"flash_attention_{name.replace(' ', '_')}.cu"
        src.write_text(ablation_source(edits))
        libs[name] = fa.load_library(build(src))
    libs["kernel"] = fa.load_library(build(fa.SOURCE))
    for arch, (B, S, H, K, hd, causal) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").bfloat16()
                   for n in (H, K, K))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {name: graph_ms(lambda lib=lib: fa.launch(lib, q, k, v, causal))
               for name, lib in libs.items()}
        row["sdpa"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != K))
        print(json.dumps({"shape": arch, "B_S_H_K_hd": [B, S, H, K, hd], "causal": causal,
                          "device_ms": row, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
