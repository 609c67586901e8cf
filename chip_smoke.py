#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) on any failed check:

1. build — compile the hand-written CUDA kernels of ``src/repro_torch/csrc``
   with nvcc, one process per source, all started together.
2. kernels — flash attention (K1) against its plain PyTorch version at every
   shape of ``tests/test_kernels.py``'s flash sweep and block-shape cases,
   at head dim 192, at a ragged shape (S = T = 333, hd 128), and at the
   whisper-large-v3 encoder shape; there and at the causal GQA attention of
   internlm2-20b (hd 128) and nemotron-4-340b (hd 192) at 4096 tokens, the
   kernel, the plain version and PyTorch's ``scaled_dot_product_attention``
   (a yardstick the port never calls) are timed by their device time
   (``torch.profiler``; K1 and SDPA also back to back with CUDA events),
   each beside its bound; K1's gradient (kernel forward, plain backward)
   against autograd through the plain version.
3. rwkv6 kernel — the RWKV-6 chunked scan (K3) against the sequential
   oracle ``rwkv6_ref`` and the sub-chunk-factored ``rwkv6_subchunked`` at
   every shape of ``test_rwkv6_kernel_sweep`` in both dtypes, the
   chunk-32-vs-128 continuity case, an extreme-decay case (lw in
   [-30, -0.01], 1e-4) and the rwkv6-7b training shape (B=2, S=4096, H=64,
   hd=64, bf16), where the kernel (device time and CUDA events) and both
   plain versions (sequential and chunked) are timed, and
   ``kernels/rwkv6/breakdown.py`` times K3 with one part taken out at a
   time and reads its per-phase clocks.
4. rglru kernel — the RG-LRU scan (K2) against ``rglru_ref`` (and the
   sequential loop) at every shape of ``test_rglru_kernel_sweep`` (1e-4, as
   there) and a bf16 case, then at recurrentgemma-9b's training shape
   (B=2, S=4096, W=4096), one serving prefill (B=1, S=2112, W=4096) and the
   ``generate`` group's prefill (B=4, S=1024, W=4096), where K2 (device time
   and CUDA events), the wrapper's host cost per call, a copy of the same
   bytes (``torch.add(a, b, out=h)``: the card's practical streaming rate,
   not a library call for the recurrence) and ``rglru_ref`` are timed, with
   K2's launches by path (TMA or plain loads); the sequential loop at the
   sweep shapes; K2's gradient (kernel forward, ``rglru_ref`` backward)
   against autograd through ``rglru_ref``; and ``kernels/rglru/breakdown.py``
   times K2 with one part taken out at a time and the design not kept.
5. serving — whisper-large-v3 at full width and depth (32 + 32 layers,
   d_model 1280, vocab 51866, 1500 frames) in bf16 with random seeded
   weights and ``use_pallas=True``: 16 requests through the continuous
   batching engine (``submit`` then ``drain``; its decode steps as CUDA
   graphs, the engine's default on the card) and one ``generate`` group.
   Every encoder attention of every admission must have launched K1.
6. decode_graph whisper — on the same parameters, a graphed and an eager
   engine (``decode_graphs=False``) serve one batch of 8 requests in turns
   (graphed, eager, eager, graphed): greedy tokens identical in all four
   runs; step ms, a window of 8 decode steps (device idle share, device
   kernels, host launch calls), the graphs captured, their capture ms and
   pool bytes, and one step's logits through the graph against the eager
   step from the same cache state.  K1 must launch 32 times per admission.
7. paged whisper — whisper-large-v3 with ``paged=True`` (batch 8, max_seq
   448, page 16), 8 requests against the contiguous engine: K1 must launch
   32 times per admission; no prefix cache.
8. serving_substrate whisper — the port's ``LmServingAdapter`` at full size
   on the same parameters: ``prepare`` (its two calibration requests, 8
   tokens and a quarter of ``max_seq``, fit the prefill price and capture
   the first graph), then ``invoke`` from 8 threads at once with duck-typed
   sessions; each request's measured time beside the surrogate's
   prediction, the backlog the engine held when the twin priced it, and
   their divergence, reported and not held: the first of the 8 requests
   is priced on an idle engine and served behind the admissions that
   arrive after it (ROADMAP C7, open); a 1 ms budget refused ``DEADLINE``
   with no device work, a 60 s budget served; ``snapshot()`` and the
   twin's ``simulate``.  K1 must launch 32 times in every admission.  The
   closed adapter, once dropped, must leave the card's memory within 64
   MiB of where it started, with no cycle collection.
9. parity — the full-width fp32 encoder, layer by layer, through the kernel
   and through the plain path from the same input; the largest difference
   must be <= 1e-3 (see ``parity_phase`` for why per layer).
10. rg serving — recurrentgemma-9b at full width and depth (38 layers:
    12 x (recurrent, recurrent, local_attn) + 2 recurrent; d_model 4096,
    lru_width 4096, 16 heads of 256 with 1 kv head, d_ff 12288, vocab
    256000, window 2048; 10.4 B parameters) in bf16 with random seeded
    weights and ``use_pallas=True``: ``ServingEngine(batch_size=8,
    max_seq=2304)``, 16 requests through ``submit``/``drain`` and one
    ``generate`` group.  Most prompts are multiples of 64 and two are
    longer than the window; K2 must launch 26 times (once per recurrent
    layer) for every prefill whose length is a multiple of 64 and never
    otherwise, each time on its TMA path.
11. decode_graph recurrentgemma — as phase 6 on those parameters (the
    graph's warm-up puts back the recurrent carries it advances); K2's
    launches there all on its TMA path.
12. rg decode parity — full width in fp32 at depth 3: a 2112-token prompt
    (past the 2048 window, so the prefill's window is ring-rolled) decoded
    for 8 tokens; every step's logits against the full forward's, within
    2e-3.
13. paged serving — internlm2-20b at full width cut to ``LM_LAYERS`` = 40
    of its 48 layers (d_model 6144, 48 heads of 128 with 8 kv heads, d_ff
    16384, vocab 92544; 16.74 B parameters; 48 layers, 19.86 B, until the
    vision and distributed phases came) in bf16 with random seeded
    weights: the paged engine
    (``ServingEngine(paged=True)``, batch 8, max_seq 4096, page 16, the
    default pool of 2048 pages) and the contiguous engine, both graphed, on
    the same parameters serve 16 requests in turns (paged, contiguous,
    contiguous, paged): 8 share a 1024-token prefix (64 pages) with suffixes
    of 17-512 tokens, 8 are unrelated (64-2048 tokens); 32 new tokens each,
    one 200.  Prime ms of prefix misses and hits with their bounds, step ms
    beside its bound, tokens/s, ``pool_stats()`` and ``audit_pages()``.
    Fails if a prefix miss's first token differs from the contiguous
    engine's, a request does not finish, a hit prefilled more than its
    suffix, or a page is held by a request after drain or used after flush.
14. decode_graph internlm2 — as phase 6 on those parameters, paged (one
    graph per table width) and contiguous.
15. serving_substrate internlm2 — as phase 8 on those parameters, paged,
    with 8 prompts sharing a 512-token prefix (prefix hits); every
    request's divergence must be within the surrogate's tolerance (0.5).
16. paged parity — internlm2-20b at full width in fp32 (TF32 off) at depth
    4: decode through the page table and a prefix-hit prefill, layer by
    layer from the same input, within 1e-4 of the contiguous layer's
    largest output (the random stack amplifies rounding too much to hold
    whole logits: they are reported beside its 1e-7 sensitivity); the same
    kind of trace within max_seq 1024, where paged greedy tokens must equal
    the contiguous engine's up to near-ties the full forward confirms; a
    small pool refuses with ``QUEUE_SATURATED`` and admits the same request
    after drain.
17. train — rwkv6-7b at full width (d_model 4096, 64 heads of 64, d_ff
    14336, vocab 65536) cut to 4 of 32 layers, bf16 params, fp32 moments,
    ``use_pallas=True``, ``remat_policy="nothing"`` (as before the port had
    remat, so their series stay comparable): 3 steps of the port's
    launcher loop at global
    batch 8 x 4096 tokens in 4 microbatches.  K3 must launch once per layer
    and microbatch (48 times; the backward recomputes through the plain
    chunked version), loss and grad norm must be finite and every layer's
    mixer parameters must receive a gradient.
18. rg train — recurrentgemma-9b at full width cut to 3 of 38 layers (one
    (recurrent, recurrent, local_attn) cycle; 2.76 B parameters with the
    untied 256000 x 4096 embedding and unembedding), bf16 params, fp32
    moments, ``use_pallas=True``: 3 steps of 8 x 4096 tokens in 4
    microbatches.  K2 must launch once per recurrent layer and microbatch
    (24 times, all on its TMA path); loss and grad norm finite; every
    recurrent layer's ``lam``, ``w_a`` and ``w_x`` must receive a gradient.
19. train-parity — rwkv6-7b at full width in fp32, depth 2, B=1, S=1024:
    the loss and its grads through K3 against the plain path, within 5e-3
    on the loss and 1e-3 relative on the grad norm.  Then the same for
    recurrentgemma-9b at depth 3 through K2.  Both at
    ``remat_policy="nothing"``.
20. train_substrate — the port's ``GpuNodeSubstrate`` driven directly
    through duck-typed sessions: rwkv6-7b at full width cut to 2 of 32
    layers (944 M parameters), bf16 params, fp32 moments, ``use_pallas``,
    ``remat_policy`` at its default (``"full"``), 8 x 1024 tokens in 4
    microbatches.  ``prepare`` (the warm-up step), three quanta of 2 steps
    (only the first saves a checkpoint, 11.3 GB), the twin's predicted step
    beside the measured one and the 6·N·D/peak floor, a straggler stalled
    2.5 median steps that must read DEGRADED in its telemetry and
    ``snapshot()``, ``reset("restore_checkpoint")`` back to the saved step
    with the stall cleared, the substrate dropped (memory back within 64
    MiB, no cycle collection), and a second substrate on the checkpoint
    directory resuming the saved step.  K3 must launch twice per layer and
    microbatch in every step (the forward and its recompute), the
    warm-ups' included; losses and grad norms finite.
21. dense_train — qwen2.5-32b at full width (d_model 5120, 40 heads of 128,
    8 kv heads, d_ff 27648, vocab 152064, qkv bias) cut to 2 of 64 layers
    (2.53 B parameters), bf16 params, fp32 moments, ``use_pallas``: 2 steps
    of 8 x 4096 tokens in 4 microbatches under ``remat_policy="nothing"``,
    then 2 under ``"full"``; step ms, tokens/s and peak GB of each.  K1
    must launch once per layer and microbatch, twice under ``"full"``;
    every layer's q/k/v bias must receive a gradient.
22. rwkv_serving — rwkv6-7b at full size (32 layers, 7.06 B parameters) in
    bf16, ``use_pallas``: ``ServingEngine(batch_size=8, max_seq=4096)``,
    graphed, 16 requests (prompts of 17-2100 tokens, multiples of 32 and
    not) and a ``generate`` group; K3 must launch in no prefill (serving
    keeps the state).  An eager engine serves the same requests with
    identical tokens; one step's logits through the graph are bit-equal to
    the eager step's; prime ms and step ms beside their bounds, tokens/s,
    the idle share of 8 decode steps, peak GB.  Then the carries in fp32
    at 4 layers: one decode step after a prefill of n tokens against a
    prefill of n + 1, layer by layer, within 1e-4 of the largest output.
23. moe_serving — moonshot-v1-16b-a3b at full size (48 layers, 28.39 B
    parameters, 56.8 GB in bf16), paged with the prefix cache (page 16, a
    pool of 1,088 pages), graphed, on ``paged_serving``'s 16-request trace
    with its checks; an eager engine with identical tokens, one step's
    logits bit-equal; step ms against the all-experts and the
    active-weights bounds; the (token, expert) pairs the capacity dropped
    in one decode step and one prefill; peak GB.
24. mla_serving — deepseek-v2-236b at full width cut to 4 of 60 layers (1
    dense + 3 MoE; 13.30 B parameters), paged MLA latents with the prefix
    cache, the same trace and checks, and the contiguous engine's tokens
    beside the paged engine's; then both again at a capacity where no
    expert drops a token, where every parting of their tokens must be a
    near-tie of the full forward (both candidates in its top 1000).
25. moe_train — moonshot-v1-16b-a3b at full width cut to 2 of 48 layers,
    8 x 4096 tokens in 4 microbatches under ``"full"``: K1 once per
    attention layer and microbatch and again for the MoE block's
    recompute, the aux loss finite and positive, the 6·N_active·D floor.
26. vision_serving — llama-3.2-vision-90b at full width cut to one cycle,
    5 of its 100 layers (4 ``attn`` + 1 gated ``cross_only``; d_model
    8192, 64 heads of 128 with 8 kv heads, d_ff 28672, vocab 128256, 1600
    image tokens; 6.50 B parameters) in bf16 with ``xgate = 0.5`` and one
    seeded image in every admission: the graphed engine (batch 8, max_seq 4096) serves 16
    requests of 64-2048 tokens, an eager engine the same with identical
    tokens, one step's logits bit-equal (the live rows' image K/V
    non-zero), then the paged engine (image K/V
    resident, no prefix cache) with each first token the contiguous
    engine's.  K1 launches in no prefill.  Prime ms and step ms against
    their bounds (the step reads the rows' 52 MB each of image K/V).
27. vision_parity — the same 5 layers in fp32 with ``xgate = 0.5`` and
    seeded image embeddings: a 300-token prefill and 24 decode steps, layer
    by layer, within 1e-4 of the full forward's largest output at each
    position; the cached image K/V bit-equal to ``cross_kv``.
28. vision_train — the same 5 layers in bf16 with the config's bf16
    moments, ``"full"`` remat and 8 microbatches, ``xgate = 0.5``: 2 steps
    of 8 x 2048 tokens (cut from 4096: see ``VISION_TRAIN_SEQ``) with
    seeded image embeddings; K1's launches as the stack's structure says
    (4 attention layers, twice for the cycle's recompute, per
    microbatch); the cross layer's gate and projections receive a
    gradient; step ms against the 6·N·D floor, peak GB.
29. distributed — internlm2-20b at full width cut to 2 layers, 2 steps of
    4 x 1024 tokens through the launcher's loop on a 1×1 mesh (an NCCL
    group of one) under the ``baseline`` recipe, and with no context, in
    bf16 and in fp32: losses within 5e-3, fp32 grad norms within 1e-3; K1
    launches only without the context.

Output: the card (``nvidia-smi`` name and power limit), one JSON line per
phase, the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM dense peaks (NVIDIA data sheet) for the bound of a kernel
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SERVING_SHAPE = (1, 1500, 20, 20, 64)          # B, S, H, K, hd of the whisper encoder
#: tests/test_kernels.py's flash sweep, head dim 192, ragged S and T at hd 128
SWEEP = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 1, 128),
         (2, 192, 6, 3, 32), (1, 128, 4, 2, 128), (1, 256, 4, 2, 192), (2, 333, 8, 2, 128)]
#: K1 timed beside the serving shape: causal GQA attention of one layer at
#: 4096 tokens (B, S, H, K, hd): internlm2-20b, nemotron-4-340b
ATTN_SHAPES = {"internlm2-20b": (1, 4096, 48, 8, 128), "nemotron-4-340b": (1, 4096, 96, 8, 192),
               "llama-3.2-vision-90b": (1, 4096, 64, 8, 128)}
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}   # (rtol, atol)
#: K1's gradient: (rtol, atol)
GRAD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
#: tests/test_kernels.py::test_rwkv6_kernel_sweep (B, S, H, hd, chunk)
RWKV_SWEEP = [(1, 64, 2, 32, 32), (2, 128, 4, 64, 32), (1, 256, 2, 16, 64)]
#: the largest difference relative to the largest output, as that sweep
RWKV_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: lw in [-30, -0.01]: the plain chunked form is about 2e-5 from float64 there
#: (tests/test_torch_rwkv6.py::test_subchunked_matches_float64_at_extreme_decay)
RWKV_EXTREME_LIMIT = 1e-4
TRAIN_SHAPE = (2, 4096, 64, 64)                 # B, S, H, hd of one rwkv6-7b microbatch
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 3, 8, 4096
#: tests/test_kernels.py::test_rglru_kernel_sweep (B, S, W)
RGLRU_SWEEP = [(1, 128, 128), (2, 256, 256), (1, 512, 384)]
RGLRU_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}  # (rtol, atol)
RGLRU_TRAIN_SHAPE = (2, 4096, 4096)             # B, S, W of one recurrentgemma-9b microbatch
RGLRU_PREFILL_SHAPE = (1, 2112, 4096)           # a serving prefill past the 2048 window
RGLRU_GROUP_SHAPE = (4, 1024, 4096)             # the rg serving ``generate`` group's prefill
RG_TRAIN_LAYERS = 3                             # one (recurrent, recurrent, local_attn) cycle
#: rg serving: 13 of the 16 prompts are multiples of 64; 2112 and 2150 pass the window
RG_LENGTHS = (64, 128, 256, 384, 512, 640, 768, 1024, 1280, 1536, 1792, 2048, 2112, 2150,
              100, 500)
RG_GROUP = (100, 333, 700, 1024)                # padded to 1024: a multiple of 64
RG_MAX_SEQ = 2304
LOGIT_TOL = (2e-3, 2e-3)                        # tests/test_decode_parity.py


def emit(obj) -> None:
    """One JSON line; a phase's line names the card its numbers come from."""
    if "phase" in obj:
        obj = {"phase": obj["phase"], "card": CARD[0], **obj}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()``: the kernels it launches, summed by
    ``torch.profiler`` over ``iters`` calls, per call.  Unlike ``cuda_ms`` it
    leaves out the gaps between kernels, which a host that enqueues more
    slowly than the card runs (a short kernel behind a Python wrapper) would
    otherwise count.  The profiler now and then records no device activity
    for a session; it is asked again, and if it still sees nothing the time
    is taken by ``queued_ms`` and counted in ``TIMER_FALLBACKS``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
    TIMER_FALLBACKS.append(getattr(fn, "__name__", "fn"))
    return queued_ms(fn, iters)


#: calls of ``device_ms`` that the profiler saw no device time for
TIMER_FALLBACKS: list = []


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` by CUDA events, with the ``iters`` calls
    queued behind a spin on the card so that they run back to back: the
    gaps a slow host leaves between launches are not counted.  Raises if
    the host was still enqueueing when the spin ended."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_start, spin_end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    spin_start.record()
    torch.cuda._sleep(200_000_000)        # about 0.1 s at the H100's clocks
    spin_end.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= spin_start.elapsed_time(spin_end):
        raise AssertionError(f"queued_ms: enqueueing took {host_ms:.1f} ms, longer than "
                             "the spin ahead of it")
    return start.elapsed_time(end) / iters


def attention_inputs(B, S, H, K, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v


def check_close(name, out, ref, dtype, tol=TOL) -> float:
    rtol, atol = tol[dtype]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    bad = err > atol + rtol * r.abs()
    if not torch.isfinite(o).all() or bad.any():
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {err.max().item():.3e}, "
                             f"{int(bad.sum())} elements out of tolerance)")
    return err.max().item()


def kernel_phase(fa, mha, mha_ref) -> dict:
    """K1 against its plain version; times at the serving shape and at the
    two causal GQA shapes of ``ATTN_SHAPES``."""
    cases = 0
    for i, (B, S, H, K, hd) in enumerate(SWEEP):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = attention_inputs(B, S, H, K, hd, dtype, seed=i)
                check_close(f"sweep {(B, S, H, K, hd, causal, dtype)}",
                            mha(q, k, v, causal=causal, block_q=64, block_k=64),
                            mha_ref(q, k, v, causal=causal), dtype)
                cases += 1
    for bq, bk in ((32, 32), (64, 128), (128, 64)):
        q, k, v = attention_inputs(1, 256, 4, 2, 64, torch.float32, seed=bq + bk)
        check_close(f"block shape {(bq, bk)}", mha(q, k, v, causal=True, block_q=bq, block_k=bk),
                    mha_ref(q, k, v, causal=True), torch.float32)
        cases += 1

    B, S, H, K, hd = SERVING_SHAPE
    q, k, v = attention_inputs(B, S, H, K, hd, torch.bfloat16, seed=7)
    out = mha(q, k, v, causal=False)
    ref = mha_ref(q, k, v, causal=False)
    err = check_close("serving shape bf16", out, ref, torch.bfloat16)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    err32 = check_close("serving shape fp32", mha(q32, k32, v32, causal=False),
                        mha_ref(q32, k32, v32, causal=False), torch.float32)
    torch.cuda.synchronize()
    cases += 2

    res = dict(cases=cases, shape=list(SERVING_SHAPE), max_abs_err=err, max_abs_err_fp32=err32,
               **flash_times(fa, mha_ref, q, k, v, causal=False))
    flops, nbytes = attention_work(q, k, causal=False)
    res["kernel_ms_fp32"] = cuda_ms(lambda: mha(q32, k32, v32, causal=False), iters=5)
    res["bound_ms_fp32"] = max(flops / PEAK_FP32_FLOPS, 2 * nbytes / PEAK_BYTES) * 1e3
    del q, k, v, q32, k32, v32, out, ref
    res["shapes"] = {}
    for arch, (B, S, H, K, hd) in ATTN_SHAPES.items():
        q, k, v = attention_inputs(B, S, H, K, hd, torch.bfloat16, seed=8)
        res["shapes"][arch] = dict(shape=[B, S, H, K, hd], causal=True,
                                   **flash_times(fa, mha_ref, q, k, v, causal=True))
        del q, k, v
        torch.cuda.empty_cache()
    res["grad_max_rel_err"] = flash_grad_check(mha, mha_ref)
    res["smem_bytes_bf16"] = {hd: fa.smem_bytes(torch.bfloat16, hd) for hd in fa.HEAD_DIMS}
    res["timer_fallbacks"] = list(TIMER_FALLBACKS)
    emit({"phase": "kernels", **res})
    return res


def attention_work(q, k, causal: bool) -> tuple:
    """(FLOPs, bytes) of attention on these inputs: 4·hd FLOPs (QK^T and PV)
    per visible (row, column) pair of each q head — with a bottom-right
    causal mask row i sees min(T, i + T - S + 1) columns, about half — and q,
    k, v read once and o written once."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    pairs = sum(min(T, i + T - S + 1) for i in range(S)) if causal else S * T
    flops = 4 * B * H * pairs * hd
    nbytes = (2 * B * S * H + 2 * B * T * K) * hd * q.element_size()
    return flops, nbytes


def flash_times(fa, mha_ref, q, k, v, causal: bool) -> dict:
    """K1, its plain version and PyTorch's ``scaled_dot_product_attention``
    (a yardstick the port never calls) on the same bf16 inputs, with the
    bound; K1 is checked against the plain version first."""
    check_close(f"K1 at {tuple(q.shape)} causal={causal}",
                fa.flash_attention(q, k, v, causal=causal), mha_ref(q, k, v, causal=causal),
                q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]

    def kernel():
        return fa.flash_attention(q, k, v, causal=causal)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                enable_gqa=gqa)

    kernel_ms, library_ms = device_ms(kernel), device_ms(library)
    with torch.no_grad():
        plain_ms = device_ms(lambda: mha_ref(q, k, v, causal=causal), iters=3)
    # back to back with CUDA events as well: where the host enqueues more
    # slowly than the kernel runs, these read the host's rate
    kernel_events_ms, library_events_ms = cuda_ms(kernel), cuda_ms(library)
    flops, nbytes = attention_work(q, k, causal)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                kernel_events_ms=kernel_events_ms, library_events_ms=library_events_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                flops=flops, bytes=nbytes, tflops=flops / kernel_ms / 1e9)


def flash_grad_check(mha, mha_ref) -> dict:
    """``mha`` (K1 forward, ``mha_ref`` backward) against autograd through
    ``mha_ref`` alone, at one sweep shape per dtype."""
    B, S, H, K, hd = SWEEP[1]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_() for t in attention_inputs(B, S, H, K, hd, dtype, seed=11))
        w = torch.randn((B, S, H, hd), device="cuda")
        got = torch.autograd.grad((mha(q, k, v, causal=True).float() * w).sum(), (q, k, v))
        want = torch.autograd.grad((mha_ref(q, k, v, causal=True).float() * w).sum(), (q, k, v))
        rtol, atol = GRAD_TOL[dtype]
        for name, a, b in zip("qkv", got, want):
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all() or ((a - b).abs() > atol + rtol * b.abs()).any():
                raise AssertionError(f"K1 gradient d{name} ({dtype}) disagrees with the plain "
                                     f"version: max abs err {(a - b).abs().max().item():.3e}")
        out[str(dtype).removeprefix("torch.")] = max(
            ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in zip(got, want))
    return out


def rwkv_inputs(B, S, H, hd, dtype, seed, lw_high=4.0):
    """The sweep's distributions: r, k, v, u ~ N(0, 1); log-decay in
    [-lw_high, -0.01], strong decay included."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    lw = -(0.01 + (lw_high - 0.01) * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
    u = torch.randn((H, hd), generator=gen, device="cuda")
    return r, k, v, lw, u


def check_rel(name, out, ref, limit, what="rwkv6_ref") -> float:
    out, ref = out.float(), ref.float()
    err = ((out - ref).abs().max() / (ref.abs().max() + 1e-6)).item()
    if not torch.isfinite(out).all() or not err < limit:
        raise AssertionError(f"{name}: K3 disagrees with {what} (relative error "
                             f"{err:.3e}, limit {limit:.0e})")
    return err


def rwkv6_work(B, S, H, hd, C, elem_bytes):
    """(FLOPs, of them the products', bytes) of the chunked scan on these
    shapes.  Per chunk: the strict lower triangle of the pairwise matrix
    (sub, exp, 2 mul, add per channel), its diagonal, A.V over the triangle
    and the diagonal, the decayed reads r'.S and the state update
    S*decay + k'^T.v, plus the decay folds.  The products are A.V, r'.S and
    k'^T.v; the rest (pairwise terms, diagonal, folds, state decay) is work
    for the FMA units.  r, k, v, y in their dtype and lw in fp32, each read
    or written once."""
    pairs = C * (C - 1) // 2
    products = 2 * (pairs + C) * hd + 2 * C * hd * hd + 2 * C * hd * hd
    rest = 5 * pairs * hd + 3 * C * hd + 4 * C * hd + hd * hd
    chunks = B * H * (S // C)
    nbytes = B * S * H * hd * (4 * elem_bytes + 4) + H * hd * 4
    return chunks * (products + rest), chunks * products, nbytes


def rwkv6_bound(flops, products, nbytes, dtype) -> dict:
    """The least time for K3's work: the FMA units' share at the fp32 rate
    plus the products at the tensor rate of r's dtype (989 TFLOP/s bf16;
    fp32 inputs are held to fp32 accuracy, counted at 67), against the bytes
    at the memory rate.  ``bound_ms_fp32_units`` counts all of it at the
    fp32 rate, the count this phase reported before the products ran on
    tensor cores."""
    tensor = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops = (flops - products) / PEAK_FP32_FLOPS + products / tensor
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                bound_ops_ms=t_ops * 1e3, bound_bytes_ms=t_bytes * 1e3,
                bound_ms_fp32_units=max(flops / PEAK_FP32_FLOPS, t_bytes) * 1e3)


def rwkv6_kernel_phase(k3, k3_breakdown, time_mix_scan, time_mix_ref, time_mix_chunked,
                       rwkv6_subchunked) -> dict:
    """K3 against the sequential oracle and the sub-chunk-factored plain
    form; times and a breakdown at the training shape."""

    def subchunked(r, k, v, lw, u, chunk=32):
        t = [x.transpose(1, 2) for x in (r, k, v, lw)]
        return rwkv6_subchunked(*t, u, chunk=chunk).transpose(1, 2)

    def check(name, out, args, limit, chunk=32):
        err = check_rel(name, out, time_mix_ref(*args), limit)
        check_rel(name, out, subchunked(*args, chunk=chunk), limit, "rwkv6_subchunked")
        return err

    cases = 0
    for i, (B, S, H, hd, chunk) in enumerate(RWKV_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = rwkv_inputs(B, S, H, hd, dtype, seed=i)
            check(f"sweep {(B, S, H, hd, chunk, dtype)}", time_mix_scan(*args, chunk=chunk), args,
                  RWKV_LIMIT[dtype], chunk)
            cases += 1
    args = rwkv_inputs(1, 128, 2, 32, torch.float32, seed=5, lw_high=1.0)
    o32, o128 = time_mix_scan(*args, chunk=32), time_mix_scan(*args, chunk=128)
    continuity = check_rel("continuity 32 vs 128", o32, o128, RWKV_LIMIT[torch.float32])
    check_rel("continuity 128", o128, time_mix_ref(*args), RWKV_LIMIT[torch.float32])
    # strong decay: both factors of the sub-chunk split stay <= 1; the plain
    # chunked form itself is about 2e-5 (chunk 32) from float64 there
    args = rwkv_inputs(1, 512, 4, 64, torch.float32, seed=6, lw_high=30.0)
    extreme = check("extreme decay", time_mix_scan(*args), args, RWKV_EXTREME_LIMIT)
    cases += 3

    B, S, H, hd = TRAIN_SHAPE
    args = rwkv_inputs(B, S, H, hd, torch.bfloat16, seed=9)
    out = time_mix_scan(*args)
    with torch.no_grad():
        ref = time_mix_ref(*args)
        rel = check_rel("training shape bf16", out, ref, RWKV_LIMIT[torch.bfloat16])
        rel_sub = check_rel("training shape bf16", out, subchunked(*args),
                            RWKV_LIMIT[torch.bfloat16], "rwkv6_subchunked")
    abs_err = (out.float() - ref.float()).abs().max().item()
    cases += 1
    torch.cuda.synchronize()
    del ref

    with torch.no_grad():
        kernel_ms = device_ms(lambda: time_mix_scan(*args), iters=20)
        kernel_events_ms = cuda_ms(lambda: time_mix_scan(*args), iters=20)
        chunked_ms = cuda_ms(lambda: time_mix_chunked(*args), iters=3, warmup=1)
        sequential_ms = cuda_ms(lambda: time_mix_ref(*args), iters=1, warmup=1)
    # what one layer and microbatch of the train step pays: K3 forward, then
    # the backward recomputing through the chunked plain version
    leaves = [t.detach().requires_grad_() for t in args]
    g = torch.randn_like(out)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(time_mix_scan(*leaves), leaves, g),
                         iters=2, warmup=1)
    del leaves, g
    flops, products, nbytes = rwkv6_work(B, S, H, hd, 32, 2)
    res = dict(cases=cases, shape=list(TRAIN_SHAPE), chunk=32, max_abs_err=abs_err,
               max_rel_err=rel, max_rel_err_subchunked=rel_sub, continuity_rel_err=continuity,
               extreme_decay_rel_err=extreme, kernel_ms=kernel_ms,
               kernel_events_ms=kernel_events_ms, plain_chunked_ms=chunked_ms,
               plain_sequential_ms=sequential_ms, fwd_bwd_ms=fwd_bwd_ms,
               **rwkv6_bound(flops, products, nbytes, torch.bfloat16),
               flops=flops, product_flops=products, bytes=nbytes,
               smem_bytes=k3.smem_bytes(hd, torch.bfloat16),
               timer_fallbacks=list(TIMER_FALLBACKS))
    res["breakdown"] = k3_breakdown()
    emit({"phase": "rwkv6_kernel", **res})
    return res


def rglru_inputs(B, S, W, dtype, seed):
    """The sweep's distributions: a ~ U(0.2, 0.999), b ~ N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.2 + 0.799 * torch.rand((B, S, W), generator=gen, device="cuda")
    b = torch.randn((B, S, W), generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def rglru_bound(B, S, W, elem_bytes):
    """(bound ms, bound_by): a and b read once, h written once; one FMA per
    element in fp32."""
    t_ops = 2 * B * S * W / PEAK_FP32_FLOPS
    t_bytes = 3 * B * S * W * elem_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds per call of ``fn``: the enqueue cost, read on the
    host clock with the card idle at the start."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host


def rglru_kernel_phase(k2, k2_breakdown, linear_recurrence, rglru_ref, rglru_sequential) -> dict:
    """K2 against ``rglru_ref`` (and the time loop at the sweep's shapes);
    times at the training, serving prefill and group prefill shapes."""
    sweep = []
    for i, (B, S, W) in enumerate(RGLRU_SWEEP):
        a, b = rglru_inputs(B, S, W, torch.float32, seed=i)
        out = k2.rglru_scan(a, b)
        err = check_close(f"rglru sweep {(B, S, W)}", out, rglru_ref(a, b), torch.float32,
                          RGLRU_TOL)
        check_close(f"rglru sweep {(B, S, W)}, time loop", out, rglru_sequential(a, b),
                    torch.float32, RGLRU_TOL)
        sweep.append(dict(shape=[B, S, W], max_abs_err=err,
                          kernel_ms=cuda_ms(lambda: k2.rglru_scan(a, b)),
                          kernel_device_ms=device_ms(lambda: k2.rglru_scan(a, b)),
                          plain_ms=cuda_ms(lambda: rglru_ref(a, b), iters=5),
                          sequential_ms=cuda_ms(lambda: rglru_sequential(a, b), iters=1,
                                                warmup=1)))
    a, b = rglru_inputs(*RGLRU_SWEEP[1], torch.bfloat16, seed=3)
    bf16_err = check_close("rglru bf16", k2.rglru_scan(a, b), rglru_ref(a, b), torch.bfloat16,
                           RGLRU_TOL)
    grad_err = rglru_grad_check(linear_recurrence, rglru_ref)

    res = dict(cases=len(RGLRU_SWEEP) * 2 + 5, sweep=sweep, bf16_max_abs_err=bf16_err,
               grad_max_rel_err=grad_err)
    for tag, shape in (("", RGLRU_TRAIN_SHAPE), ("_prefill", RGLRU_PREFILL_SHAPE),
                       ("_group", RGLRU_GROUP_SHAPE)):
        a, b = rglru_inputs(*shape, torch.float32, seed=9)
        before = dict(k2.rglru_scan.path_launches)
        out = k2.rglru_scan(a, b)
        res["path" + tag] = [p for p, n in k2.rglru_scan.path_launches.items()
                             if n != before[p]]
        with torch.no_grad():
            ref = rglru_ref(a, b)
        res["max_abs_err" + tag] = check_close(f"rglru shape {shape}", out, ref, torch.float32,
                                               RGLRU_TOL)
        res["max_rel_err" + tag] = ((out - ref).abs().max() / ref.abs().max()).item()
        del ref
        h = torch.empty_like(a)
        with torch.no_grad():
            res["kernel_ms" + tag] = device_ms(lambda: k2.rglru_scan(a, b))
            res["kernel_events_ms" + tag] = cuda_ms(lambda: k2.rglru_scan(a, b))
            res["host_us_per_call" + tag] = host_us(lambda: k2.rglru_scan(a, b))
            res["copy_ceiling_ms" + tag] = device_ms(lambda: torch.add(a, b, out=h))
            res["plain_ms" + tag] = cuda_ms(lambda: rglru_ref(a, b), iters=5)
        res["bound_ms" + tag], res["bound_by" + tag] = rglru_bound(*shape, 4)
        res["shape" + tag] = list(shape)
        if res["path" + tag] != ["tma"]:
            raise AssertionError(f"K2 at {shape} took the {res['path' + tag]} path, not TMA")
    # what one recurrent layer and microbatch of the train step pays: K2
    # forward, then the backward recomputing through the doubling scan
    leaves = [t.detach().requires_grad_() for t in rglru_inputs(*RGLRU_TRAIN_SHAPE,
                                                                torch.float32, seed=9)]
    g = torch.randn(RGLRU_TRAIN_SHAPE, device="cuda")
    res["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(linear_recurrence(*leaves),
                                                            leaves, g), iters=3, warmup=1)
    del leaves, g
    res["breakdown"] = k2_breakdown()
    if not max(res["breakdown"]["look_back_max_abs_diff"].values()) <= RGLRU_TOL[torch.float32][1]:
        raise AssertionError(f"K2's look-back design disagrees with the kernel: "
                             f"{res['breakdown']['look_back_max_abs_diff']}")
    res["timer_fallbacks"] = list(TIMER_FALLBACKS)
    emit({"phase": "rglru_kernel", **res})
    return res


def rglru_grad_check(linear_recurrence, rglru_ref) -> float:
    """``linear_recurrence`` (K2 forward, ``rglru_ref`` backward) against
    autograd through ``rglru_ref`` alone."""
    a, b = (t.requires_grad_() for t in rglru_inputs(*RGLRU_SWEEP[1], torch.float32, seed=11))
    w = torch.randn(a.shape, device="cuda")
    got = torch.autograd.grad((linear_recurrence(a, b) * w).sum(), (a, b))
    want = torch.autograd.grad((rglru_ref(a, b) * w).sum(), (a, b))
    rtol, atol = GRAD_TOL[torch.float32]
    for name, x, y in zip("ab", got, want):
        if not torch.isfinite(x).all() or ((x - y).abs() > atol + rtol * y.abs()).any():
            raise AssertionError(f"K2 gradient d{name} disagrees with the plain version: "
                                 f"max abs err {(x - y).abs().max().item():.3e}")
    return max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want))


def drive_engine(eng, cfg, lengths, group_lengths) -> tuple:
    """Requests of prompt ``lengths`` through ``submit``/``drain``, then one
    ``generate`` group (``serve_trace``: every request must finish with
    in-vocabulary tokens and no logit may be NaN).  The launch counts are
    set to 0 just before and read just after.  Returns the serving metrics
    and, per prefill, (prompt length, launches by kernel)."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    budgets = rng.permutation(np.linspace(8, 64, len(lengths)).astype(int))
    trace = [(f"r{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32), int(m), False)
             for i, (n, m) in enumerate(zip(lengths, budgets))]
    group = [Request(f"g{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     max_new_tokens=16) for i, n in enumerate(group_lengths)]
    reset_counts()
    run = serve_trace(eng, trace, group)
    launches = read_counts()
    prefills = [(len(prompt), a["launches"]) for (_, prompt, _, _), a in
                zip(trace, run["admissions"])] + [(max(group_lengths), run["group_launches"])]
    cb, gen = run["metrics"], run["generate_metrics"]
    res = dict(
        arch=cfg.name, requests=len(trace), prefills=len(prefills), launches=launches,
        prime_ms=cb["prefill_ms"] / len(trace), step_ms=run["step_ms"],
        decode_steps=cb["decode_steps"], tokens=cb["tokens"], tokens_per_s=run["tokens_per_s"],
        wall_s=run["wall_s"], generate_prefill_ms=gen["prefill_ms"],
        generate_step_ms=gen["decode_ms"] / gen["decode_steps"],
        generate_tokens_per_s=sum(r.max_new_tokens for r in group) / run["generate_wall_s"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return res, prefills


def new_engine(cfg, max_seq: int):
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=8, max_seq=max_seq, seed=0)
    torch.cuda.synchronize()
    return eng, dict(params=sum(t.numel() for _, t in tree_leaves(eng.params)),
                     init_s=time.perf_counter() - t0)


def serving_phase(cfg, n_requests: int = 16) -> dict:
    """whisper-large-v3 at full size through the port's engine."""
    eng, info = new_engine(cfg, max_seq=448)
    res, prefills = drive_engine(eng, cfg, np.linspace(4, 64, n_requests).astype(int),
                                 (5, 17, 33, 60))
    launches = res["launches"]["flash_attention"]
    assert launches == cfg.encoder_layers * len(prefills), (
        f"K1 launched {launches} times, expected {cfg.encoder_layers} x {len(prefills)}")
    res.update(info, k1_launches=launches)
    res.update(encoder_breakdown(cfg, eng.params))
    emit({"phase": "serving", **res})
    emit({"phase": "profile", **profile_window(eng, cfg)})
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    return res, params


def rg_serving_phase(cfg) -> dict:
    """recurrentgemma-9b at full width and depth through the port's engine;
    K2 launches once per recurrent layer in every prefill whose length is a
    multiple of 64 (the gate of ``models/rglru.py::rglru_block``), and never
    in the others."""
    n_rec = sum(kind == "recurrent" for kind in cfg.layer_kinds())
    eng, info = new_engine(cfg, max_seq=RG_MAX_SEQ)
    res, prefills = drive_engine(eng, cfg, RG_LENGTHS, RG_GROUP)
    for S, counts in prefills:
        want = n_rec if S % 64 == 0 else 0
        if counts["rglru_scan"] != want:
            raise AssertionError(f"prefill of {S} tokens launched K2 {counts['rglru_scan']} "
                                 f"times, expected {want}")
    k2_launches = res["launches"]["rglru_scan"]
    if k2_launches != n_rec * sum(S % 64 == 0 for S, _ in prefills):
        raise AssertionError(f"K2 launched {k2_launches} times over the serving run")
    if res["launches"]["rglru_scan/tma"] != k2_launches:
        raise AssertionError(f"K2's launches by path in serving: {res['launches']}")
    res.update(info, recurrent_layers=n_rec, k2_launches=k2_launches,
               k2_prefills=sum(S % 64 == 0 for S, _ in prefills),
               longest_prompt=max(RG_LENGTHS), window=cfg.local_window)
    emit({"phase": "rg_serving", **res})
    res["profile"] = profile_window(eng, cfg, prompt_len=64)
    emit({"phase": "rg_profile", **res["profile"]})
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    return res, params


def rg_decode_parity_phase(k2) -> dict:
    """recurrentgemma-9b at full width in fp32 at depth 3: prefill a
    2112-token prompt (past the 2048 window, a multiple of 64, so K2 runs),
    decode 8 tokens, and hold each step's logits to the full forward's
    within 2e-3 (``tests/test_decode_parity.py``).  The prefill's window is
    full, so a cache that skipped the ring roll would hand decode the wrong
    positions.  Beside each step's error stands the full forward's own change
    at that position when the embedding table moves by 1e-7 relative
    (``step_sensitivity``): how far fp32 rounding alone moves that logit."""
    from repro_torch.configs import get_config
    from repro_torch.models import (build_decode_step, build_prefill_step, decode_cache,
                                    full_forward_logits, model_specs)
    from repro_torch.models.common import init_params
    from repro_torch.serving.cache_utils import extend_cache

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=RG_TRAIN_LAYERS,
                              param_dtype="float32", compute_dtype="float32", use_pallas=True)
    P = RGLRU_PREFILL_SHAPE[1]
    total = P + 8
    params = init_params(model_specs(cfg), seed=2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen, device="cuda")
    rtol, atol = LOGIT_TOL
    errs = []

    def check(name, got, want):
        err = (got - want).abs()
        if not torch.isfinite(got).all() or (err > atol + rtol * want.abs()).any():
            raise AssertionError(f"rg decode parity, {name}: max abs err "
                                 f"{err.max().item():.3e} (limit {atol} + {rtol} x |ref|)")
        errs.append(err.max().item())

    with torch.inference_mode():
        full = full_forward_logits(cfg, params, {"tokens": tokens})[0]   # (total, V)
        before = k2.rglru_scan.launches
        cache, logits = build_prefill_step(cfg)(params, {"tokens": tokens[:, :P]})
        launched = k2.rglru_scan.launches - before
        check("prefill", logits[0], full[P - 1])
        cache = extend_cache(decode_cache(cfg, 1, total, "cuda"), cache, P)
        decode = build_decode_step(cfg)
        for pos in range(P, total):
            cache, logits = decode(params, cache, tokens[:, pos:pos + 1], pos)
            check(f"decode at {pos}", logits[0], full[pos])
        embed = params["embed"]
        params["embed"] = embed * (1 + 1e-7 * torch.randn(embed.shape, generator=gen,
                                                          device="cuda"))
        moved = (full_forward_logits(cfg, params, {"tokens": tokens})[0] - full).abs()
        params["embed"] = embed
    if launched != 2:
        raise AssertionError(f"rg decode parity: the prefill launched K2 {launched} times, "
                             "expected 2")
    res = dict(layers=cfg.num_layers, prompt=P, window=cfg.local_window, decoded=total - P,
               k2_launches_prefill=launched, max_abs_err=max(errs), step_errs=errs,
               step_sensitivity=moved[P - 1:].amax(dim=-1).tolist(),
               logit_abs_max=full.abs().max().item())
    emit({"phase": "rg_decode_parity", **res})
    del params, full
    torch.cuda.empty_cache()
    return res


#: paged serving (ROADMAP A.1) at full width: internlm2-20b, one 1024-token
#: prefix (64 pages) shared by 8 requests with suffixes of 17-512 tokens, and 8
#: unrelated prompts of 64-2048 tokens, some not a multiple of the page
PAGED_PREFIX = 1024
PAGED_SUFFIXES = (17, 40, 64, 100, 160, 256, 333, 512)
PAGED_UNRELATED = (64, 100, 250, 512, 777, 1024, 1500, 2048)
PAGED_MAX_SEQ = 4096
#: internlm2-20b's depth in paged_serving, decode_graph internlm2 and
#: serving_substrate internlm2 (48 of 48 before the vision and distributed
#: phases; cut so that the slowest run seen, with them, stays within 1000 s:
#: about 5.6 s a layer)
LM_LAYERS = 40
PAGED_NEW, PAGED_LONG_NEW = 32, 200         # one request decodes 200: 12 page boundaries
#: paged parity (fp32, 4 of 48 layers): the same kind of trace within max_seq 1024
PARITY_PREFIX = 256
PARITY_SUFFIXES = (17, 30, 48, 64, 77, 90, 100, 128)
PARITY_UNRELATED = (40, 64, 100, 160, 250, 333, 400, 512)
PARITY_MAX_SEQ = 1024
#: a paged layer (decode through the page table, or a prefix hit's suffix)
#: against the contiguous one from the same input: the largest difference
#: relative to the largest output (the random full-width stack's residual
#: stream grows to the thousands, and a row's rounding scales with it, not
#: with each element).  fp32 sums of up to 16384 terms round to some 1e-5
#: of it; a wrong page, position or past moves it by O(1)
LAYER_REL = 1e-4


def paged_trace(vocab, prefix_len, suffixes, unrelated, max_new, long_new, seed) -> list:
    """(request id, prompt, max_new_tokens, shares the prefix) in submit
    order: the shared-prefix and unrelated requests alternate, and the
    second shared-prefix request decodes ``long_new`` tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    trace = []
    for i, (n, m) in enumerate(zip(suffixes, unrelated)):
        shared = np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(np.int32)
        trace.append((f"s{i}", shared, long_new if i == 1 else max_new, True))
        trace.append((f"u{i}", rng.integers(0, vocab, m).astype(np.int32), max_new, False))
    return trace


def serve_trace(eng, trace, group=()) -> dict:
    """``trace`` through ``submit`` then ``drain``, then the ``group``
    requests (if any) through one ``generate`` call.  Every request must
    finish with in-vocabulary tokens and no logit may be NaN.  Returns the
    requests, each admission's prefilled tokens, ms and kernel launches (in
    submit order: admission is FIFO), each continuous decode step's ms, the
    cached tokens the continuous steps attended over (each request's
    prompt and tokens so far, for every token after its first), the
    engine's metrics over the continuous run and its wall time, and the
    group's metrics, wall time and prefill launches.  The decode step is
    watched from outside (``step``, then ``last_logits``): a graphed
    engine never calls its eager step function between captures."""
    from repro_torch.serving import Request

    admissions, launched, step_ms, nan_flags = [], [], [], []
    eng.on_prefill_ms = lambda n, ms: admissions.append(dict(tokens=n, ms=ms))
    eng.on_step_ms = step_ms.append
    wrapped = {k: getattr(eng, k) for k in ("_prefill", "_prefill_past")
               if getattr(eng, k, None) is not None}

    def watch_step():
        live = type(eng).step(eng)
        if live:
            nan_flags.append(torch.isnan(eng.last_logits).any())
        return live

    def watch_prefill(step):
        def run(*args):
            before = read_counts()
            out = step(*args)
            nan_flags.append(torch.isnan(out[1]).any())
            after = read_counts()
            launched.append({k: after[k] - before[k] for k in after})
            return out
        return run

    for k, step in wrapped.items():
        setattr(eng, k, watch_prefill(step))
    eng.step = watch_step
    before = dict(eng.metrics)
    reqs = [Request(rid, prompt, max_new_tokens=m) for rid, prompt, m, _ in trace]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.drain()
    wall_s = time.perf_counter() - t0
    del eng.step
    eng.on_step_ms = None
    metrics = {k: eng.metrics[k] - before[k] for k in before}
    out = dict(requests=reqs, admissions=admissions, wall_s=wall_s, metrics=metrics,
               step_ms=metrics["decode_ms"] / metrics["decode_steps"],
               step_ms_all=step_ms, step_ms_median=float(np.median(step_ms)),
               tokens_per_s=metrics["tokens"] / wall_s)
    if group:
        before = dict(eng.metrics)
        t0 = time.perf_counter()
        eng.generate(list(group))
        out["generate_wall_s"] = time.perf_counter() - t0
        out["generate_metrics"] = {k: eng.metrics[k] - before[k] for k in before}
        out["group_launches"] = launched.pop()
    for k, step in wrapped.items():
        setattr(eng, k, step)
    for r in reqs + list(group):
        assert r.done and len(r.generated) == r.max_new_tokens, r.request_id
        assert all(0 <= t < eng.cfg.vocab_size for t in r.generated), r.request_id
    assert not torch.stack(nan_flags).any().item(), "NaN logits in serving"
    assert len(admissions) == len(launched) == len(reqs)
    for a, n in zip(admissions, launched):
        a["launches"] = n
    out["step_kv_tokens"] = sum(len(r.prompt) + j - 1 for r in reqs
                                for j in range(2, r.max_new_tokens + 1))
    out["step_rows"] = sum(r.max_new_tokens - 1 for r in reqs)     # live rows, summed over steps
    return out


def serving_work(cfg) -> dict:
    """Parameter counts the serving bounds read: the decoder's layers (all
    of them, and those a token uses: an expert leaf at top_k / num_experts),
    the unembedding (read whole for every step's logits; the embedding is
    only gathered), the cache bytes one cached token holds (attn K/V, MLA
    latents) and those a batch row holds whatever its length: rwkv state and
    token shifts, which a step reads and writes, and the image K/V of the
    ``cross_only`` layers, which the prefill writes and a step reads once;
    and the attention FLOPs of one (query, key) pair."""
    from repro_torch.models import model_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import build_layer_defs

    m = cfg.moe
    layer = active = 0
    for path, spec in tree_leaves(model_specs(cfg)):
        if path.startswith("decoder/"):
            n = math.prod(spec.shape)
            layer += n
            active += n * m.top_k / m.num_experts if m and "expert" in spec.axes else n
    mixers = [d.mixer for d in build_layer_defs(cfg)]
    attn_layers, mla_layers = mixers.count("attn"), mixers.count("mla")
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    kv = 2 * attn_layers * cfg.num_kv_heads * hd * elem
    pair_flops = 4 * hd * H * attn_layers
    if cfg.mla is not None:
        a = cfg.mla
        kv += mla_layers * (a.kv_lora_rank + a.qk_rope_head_dim) * elem
        pair_flops += 2 * (a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim) * H * mla_layers
    row = 0
    if cfg.rwkv is not None:
        row = mixers.count("rwkv") * (H * cfg.rwkv.head_dim ** 2 * 4 + 2 * cfg.d_model * elem)
    cross_layers = mixers.count("cross_only")
    cross = cross_layers * 2 * cfg.num_image_tokens * H * hd * elem     # ck and cv, full MHA
    cross_pair_flops = 4 * hd * H * cross_layers
    return dict(layer_params=layer, active_layer_params=active,
                head_params=cfg.d_model * cfg.vocab_size, elem=elem, attn_layers=attn_layers,
                mla_layers=mla_layers, kv_token_bytes=kv, row_state_bytes=row,
                cross_layers=cross_layers, row_cross_bytes=cross,
                cross_pair_flops=cross_pair_flops, image_tokens=cfg.num_image_tokens,
                pair_flops=pair_flops)


def prefill_bound(cfg, work, new: int, past: int) -> dict:
    """Least time of one B=1 prefill of ``new`` tokens after ``past`` cached
    ones: 2 FLOPs per active layer parameter and token, the attention FLOPs
    of each visible (query, key) pair and of each (query, image token) pair
    of the ``cross_only`` layers, one token's logits; against the weights
    read once, the past K/V read, the new K/V and the row's image K/V
    written.  The
    peak is bf16's for bf16 and the fp32 units' for fp32 (TF32 off)."""
    pairs = new * past + new * (new + 1) // 2
    flops = (2 * work["active_layer_params"] * new + work["pair_flops"] * pairs
             + work["cross_pair_flops"] * new * work["image_tokens"]
             + 2 * work["head_params"])
    nbytes = ((work["layer_params"] + work["head_params"]) * work["elem"]
              + (past + new) * work["kv_token_bytes"] + work["row_state_bytes"]
              + work["row_cross_bytes"])
    peak = PEAK_BF16_FLOPS if work["elem"] == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes", flops=flops)


def decode_bound_ms(work, kv_tokens: float, rows: int = 0, active: bool = False) -> float:
    """Least time of one decode step: the weights (all but the embedding;
    with ``active`` only the experts' share a token uses, as if only the
    routed experts were read), the live rows' cached K/V, the ``rows``'
    recurrent state (read and written) and their image K/V (read) once, at
    the memory rate (the step's 2·params·rows FLOPs take far less)."""
    params = work["active_layer_params" if active else "layer_params"] + work["head_params"]
    return (params * work["elem"] + kv_tokens * work["kv_token_bytes"]
            + rows * (2 * work["row_state_bytes"] + work["row_cross_bytes"])) / PEAK_BYTES * 1e3


def token_agreement(a, b) -> float:
    """Share of greedy tokens equal position by position."""
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra.generated, rb.generated))
    return same / sum(len(r.generated) for r in a)


def paged_run_summary(cfg, work, run, trace) -> dict:
    """prime ms split by prefix misses and hits (with each admission's
    prefilled tokens and bound), step ms beside its bound, tokens/s."""
    out = {"miss": [], "hit": []}
    for (rid, prompt, _, _), a in zip(trace, run["admissions"]):
        past = len(prompt) - a["tokens"]
        out["hit" if past else "miss"].append(dict(
            id=rid, prompt=len(prompt), prefilled=a["tokens"], ms=a["ms"],
            **prefill_bound(cfg, work, a["tokens"], past)))
    kv = run["step_kv_tokens"] / run["metrics"]["decode_steps"]
    rows = run["step_rows"] / run["metrics"]["decode_steps"]
    res = dict(step_ms=run["step_ms"], step_ms_median=run["step_ms_median"],
               decode_steps=run["metrics"]["decode_steps"],
               step_bound_ms=decode_bound_ms(work, kv, rows), mean_cached_tokens_per_step=kv,
               mean_rows_per_step=rows,
               tokens=run["metrics"]["tokens"], tokens_per_s=run["tokens_per_s"],
               wall_s=run["wall_s"], prefill_ms=run["metrics"]["prefill_ms"])
    for kind in ("miss", "hit"):
        rows = out[kind]
        res[f"prime_ms_{kind}"] = [r["ms"] for r in rows]
        res[f"prime_{kind}"] = rows
        if rows:
            res[f"prime_ms_{kind}_mean"] = sum(r["ms"] for r in rows) / len(rows)
    return res


def check_paged_run(eng, run, trace, prefix_len, name) -> dict:
    """The phase's checks on one paged run: every hit prefilled no more than
    its suffix; after drain no page is held by a request (what stays in use
    is the prefix cache's own reference on each page it registered, as in
    the reference) and nothing is reserved; after flush the pool is empty."""
    for (rid, prompt, _, shares), a in zip(trace, run["admissions"]):
        if a["tokens"] < len(prompt) and a["tokens"] > len(prompt) - prefix_len:
            raise AssertionError(f"{name}: {rid} hit the prefix cache but prefilled "
                                 f"{a['tokens']} tokens, more than its suffix")
    hits = sum(a["tokens"] < len(p) for (_, p, _, _), a in zip(trace, run["admissions"]))
    shared = sum(shares for *_, shares in trace)
    cached = len(eng._prefix) if eng._prefix is not None else 0
    drained = eng.audit_pages()
    stats = eng.pool_stats()
    if drained["reserved"] != 0 or drained["used"] != cached:
        raise AssertionError(f"{name}: after drain {drained} with {cached} prefix-cache "
                             "pages: a request still holds pages")
    eng.flush()
    flushed = eng.audit_pages()
    if flushed["used"] != 0 or flushed["reserved"] != 0:
        raise AssertionError(f"{name}: after flush {flushed}")
    return dict(prefix_hits=hits, shared_prefix_requests=shared, pool_stats=stats,
                audit_after_drain=drained, pages_held_by_requests_after_drain=drained["used"]
                - cached, prefix_cache_pages_after_drain=cached, audit_after_flush=flushed)


def paged_serving_phase(cfg) -> dict:
    """internlm2-20b at full width (``LM_LAYERS`` of 48 layers) in bf16
    with random seeded weights: the paged engine (batch 8, max_seq 4096,
    page 16, the default pool of 2048 pages) and the contiguous engine on
    the same parameter tensors, both with their decode steps as CUDA graphs
    (the default on the card), serve the same 16-request trace, in turns
    (paged, contiguous, contiguous, paged; each run ends in ``flush``).  The
    first token of every prefix miss must equal the contiguous engine's (the
    same B=1 prefill); the greedy tokens of the rest are reported, not held:
    bf16 near-ties flip (``paged_parity`` holds the two layouts in fp32)."""
    from repro_torch.models import count_params, model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    work = serving_work(cfg)
    trace = paged_trace(cfg.vocab_size, PAGED_PREFIX, PAGED_SUFFIXES, PAGED_UNRELATED,
                        PAGED_NEW, PAGED_LONG_NEW, seed=5)
    engines = {"paged": ServingEngine(cfg, params, batch_size=8, max_seq=PAGED_MAX_SEQ,
                                      paged=True, page_size=16),
               "contiguous": ServingEngine(cfg, params, batch_size=8, max_seq=PAGED_MAX_SEQ)}
    runs = {"paged": [], "contiguous": []}
    reset_counts()
    for name in ("paged", "contiguous", "contiguous", "paged"):
        eng = engines[name]
        run = serve_trace(eng, trace)
        summary = paged_run_summary(cfg, work, run, trace)
        if name == "paged":
            summary.update(check_paged_run(eng, run, trace, PAGED_PREFIX, "paged_serving"))
        else:
            eng.flush()
        runs[name].append((run, summary))
    launches = read_counts()
    paged0, contig0 = runs["paged"][0][0], runs["contiguous"][0][0]
    for (rid, prompt, _, _), a, rp, rc in zip(trace, paged0["admissions"],
                                              paged0["requests"], contig0["requests"]):
        if a["tokens"] == len(prompt) and rp.generated[0] != rc.generated[0]:
            raise AssertionError(f"paged_serving: prefix miss {rid} ({len(prompt)} tokens) "
                                 f"gave first token {rp.generated[0]}, the contiguous engine "
                                 f"{rc.generated[0]}")
    for _, summary in runs["paged"]:
        if summary["prefix_hits"] != summary["shared_prefix_requests"] - 1:
            raise AssertionError(f"paged_serving: {summary['prefix_hits']} prefix hits, "
                                 f"expected {summary['shared_prefix_requests'] - 1}")
    profiles = {}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        profiles[name] = profile_window(eng, cfg, prompt_len=64)
        profiles[name]["seconds"] = time.perf_counter() - t0
        eng.flush()
    paged_runs = [run for run, _ in runs["paged"]]
    contig_runs = [run for run, _ in runs["contiguous"]]
    res = dict(
        arch=cfg.name, layers=cfg.num_layers, params=count_params(cfg), init_s=init_s,
        batch=8, max_seq=PAGED_MAX_SEQ, page_size=16, pool_pages=engines["paged"].pool_pages,
        kv_token_bytes=work["kv_token_bytes"], requests=len(trace), launches=launches,
        runs={name: [summary for _, summary in rs] for name, rs in runs.items()},
        token_agreement_bf16=token_agreement(paged0["requests"], contig0["requests"]),
        paged_repeat_agreement=token_agreement(*(r["requests"] for r in paged_runs)),
        contiguous_repeat_agreement=token_agreement(*(r["requests"] for r in contig_runs)),
        profile=profiles, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "paged_serving", **res})
    del engines
    torch.cuda.empty_cache()
    return res, params


def paged_parity_phase() -> dict:
    """internlm2-20b at full width cut to 4 of 48 layers, fp32 (TF32 off).

    The random full-width stack is chaotic: a 1e-7 relative change of the
    embedding moves its fp32 logits by some 0.01-0.2 (``sensitivity_1e7``
    in the report), and the two layouts compute in different shapes (attention
    over the table's width instead of max_seq; a suffix-only prefill), so
    their rounding alone moves the logits that much.  Logits are therefore
    not held whole, as ``parity_phase`` holds the encoder:

    Functions (``paged_step_parity``, ``prefix_hit_parity``): decode steps
    through the page table and a prefix-hit prefill are held layer by
    layer, from the same input, to the contiguous layer within
    ``LAYER_REL``; the gathered prefix K/V must equal the prefill's bit for
    bit.  The whole steps' logits are reported beside the step's own 1e-7
    sensitivity.

    Engines: the paged engine (prefix hits, page growth) must give the
    contiguous engine's greedy tokens, except that a request may part from
    the contiguous one at a near-tie: where the full forward
    (``full_forward_logits``, independent of both layouts) puts both
    tokens within ``near_tie`` of its top logit.  ``near_tie`` is 4 times
    the largest logit change a 1e-7 embedding nudge makes in the decode
    steps of ``paged_step_parity``, which also reports how far the two
    layouts' whole steps differ.  A wrong page or position picks a token
    from anywhere in the 92544-token vocabulary, some 4 logits below the
    top.  Any other parting fails the phase, and so does a prefix miss
    whose first token differs (the same B=1 prefill).  The partings are
    reported with their gaps, and the share of tokens that agree.

    Pool: a small pool must refuse with ``QUEUE_SATURATED`` and a positive
    ``retry_after_s`` and admit the same request after ``drain``."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import AdmissionRefused, ErrorCode
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=4,
                              param_dtype="float32", compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_specs(cfg), seed=1, device="cuda")
    trace = paged_trace(cfg.vocab_size, PARITY_PREFIX, PARITY_SUFFIXES, PARITY_UNRELATED,
                        16, 100, seed=6)
    steps, prefix_hit = paged_step_parity(cfg, params)
    paged = ServingEngine(cfg, params, batch_size=8, max_seq=PARITY_MAX_SEQ, paged=True)
    contiguous = ServingEngine(cfg, params, batch_size=8, max_seq=PARITY_MAX_SEQ)
    run_p, run_c = serve_trace(paged, trace), serve_trace(contiguous, trace)
    near_tie = 4 * max(max(rows) for rows in steps["step_sensitivity_1e7"])
    partings = []
    for (rid, prompt, _, _), a, rp, rc in zip(trace, run_p["admissions"], run_p["requests"],
                                              run_c["requests"]):
        if rp.generated == rc.generated:
            continue
        d = dict(id=rid, prefix_hit=a["tokens"] < len(prompt),
                 **divergence(cfg, params, prompt, rp, rc))
        top = d["full_forward_top3"][0][1]
        d["gaps_to_top"] = [top - x for x in d["full_forward_logits"]]
        partings.append(d)
        if max(d["gaps_to_top"]) > near_tie or (d["at"] == 0 and not d["prefix_hit"]):
            raise AssertionError(f"paged_parity: {rid}'s greedy tokens part from the "
                                 f"contiguous engine's at no near-tie: {d}")
    checks = check_paged_run(paged, run_p, trace, PARITY_PREFIX, "paged_parity")
    if checks["prefix_hits"] != checks["shared_prefix_requests"] - 1:
        raise AssertionError(f"paged_parity: {checks['prefix_hits']} prefix hits")

    small = ServingEngine(cfg, params, batch_size=2, max_seq=PARITY_MAX_SEQ, paged=True,
                          pool_pages=32, prefix_sharing=False)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 200).astype(np.int32) for _ in range(3)]
    held = [small.submit(Request(f"h{i}", p, max_new_tokens=56)) for i, p in enumerate(prompts[:2])]
    try:
        small.submit(Request("over", prompts[2], max_new_tokens=56))
        raise AssertionError("paged_parity: a full pool admitted a request")
    except AdmissionRefused as e:
        refusal = dict(code=e.code.value, message=e.message, detail=e.detail)
        if e.code != ErrorCode.QUEUE_SATURATED or not e.detail["retry_after_s"] > 0:
            raise AssertionError(f"paged_parity: refusal {refusal}")
    small.drain()
    again = small.submit(Request("over", prompts[2], max_new_tokens=56))
    small.drain()
    if not (all(r.done for r in held) and again.done and small.audit_pages()["used"] == 0):
        raise AssertionError(f"paged_parity: after drain {small.audit_pages()}")
    res = dict(arch=cfg.name, layers=cfg.num_layers, dtype="float32", tf32=False,
               requests=len(trace), tokens=run_p["metrics"]["tokens"],
               requests_identical=len(trace) - len(partings),
               token_agreement=token_agreement(run_p["requests"], run_c["requests"]),
               partings=partings, near_tie=near_tie, **checks, prefix_hit_prefill=prefix_hit,
               step_ms_paged=run_p["step_ms"], step_ms_contiguous=run_c["step_ms"],
               decode_steps_parity=steps,
               refusal=refusal, readmitted=True, audit_small=small.audit_pages(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "paged_parity", **res})
    del paged, contiguous, small, params
    torch.cuda.empty_cache()
    return res


def divergence(cfg, params, prompt, a, b) -> dict:
    """Where two requests' greedy tokens part, and what the full forward
    (``full_forward_logits`` over the prompt and the common tokens) gives
    the two candidates there: a gap near fp32 rounding is a near-tie, a
    large one a fault."""
    from repro_torch.models import full_forward_logits

    at = next(i for i, (x, y) in enumerate(zip(a.generated, b.generated)) if x != y)
    seq = np.concatenate([prompt, np.asarray(a.generated[:at], np.int32)])
    with torch.inference_mode():
        logits = full_forward_logits(cfg, params, {"tokens": torch.as_tensor(
            seq[None], dtype=torch.int64, device="cuda")})[0, -1]
    top = torch.topk(logits, 3)
    pair = (a.generated[at], b.generated[at])
    return dict(at=at, tokens=pair,
                full_forward_logits=tuple(logits[t].item() for t in pair),
                full_forward_ranks=tuple(int((logits > logits[t]).sum()) for t in pair),
                full_forward_top3=list(zip(top.indices.tolist(), top.values.tolist())))


def paged_step_parity(cfg, params, lengths=(300, 77), steps=24) -> tuple:
    """Two rows prefilled once; the prefill written both into a contiguous
    cache (``extend_cache`` + ``write_slots``) and into pool pages
    (``write_prefill_paged``); then ``steps`` decode steps of the same
    random tokens, each row on its own timeline and growing into new pages.

    Every step starts from the same cache contents (the K/V the contiguous
    step wrote are copied into the pool slots the paged step wrote).  Held:
    layer by layer from the same input, ``apply_layer_decode`` on the pool
    through the page table against the contiguous cache, within
    ``LAYER_REL`` of the largest output.  Reported: the whole steps'
    logits (``build_decode_step_paged`` against ``build_decode_step``)
    beside the contiguous step's own change when the embedding moves by
    1e-7 relative — the random full-width stack turns the two layouts'
    rounding into logit differences of that size.  Row 0 is also
    prefilled as a prefix hit (``prefix_hit_parity``).  Returns the steps'
    report and the prefix hit's."""
    from repro_torch.models import (build_decode_step, build_decode_step_paged,
                                    build_prefill_step, decode_cache, decode_cache_paged,
                                    paged_cache_flags)
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import _decoder, _embed_tokens
    from repro_torch.models.transformer import _at, apply_layer_decode
    from repro_torch.serving.cache_utils import (extend_cache, gather_pages,
                                                 write_prefill_paged, write_slots)

    ps, B = 16, len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(8)
    need = [-(-(S + steps) // ps) for S in lengths]
    width = 1 << (max(need) - 1).bit_length()
    pages, nxt = [], 1
    for n in need:
        pages.append(list(range(nxt, nxt + n)))
        nxt += n
    flags = paged_cache_flags(cfg)
    contig = decode_cache(cfg, B, PARITY_MAX_SEQ, "cuda")
    pool = decode_cache_paged(cfg, B, PARITY_MAX_SEQ, nxt - 1, ps, "cuda")
    tables = torch.zeros((B, width), dtype=torch.int64, device="cuda")
    prefill = build_prefill_step(cfg)
    dec = _decoder(cfg)
    report = dict(layer_rel_err=[], logit_err=[], step_sensitivity_1e7=[])

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    with torch.inference_mode():
        for b, S in enumerate(lengths):
            tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
            pcache, logits = prefill(params, {"tokens": tokens})
            write_slots(contig, extend_cache(decode_cache(cfg, 1, PARITY_MAX_SEQ, "cuda"),
                                             pcache, S), [b])
            write_prefill_paged(flags, pool, pcache, pages[b][:-(-S // ps)], b, S, ps)
            tables[b, :len(pages[b])] = torch.tensor(pages[b], device="cuda")
            if b == 0:
                past = gather_pages(flags, pool, pages[b][:PARITY_PREFIX // ps])
                prefix_hit = prefix_hit_parity(cfg, params, tokens, pcache, past, logits)
        dense, paged = build_decode_step(cfg), build_decode_step_paged(cfg, ps)
        pos = torch.tensor(lengths, device="cuda")
        rows = torch.arange(B, device="cuda")
        for _ in range(steps):
            token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
            c_layers, p_layers, c_nudged = clone(contig), clone(pool), clone(contig)
            x = _embed_tokens(cfg, params, token)
            rel = []
            for group, key, r, d, lp in dec._layers(params["decoder"]):
                want, _ = apply_layer_decode(cfg, d, lp, x, _at(c_layers[group][key], r),
                                             pos, 0.0)
                got, _ = apply_layer_decode(cfg, d, lp, x, _at(p_layers[group][key], r), pos,
                                            0.0, tables, ps)
                rel.append(((got - want).abs().max() / want.abs().max()).item())
                if not torch.isfinite(got).all() or not rel[-1] <= LAYER_REL:
                    raise AssertionError(f"paged decode at {pos.tolist()}, layer {len(rel) - 1}: "
                                         f"largest difference {rel[-1]:.3e} of the largest "
                                         "output")
                x = want
            embed = params["embed"]
            params["embed"] = embed * (1 + 1e-7 * torch.randn(embed.shape, generator=gen,
                                                              device="cuda"))
            _, moved = dense(params, c_nudged, token, pos)
            params["embed"] = embed
            contig, want = dense(params, contig, token, pos)
            pool, got = paged(params, pool, token, pos, tables)
            if not torch.isfinite(got).all():
                raise AssertionError(f"paged decode at {pos.tolist()}: non-finite logits")
            report["layer_rel_err"].append(max(rel))
            report["logit_err"].append((got - want).abs().amax(-1).tolist())
            report["step_sensitivity_1e7"].append((moved - want).abs().amax(-1).tolist())
            pid, off = tables[rows, pos // ps], pos % ps
            for path, flag in tree_leaves(flags):
                dst, src = tree_get(pool, path), tree_get(contig, path)
                if flag and path.startswith("blocks/"):   # stacked: a leading layer axis
                    dst[:, pid, off] = src[:, rows, pos]
                elif flag:
                    dst[pid, off] = src[rows, pos]
            pos = pos + 1
    report["max_layer_rel_err"] = max(report["layer_rel_err"])
    return report, prefix_hit


def prefix_hit_parity(cfg, params, tokens, pcache, past, logits) -> dict:
    """A prefix hit against the full prefill of ``tokens`` (its cache
    ``pcache`` and last-token ``logits``): ``past`` (gathered from the pool
    pages the full prefill was written into) must equal the prefill's first
    ``PARITY_PREFIX`` positions bit for bit; then, layer by layer from the
    full prefill's input, the suffix rows through
    ``apply_layer_prefill(past=...)`` are held to the full prefill's output
    rows and K/V within ``LAYER_REL`` of their largest value.
    Reported beside it: the
    free-running difference of ``build_prefill_past_step``'s logits and the
    full prefill's own change when the embedding moves by 1e-7 relative."""
    from repro_torch.models import build_prefill_past_step, build_prefill_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import _decoder, _embed_tokens
    from repro_torch.models.transformer import _at, apply_layer_prefill

    P = PARITY_PREFIX
    for path, leaf in tree_leaves(past):
        full = tree_get(pcache, path)
        if not torch.equal(leaf, full.narrow(-3, 0, P)):
            raise AssertionError(f"prefix hit: gathered {path} differs from the prefill's")
    dec = _decoder(cfg)
    positions = torch.arange(tokens.shape[1], device="cuda")
    x = _embed_tokens(cfg, params, tokens)
    layer_err = []
    for group, key, r, d, lp in dec._layers(params["decoder"]):
        lpast = past[group][key] if r is None else _at(past[group][key], r)
        want, wcache, _ = apply_layer_prefill(cfg, d, lp, x, positions, None, 0.0)
        got, gcache, _ = apply_layer_prefill(cfg, d, lp, x[:, P:], positions[P:], None, 0.0,
                                             past=lpast, past_len=P)
        rel = {}
        for name, g, w in (("out", got, want[:, P:]), ("k", gcache["k"], wcache["k"][:, P:]),
                           ("v", gcache["v"], wcache["v"][:, P:])):
            rel[name] = ((g - w).abs().max() / w.abs().max()).item()
            if not torch.isfinite(g).all() or not rel[name] <= LAYER_REL:
                raise AssertionError(f"prefix hit, layer {len(layer_err)} {name}: largest "
                                     f"difference {rel[name]:.3e} of the largest value")
        layer_err.append(rel | {"out_abs_max": want.abs().max().item()})
        x = want
    _, hit = build_prefill_past_step(cfg)(params, {"tokens": tokens[:, P:]}, past)
    gen = torch.Generator(device="cuda").manual_seed(9)
    embed = params["embed"]
    params["embed"] = embed * (1 + 1e-7 * torch.randn(embed.shape, generator=gen,
                                                      device="cuda"))
    _, moved = build_prefill_step(cfg)(params, {"tokens": tokens})
    params["embed"] = embed
    return dict(prefix=P, suffix=tokens.shape[1] - P, layer_rel_err=layer_err,
                free_running_logit_err=(hit - logits).abs().max().item(),
                sensitivity_1e7=(moved - logits).abs().max().item(),
                logit_abs_max=logits.abs().max().item())


def tree_get(tree, path: str):
    """The leaf of a nested dict at a ``tree_leaves`` path (``a/b/c``)."""
    for k in path.split("/"):
        tree = tree[k]
    return tree


def paged_whisper_phase(cfg, params) -> dict:
    """whisper-large-v3 at full size with ``paged=True`` (batch 8, max_seq
    448, page 16) and the contiguous engine on the same parameters serve 8
    requests in turns (paged, contiguous, contiguous, paged).  Every
    admission of either engine must launch K1 32 times (once per encoder
    layer); encdec has no prefix cache; after drain no page is used."""
    from repro_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    paged = ServingEngine(cfg, params, batch_size=8, max_seq=448, paged=True, page_size=16)
    engines = {"paged": paged, "contiguous": ServingEngine(cfg, params, batch_size=8, max_seq=448)}
    rng = np.random.default_rng(9)
    trace = [(f"w{i}", rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32), int(m), False)
             for i, (n, m) in enumerate(zip(np.linspace(4, 64, 8), np.linspace(8, 40, 8)))]
    runs = {"paged": [], "contiguous": []}
    k1 = {"paged": 0, "contiguous": 0}
    for name in ("paged", "contiguous", "contiguous", "paged"):
        eng = engines[name]
        reset_counts()
        run = serve_trace(eng, trace)
        k1[name] += read_counts()["flash_attention"]
        per = [a["launches"]["flash_attention"] for a in run["admissions"]]
        if per != [cfg.encoder_layers] * len(trace):
            raise AssertionError(f"paged_whisper ({name}): K1 launches per admission {per}")
        if name == "paged":
            stats, drained = eng.pool_stats(), eng.audit_pages()
            if "prefix_hit_rate" in stats or eng._prefix is not None:
                raise AssertionError(f"paged_whisper: a prefix cache on encdec: {stats}")
            if drained["used"] != 0 or drained["reserved"] != 0:
                raise AssertionError(f"paged_whisper: after drain {drained}")
        eng.flush()
        runs[name].append(run)
    res = dict(arch=cfg.name, requests=len(trace), batch=8, max_seq=448, page_size=16,
               pool_pages=paged.pool_pages, k1_launches_paged=k1["paged"],
               k1_launches_contiguous=k1["contiguous"], k1_per_admission=cfg.encoder_layers,
               pool_stats=stats, audit_after_drain=drained, audit_after_flush=paged.audit_pages(),
               token_agreement=token_agreement(runs["paged"][0]["requests"],
                                               runs["contiguous"][0]["requests"]),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name, rs in runs.items():
        res[f"prime_ms_{name}"] = [r["metrics"]["prefill_ms"] / len(trace) for r in rs]
        res[f"step_ms_{name}"] = [r["step_ms"] for r in rs]
        res[f"tokens_per_s_{name}"] = [r["tokens_per_s"] for r in rs]
    emit({"phase": "paged_whisper", **res})
    del paged, engines
    torch.cuda.empty_cache()
    return res


#: decode_graph: one batch of 8 requests per arch (prompt lengths), 48 new
#: tokens each, served by a graphed and an eager engine in turns
GRAPH_NEW = 48
GRAPH_LENGTHS = {"internlm2-20b": (64, 128, 192, 256, 384, 512, 768, 1024),
                 "whisper-large-v3": (4, 8, 16, 24, 32, 40, 48, 64),
                 "recurrentgemma-9b": (64, 100, 128, 256, 333, 512, 768, 1024)}


def decode_window(eng, cfg, prompt_len: int, steps: int = 8) -> dict:
    """Device busy and idle share over ``steps`` decode steps of a full
    batch and nothing else: the batch is admitted and steps once (which
    captures a graphed engine's graph) before the window opens.  The
    window runs twice on the same prompts: on the host clock alone
    (``wall_ms_unprofiled``), then under ``torch.profiler``, whose tracing
    stretches the host's part of a step; ``device_idle_share_unprofiled``
    sets the profiled busy time against the unprofiled wall time."""
    from repro_torch.serving import Request

    def window(run):
        rng = np.random.default_rng(2)
        for i in range(eng.batch_size):
            eng.submit(Request(f"w{i}", rng.integers(0, cfg.vocab_size, prompt_len)
                               .astype(np.int32), max_new_tokens=steps + 2))
        eng.step()
        torch.cuda.synchronize()
        out = run(lambda: [eng.step() for _ in range(steps)])
        eng.drain()
        eng.flush()
        return out

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = window(wall)
    res = window(device_profile)
    if "profile_device_busy_ms" in res:
        res["device_idle_share_unprofiled"] = 1 - res["profile_device_busy_ms"] / wall_ms
    return dict(steps=steps, prompt=prompt_len, wall_ms_unprofiled=wall_ms, **res)


def graph_logits_check(eng, cfg, prompt_len: int = 64, resident=None) -> dict:
    """One decode step's logits from the same cache state through the
    eager step function and through the graph.  A full batch is admitted
    and steps once; the next step's inputs then go through both (the K/V
    the eager step writes are the ones the graph writes again; the
    recurrent carries it advances are put back first).  ``resident`` names
    a cache leaf (keys from the cache's root) whose largest magnitude over
    the live rows is reported.  The engine is flushed after."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import Request
    from repro_torch.serving.engine import _CARRIES

    rng = np.random.default_rng(3)
    for i in range(eng.batch_size):
        eng.submit(Request(f"l{i}", rng.integers(0, cfg.vocab_size, prompt_len + 3 * i)
                           .astype(np.int32), max_new_tokens=4))
    eng.step()
    with torch.inference_mode():
        live = [s for s in eng._slots if s.request is not None]
        width = eng._grow_tables(live) if eng._pool is not None else None
        inputs = eng._step_inputs(width)
        carries = [(t, t.clone()) for path, t in tree_leaves(eng._cb_cache)
                   if path.rsplit("/", 1)[-1] in _CARRIES]
        _, eager = eng._decode(eng.params, eng._cb_cache, *inputs)
        eager = eager.clone()
        for t, saved in carries:
            t.copy_(saved)
        graph = eng._graphs.get(width) or eng._capture(width, inputs)
        graph[0].replay()
        graphed = graph[1].clone()
        extra = {}
        if resident is not None:
            leaf = eng._cb_cache
            for key in resident:
                leaf = leaf[key]
            rows = torch.tensor([s.index for s in live], device=leaf.device)
            extra["resident_abs_max"] = leaf.index_select(1, rows).abs().max().item()
    eng.flush()
    return dict(rows=len(live), width=width, bit_equal=bool(torch.equal(graphed, eager)),
                max_abs_diff=(graphed - eager).abs().max().item(),
                argmax_equal=bool(torch.equal(graphed.argmax(-1), eager.argmax(-1))),
                logit_abs_max=eager.abs().max().item(), **extra)


def graph_pool_bytes(eng):
    """Bytes of the segments the caching allocator holds for the engine's
    graph pool (``torch.cuda.memory_snapshot``)."""
    if eng._graph_pool is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in s for s in segments):
        return "not measured"
    return sum(s["total_size"] for s in segments
               if tuple(s.get("segment_pool_id", ())) == tuple(eng._graph_pool))


def decode_graph_phase(cfg, params, layouts, max_seq: int, window_prompts) -> dict:
    """``cfg`` at full size on ``params``: for each layout, a graphed and an
    eager engine (``decode_graphs=False``) serve one batch of 8 requests
    (``GRAPH_LENGTHS``, 48 new tokens each) in turns (graphed, eager,
    eager, graphed).  Greedy tokens must be identical in all four runs.
    Reported per engine: step ms (mean and median), tokens/s, peak memory;
    a window of 8 decode steps at each of ``window_prompts`` (device idle
    share, device kernels, host launch calls); for the graphed engine the graphs captured (by table
    width), their capture ms and the pool's bytes, and one step's logits
    through the graph against the eager step from the same cache state."""
    from repro_torch.serving import ServingEngine

    rng = np.random.default_rng(11)
    trace = [(f"d{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32), GRAPH_NEW, False)
             for i, n in enumerate(GRAPH_LENGTHS[cfg.name])]
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=8, max_seq=max_seq,
               prompts=list(GRAPH_LENGTHS[cfg.name]), new_tokens=GRAPH_NEW, layouts={})
    reset_counts()
    for layout in layouts:
        engines = {name: ServingEngine(cfg, params, batch_size=8, max_seq=max_seq,
                                       paged=layout == "paged", page_size=16,
                                       decode_graphs=name == "graphed")
                   for name in ("graphed", "eager")}
        runs = {"graphed": [], "eager": []}
        for name in ("graphed", "eager", "eager", "graphed"):
            eng = engines[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = serve_trace(eng, trace)
            run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            run["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
            eng.flush()
            runs[name].append(run)
        tokens = [[r.generated for r in run["requests"]] for rs in runs.values() for run in rs]
        if any(t != tokens[0] for t in tokens):
            raise AssertionError(f"decode_graph {cfg.name} {layout}: greedy tokens differ; "
                                 "agreement graphed/eager "
                                 f"{token_agreement(runs['graphed'][0]['requests'], runs['eager'][0]['requests'])}")
        g = engines["graphed"]
        res = dict(tokens_identical=True, tokens=runs["graphed"][0]["metrics"]["tokens"])
        for key in ("step_ms", "step_ms_median", "tokens_per_s", "wall_s", "peak_mem_gb",
                    "reserved_gb"):
            res[key] = {name: [run[key] for run in rs] for name, rs in runs.items()}
        res["prime_ms"] = {name: [run["metrics"]["prefill_ms"] / len(trace) for run in rs]
                           for name, rs in runs.items()}
        res["decode_steps"] = runs["graphed"][0]["metrics"]["decode_steps"]
        res["logits"] = graph_logits_check(g, cfg, window_prompts[0])
        res["windows"] = {p: {name: decode_window(eng, cfg, p) for name, eng in engines.items()}
                          for p in window_prompts}
        res["graphs"] = ["contiguous" if k is None else k for k in g.graph_capture_ms]
        res["capture_ms"] = list(g.graph_capture_ms.values())
        res["graph_pool_bytes"] = graph_pool_bytes(g)
        out["layouts"][layout] = res
        del engines, g, eng, runs
        torch.cuda.empty_cache()
    out["launches"] = read_counts()
    # each layout: 4 runs of the trace, four batches of 8 per window prompt
    # (two per engine) and one for the logits check
    out["admissions"] = len(layouts) * (4 * len(trace) + (4 * len(window_prompts) + 1) * 8)
    emit({"phase": f"decode_graph {cfg.name}", **out})
    return out


#: serving_substrate: 8 requests at once through the adapter, per arch
SUBSTRATE_NEW = 32
SUBSTRATE_PREFIX = 512


def serving_substrate_phase(cfg, params, *, max_seq: int, paged: bool, prompts,
                            k1_per_admission: int = 0, hold_divergence: bool = False) -> dict:
    """The port's ``LmServingAdapter`` at full size on ``params``, driven as
    a control plane drives it: ``prepare`` (the calibration request, where
    the first decode graph is captured), then ``invoke`` with duck-typed
    sessions from 8 threads at once, ``SUBSTRATE_NEW`` new tokens each.
    Per request: the measured ``total_ms`` beside the surrogate's
    ``predicted_total_ms`` (priced just before the invoke, behind the
    backlog the engine holds then, which depends on which threads submitted
    first: ROADMAP C7), that backlog, and their divergence as
    ``ServingSurrogate.divergence`` scores it.  Then a doomed budget (1 ms)
    must be refused ``DEADLINE`` with no device work (engine metrics and
    kernel launches unchanged) and a generous one (60 s) served;
    ``snapshot()`` and the twin's ``simulate`` are reported.  Where
    ``k1_per_admission`` is set (whisper), K1 must launch that many times
    in every admission (the calibrations' included).  With
    ``hold_divergence`` every request's divergence must be within the
    surrogate's own tolerance (ROADMAP C5, C7)."""
    import types

    from repro_torch.core.errors import AdmissionRefused, ErrorCode
    from repro_torch.substrates import LmServingAdapter

    def session(tid, prompt, budget_ms=None):
        return types.SimpleNamespace(task=types.SimpleNamespace(
            task_id=tid, payload={"prompt": [int(t) for t in prompt],
                                  "max_new_tokens": SUBSTRATE_NEW},
            latency_budget_ms=budget_ms))

    reset_counts()
    allocated = torch.cuda.memory_allocated()
    adapter = LmServingAdapter(cfg.name, cfg=cfg, params=params, batch_size=8, max_seq=max_seq,
                               paged=paged, device="cuda")
    t0 = time.perf_counter()
    adapter.prepare(None)
    prepare_s = time.perf_counter() - t0
    twin = adapter.make_twin()
    try:
        def one(i):
            s = session(f"s{i}", prompts[i])
            sim = twin.surrogate.simulate(s.task)
            raw = adapter.invoke(s)
            if len(raw["output"]["tokens"]) != SUBSTRATE_NEW:
                raise AssertionError(f"serving_substrate: {raw['output']}")
            return dict(id=f"s{i}", prompt=len(prompts[i]), total_ms=raw["output"]["total_ms"],
                        predicted_total_ms=sim["output"]["predicted_total_ms"],
                        divergence=twin.surrogate.divergence(raw["output"], sim["output"]),
                        **{k: sim["telemetry"][k] for k in (
                            "backlog_tokens", "backlog_prefill_tokens", "prefix_cached_tokens")},
                        ttft_ms=raw["telemetry"]["ttft_ms"],
                        deadline_expired=raw["telemetry"]["deadline_expired"])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            requests = list(pool.map(one, range(len(prompts))))
        wall_s = time.perf_counter() - t0
        with adapter.engine._lock:            # waits for a step in flight
            metrics, counts = dict(adapter.engine.metrics), read_counts()
        try:
            adapter.invoke(session("doomed", prompts[0], budget_ms=1.0))
            raise AssertionError("serving_substrate: a 1 ms budget was served")
        except AdmissionRefused as e:
            refusal = dict(code=e.code.value, message=e.message, detail=e.detail)
            if e.code != ErrorCode.DEADLINE:
                raise
        with adapter.engine._lock:
            untouched = adapter.engine.metrics == metrics and read_counts() == counts
        if not untouched:
            raise AssertionError("serving_substrate: the refused request reached the device")
        generous = adapter.invoke(session("generous", prompts[1], budget_ms=60_000.0))
        if generous["telemetry"]["deadline_expired"]:
            raise AssertionError(f"serving_substrate: a 60 s budget expired: {generous}")
        snapshot = adapter.snapshot().to_dict()
        simulated = twin.surrogate.simulate(session("twin", prompts[0]).task)
        engine = adapter.engine
    finally:
        adapter.close()
    launches = read_counts()
    admissions = len(prompts) + 3                 # two calibration prefills, the generous request
    res = dict(arch=cfg.name, layers=cfg.num_layers, paged=paged, max_seq=max_seq,
               resource_id=adapter.resource_id, prepare_s=prepare_s, wall_s=wall_s,
               requests=requests, refusal=refusal,
               generous=dict(total_ms=generous["output"]["total_ms"],
                             ttft_ms=generous["telemetry"]["ttft_ms"]),
               snapshot=snapshot, twin_simulate=simulated["output"] | simulated["telemetry"],
               graphs=["contiguous" if k is None else k for k in engine.graph_capture_ms],
               capture_ms=list(engine.graph_capture_ms.values()), launches=launches,
               k1_launches=launches["flash_attention"], admissions=admissions,
               pool_stats=engine.pool_stats())
    emit({"phase": f"serving_substrate {cfg.name}", **res})
    worst = max(requests, key=lambda q: q["divergence"])
    if hold_divergence and worst["divergence"] > twin.surrogate.tolerance:
        raise AssertionError(f"serving_substrate {cfg.name}: the twin diverged "
                             f"{worst['divergence']:.3f} from {worst['id']}, past its "
                             f"tolerance {twin.surrogate.tolerance}")
    if k1_per_admission and launches["flash_attention"] != k1_per_admission * admissions:
        raise AssertionError(f"serving_substrate {cfg.name}: K1 launched "
                             f"{launches['flash_attention']} times over {admissions} admissions")
    # a closed adapter lets go of its engine: dropping the last references
    # frees the engine's cache and graphs at once, with no cycle collection
    del engine, adapter
    torch.cuda.empty_cache()
    # a leaked engine holds GBs (its cache, and the parameters through it)
    if torch.cuda.memory_allocated() > allocated + (64 << 20):
        raise AssertionError(f"serving_substrate {cfg.name}: {torch.cuda.memory_allocated()} "
                             f"bytes allocated after the adapter closed, {allocated} before")
    return res


#: rwkv_serving: rwkv6-7b at full size; prompts that are multiples of 32 and
#: others (a remainder chunk after the chunks of 32), up to past 2048
RWKV_LENGTHS = (17, 45, 64, 77, 300, 1000, 2047, 2100, 32, 128, 33, 96, 256, 500, 1024, 1500)
RWKV_GROUP = (100, 333, 700, 1024)              # the generate group, padded to 1024
RWKV_MAX_SEQ = 4096
#: the carry check: fp32 at full width, this many layers, after these prefills
RWKV_CARRY_LAYERS = 4
RWKV_CARRY_LENGTHS = (17, 45, 64, 300, 2047)
#: moe_serving: moonshot-v1-16b-a3b at full size, paged; the pool holds the
#: trace's reservations (about 1,050 pages of 16 tokens, 393 KB a token)
MOE_POOL_PAGES = 1088
#: moe_train / mla_serving depths
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2
MLA_LAYERS = 4                                  # 1 dense + 3 MoE of deepseek-v2-236b's 60
#: a parting of the paged and contiguous MLA engines is a near-tie when both
#: tokens rank below this in the full forward's logits (of 102400)
LAYOUT_RANK = 1000


def new_trace(cfg, lengths, max_new, seed) -> list:
    """``serve_trace`` requests of the given prompt lengths and budgets."""
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32), int(m), False)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


def tokens_of(run) -> list:
    return [r.generated for r in run["requests"]]


def graphed_against_eager(cfg, params, trace, graphed_run, image=None, **engine_kw) -> dict:
    """An eager engine (``decode_graphs=False``) with ``engine_kw`` serves the
    trace the graphed engine served in ``graphed_run`` (with ``image`` as
    every admission's image embeddings where given): the greedy tokens
    must be identical.  Returns the eager run's step ms, tokens/s and
    prime ms."""
    from repro_torch.serving import ServingEngine

    eager = ServingEngine(cfg, params, batch_size=8, decode_graphs=False, **engine_kw)
    if image is not None:
        feed_image(eager, image)
    run = serve_trace(eager, trace)
    if tokens_of(run) != tokens_of(graphed_run):
        raise AssertionError(f"{cfg.name}: graphed and eager greedy tokens differ; agreement "
                             f"{token_agreement(graphed_run['requests'], run['requests'])}")
    out = dict(tokens_identical=True, step_ms=run["step_ms"],
               step_ms_median=run["step_ms_median"], tokens_per_s=run["tokens_per_s"],
               prime_ms=run["metrics"]["prefill_ms"] / len(trace))
    del eager, run
    torch.cuda.empty_cache()
    return out


def moe_drops(eng, cfg, prompt_len: int = 1024) -> dict:
    """(token, expert) pairs the capacity dropped, summed over the MoE
    layers, in one eager decode step of a full batch (each row on its own
    timeline) and in one B=1 prefill of ``prompt_len`` tokens; counted by
    wrapping ``models/moe.py::_dispatch`` around eager calls only (no
    graph is captured meanwhile).  The engine is flushed after."""
    from repro_torch.models import moe
    from repro_torch.serving import Request

    counts = []
    dispatch = moe._dispatch

    def counting(top_i, num_experts, cap):
        out = dispatch(top_i, num_experts, cap)
        counts.append(((~out[3]).sum(), out[3].numel(), cap))
        return out

    rng = np.random.default_rng(4)
    for i in range(eng.batch_size):
        eng.submit(Request(f"m{i}", rng.integers(0, cfg.vocab_size, 64 + 5 * i)
                           .astype(np.int32), max_new_tokens=4))
    eng.step()
    res = {}
    moe._dispatch = counting
    try:
        with torch.inference_mode():
            live = [s for s in eng._slots if s.request is not None]
            width = eng._grow_tables(live) if eng._pool is not None else None
            eng._decode(eng.params, eng._cb_cache, *eng._step_inputs(width))
            res["decode"] = counts[:]
            counts.clear()
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                                     device="cuda")
            eng._prefill(eng.params, {"tokens": tokens})
            res["prefill"] = counts[:]
    finally:
        moe._dispatch = dispatch
    eng.flush()
    return {k: dict(rows=eng.batch_size if k == "decode" else 1,
                    tokens=eng.batch_size if k == "decode" else prompt_len,
                    moe_layers=len(v), capacity=v[0][2],
                    pairs=sum(n for _, n, _ in v),
                    dropped=int(sum(d for d, _, _ in v).item())) for k, v in res.items()}


def rwkv_serving_phase(cfg) -> dict:
    """rwkv6-7b at full size (32 layers, 7.06 B parameters) in bf16 with
    random seeded weights and ``use_pallas=True``: ``ServingEngine(batch_size=8,
    max_seq=4096)``, graphed, 16 requests through ``submit``/``drain`` and
    one ``generate`` group.  K3 must launch in no prefill: serving keeps
    the state, and the reference's gate (``want_state``) keeps that path off
    the kernel.  An eager engine serves the same 16 requests with identical
    tokens; one step's logits through the graph are bit-equal to the eager
    step's; ``rwkv_carry_parity`` holds the carries in fp32.  Reported:
    prime ms against the admissions' bounds, step ms against one read of
    the weights and the rows' state, tokens/s, the device idle share of 8
    decode steps, peak GB."""
    from repro_torch.serving import Request

    eng, info = new_engine(cfg, max_seq=RWKV_MAX_SEQ)
    budgets = np.random.default_rng(0).permutation(
        np.linspace(8, 64, len(RWKV_LENGTHS)).astype(int))
    trace = new_trace(cfg, RWKV_LENGTHS, budgets, seed=3)
    rng = np.random.default_rng(4)
    group = [Request(f"g{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     max_new_tokens=16) for i, n in enumerate(RWKV_GROUP)]
    reset_counts()
    run = serve_trace(eng, trace, group)
    launches = read_counts()
    if launches["rwkv6_scan"]:
        raise AssertionError(f"rwkv_serving: K3 launched {launches['rwkv6_scan']} times; "
                             "the prefill keeps its state and must not take it")
    work = serving_work(cfg)
    prime = [dict(prompt=n, ms=a["ms"], **prefill_bound(cfg, work, n, 0))
             for n, a in zip(RWKV_LENGTHS, run["admissions"])]
    gen = run["generate_metrics"]
    res = dict(
        arch=cfg.name, layers=cfg.num_layers, max_seq=RWKV_MAX_SEQ, requests=len(trace),
        launches=launches, prime=prime, prime_ms=run["metrics"]["prefill_ms"] / len(trace),
        prime_bound_ms_mean=sum(p["bound_ms"] for p in prime) / len(prime),
        step_ms=run["step_ms"], step_ms_median=run["step_ms_median"],
        step_bound_ms=decode_bound_ms(work, 0, rows=8), row_state_bytes=work["row_state_bytes"],
        decode_steps=run["metrics"]["decode_steps"], tokens=run["metrics"]["tokens"],
        tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
        generate_prefill_ms=gen["prefill_ms"],
        generate_step_ms=gen["decode_ms"] / gen["decode_steps"],
        generate_tokens_per_s=sum(r.max_new_tokens for r in group) / run["generate_wall_s"],
        **info)
    res["eager"] = graphed_against_eager(cfg, eng.params, trace, run, max_seq=RWKV_MAX_SEQ)
    res["logits"] = graph_logits_check(eng, cfg, 64)
    if not res["logits"]["bit_equal"]:
        raise AssertionError(f"rwkv_serving: graphed logits differ from eager: {res['logits']}")
    res["window"] = decode_window(eng, cfg, 64)
    del eng, run
    torch.cuda.empty_cache()
    res["carry"] = rwkv_carry_parity(cfg)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "rwkv_serving", **res})
    return res


def rwkv_carry_parity(cfg) -> dict:
    """rwkv6-7b at full width in fp32 (TF32 off), ``RWKV_CARRY_LAYERS``
    layers: for each prompt length n, a prefill of n + 1 tokens against a
    prefill of n tokens and one decode step from its carries (the state,
    the two token shifts), layer by layer from the same input: the decoded
    token's output must be within ``LAYER_REL`` of the larger prefill's
    largest output at that position.  Lengths that are not multiples of 32
    put a remainder chunk at the end."""
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.models.model import _decoder, _embed_tokens
    from repro_torch.models.transformer import _at, apply_layer_decode, apply_layer_prefill

    c = dataclasses.replace(cfg, num_layers=RWKV_CARRY_LAYERS, param_dtype="float32",
                            compute_dtype="float32")
    params = init_params(model_specs(c), seed=2, device="cuda")
    dec = _decoder(c)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    with torch.inference_mode():
        for n in RWKV_CARRY_LENGTHS:
            tokens = torch.randint(0, c.vocab_size, (1, n + 1), generator=gen, device="cuda")
            positions = torch.arange(n + 1, device="cuda")
            x = _embed_tokens(c, params, tokens)
            rel = []
            for group, key, r, d, lp in dec._layers(params["decoder"]):
                full, _, _ = apply_layer_prefill(c, d, lp, x, positions, None, 0.0)
                _, cache, _ = apply_layer_prefill(c, d, lp, x[:, :n], positions[:n], None, 0.0)
                step, _ = apply_layer_decode(c, d, lp, x[:, n:], cache, n, 0.0)
                want = full[:, n:]
                rel.append(((step - want).abs().max() / want.abs().max()).item())
                if not torch.isfinite(step).all() or not rel[-1] <= LAYER_REL:
                    raise AssertionError(f"rwkv carry after {n} tokens, layer {len(rel) - 1}: "
                                         f"largest difference {rel[-1]:.3e} of the largest "
                                         "output")
                x = full
            out[n] = rel
    del params
    torch.cuda.empty_cache()
    return dict(layers=RWKV_CARRY_LAYERS, dtype="float32", limit=LAYER_REL, layer_rel_err=out,
                max_layer_rel_err=max(max(v) for v in out.values()))


def paged_layout_phase(name, cfg, pool_pages, contiguous: bool) -> dict:
    """``cfg`` at full size in bf16 with random seeded weights, paged with
    the prefix cache (batch 8, max_seq 4096, page 16, ``pool_pages``),
    graphed: the 16-request trace of ``paged_serving`` (8 sharing a
    1024-token prefix).  Held as there (prefix hits prefill no more than
    their suffix; no page held after drain; none used after flush); then
    an eager paged engine serves the trace with identical tokens, and one
    step's logits through the graph are bit-equal to the eager step's.  With
    ``contiguous`` a contiguous engine (graphed) serves it too: its tokens
    are reported beside the paged ones, and each prefix miss's first token
    must be the same (the same B=1 prefill); then both again where no
    expert drops a token (``layouts_without_drops``).  Reported: prime ms of misses
    and hits against their bounds, step ms against the all-weights bound
    and the active-weights one, tokens/s, ``pool_stats()``,
    ``audit_pages()``, the pairs the expert capacity dropped in one decode
    step and one prefill, the device idle share of 8 decode steps, and the
    peak GB of the phase."""
    from repro_torch.models import count_params, model_specs
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.serving import ServingEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    work = serving_work(cfg)
    trace = paged_trace(cfg.vocab_size, PAGED_PREFIX, PAGED_SUFFIXES, PAGED_UNRELATED,
                        PAGED_NEW, PAGED_LONG_NEW, seed=5)
    kw = dict(max_seq=PAGED_MAX_SEQ, paged=True, page_size=16, pool_pages=pool_pages)
    eng = ServingEngine(cfg, params, batch_size=8, **kw)
    reset_counts()
    run = serve_trace(eng, trace)
    launches = read_counts()
    summary = paged_run_summary(cfg, work, run, trace)
    summary.update(check_paged_run(eng, run, trace, PAGED_PREFIX, name))
    if summary["prefix_hits"] != summary["shared_prefix_requests"] - 1:
        raise AssertionError(f"{name}: {summary['prefix_hits']} prefix hits, expected "
                             f"{summary['shared_prefix_requests'] - 1}")
    kv = summary["mean_cached_tokens_per_step"]
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=count_params(cfg),
               active_params=count_params(cfg, active_only=True), init_s=init_s, batch=8,
               max_seq=PAGED_MAX_SEQ, page_size=16, pool_pages=eng.pool_pages,
               pool_bytes=sum(t.numel() * t.element_size()
                              for path, t in tree_leaves(eng._cb_cache)
                              if tree_get(eng._flags, path)),
               kv_token_bytes=work["kv_token_bytes"], requests=len(trace), launches=launches,
               graphed=summary,
               step_bound_ms_active=decode_bound_ms(work, kv, active=True),
               logits=graph_logits_check(eng, cfg, 64))
    if not res["logits"]["bit_equal"]:
        raise AssertionError(f"{name}: graphed logits differ from eager: {res['logits']}")
    if cfg.moe is not None:
        res["dropped"] = moe_drops(eng, cfg)
    res["window"] = decode_window(eng, cfg, 64)
    res["graphs"] = ["contiguous" if k is None else k for k in eng.graph_capture_ms]
    del eng
    torch.cuda.empty_cache()
    res["eager"] = graphed_against_eager(cfg, params, trace, run, **kw)
    if contiguous:
        other = ServingEngine(cfg, params, batch_size=8, max_seq=PAGED_MAX_SEQ)
        crun = serve_trace(other, trace)
        for (rid, prompt, _, _), a, rp, rc in zip(trace, run["admissions"], run["requests"],
                                                  crun["requests"]):
            if a["tokens"] == len(prompt) and rp.generated[0] != rc.generated[0]:
                raise AssertionError(f"{name}: prefix miss {rid} gave first token "
                                     f"{rp.generated[0]}, the contiguous engine "
                                     f"{rc.generated[0]}")
        res["contiguous"] = dict(
            step_ms=crun["step_ms"], step_ms_median=crun["step_ms_median"],
            tokens_per_s=crun["tokens_per_s"],
            prime_ms=crun["metrics"]["prefill_ms"] / len(trace),
            token_agreement_bf16=token_agreement(run["requests"], crun["requests"]),
            tokens_side_by_side={rid: [rp.generated, rc.generated] for (rid, *_), rp, rc in
                                 zip(trace, run["requests"], crun["requests"])})
        del other, crun
        res["contiguous"]["no_drops"] = layouts_without_drops(cfg, params, trace, kw)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": name, **res})
    del params
    torch.cuda.empty_cache()
    return res


def layouts_without_drops(cfg, params, trace, paged_kw) -> dict:
    """The paged and the contiguous engine (graphed) on ``trace`` again, at
    a ``capacity_factor`` of E / k, where every expert's capacity holds
    every token of a call, so no (token, expert) pair drops (held, by
    ``moe_drops``) and each token's output depends on it alone.  Each
    prefix miss's first token must be the same in both (the same B=1
    prefill).  Where a request's tokens part, ``divergence`` reads the two
    candidates off the full forward (the decompressed train path, no drops
    either): their gaps to its top logit and their ranks, which must be
    below ``LAYOUT_RANK`` (a wrong page or position picks a token from
    anywhere in the vocabulary).  Reported: the capacity factor, the drops,
    the share of tokens that agree, the requests that agree whole, and
    each parting."""
    from repro_torch.serving import ServingEngine

    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    runs = {}
    for layout, kw in (("paged", paged_kw), ("contiguous", dict(max_seq=PAGED_MAX_SEQ))):
        eng = ServingEngine(cfg, params, batch_size=8, **kw)
        runs[layout] = serve_trace(eng, trace)
        if layout == "paged":
            dropped = moe_drops(eng, cfg)
        del eng
        torch.cuda.empty_cache()
    if any(d["dropped"] for d in dropped.values()):
        raise AssertionError(f"capacity factor {cfg.moe.capacity_factor}: pairs dropped: "
                             f"{dropped}")
    partings = []
    for (rid, prompt, _, _), a, rp, rc in zip(trace, runs["paged"]["admissions"],
                                              runs["paged"]["requests"],
                                              runs["contiguous"]["requests"]):
        if rp.generated == rc.generated:
            continue
        d = dict(id=rid, prefix_hit=a["tokens"] < len(prompt),
                 **divergence(cfg, params, prompt, rp, rc))
        d["gaps_to_top"] = [d["full_forward_top3"][0][1] - x for x in d["full_forward_logits"]]
        partings.append(d)
        if (d["at"] == 0 and not d["prefix_hit"]) or max(d["full_forward_ranks"]) >= LAYOUT_RANK:
            raise AssertionError(f"no drops: {rid}'s paged and contiguous tokens part at no "
                                 f"near-tie: {d}")
    return dict(capacity_factor=cfg.moe.capacity_factor, dropped=dropped,
                token_agreement_bf16=token_agreement(runs["paged"]["requests"],
                                                     runs["contiguous"]["requests"]),
                requests_identical=len(trace) - len(partings), partings=partings,
                max_gap_to_top=max((max(d["gaps_to_top"]) for d in partings), default=0.0),
                max_rank=max((max(d["full_forward_ranks"]) for d in partings), default=0))


def moe_train_phase(k1) -> dict:
    """moonshot-v1-16b-a3b at full width cut to ``MOE_TRAIN_LAYERS`` of 48
    (the dense first layer and one MoE layer), bf16 params, fp32 moments,
    ``use_pallas=True``, the config's ``remat_policy`` (``"full"``):
    ``MOE_TRAIN_STEPS`` steps of 8 x 4096 tokens in 4 microbatches.  K1
    must launch once per attention layer and microbatch, and again for the
    MoE block's recompute (the dense first layer sits outside the repeated
    cycle, which alone is rematerialised, as in the reference); the MoE aux
    loss must be finite and positive in every step; every layer's experts
    and router must receive a gradient.  The 6·N_active·D/peak floor is
    reported beside the step."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=MOE_TRAIN_LAYERS,
                              use_pallas=True)
    assert cfg.remat_policy == "full" and cfg.microbatches == 4
    res = train_phase(cfg, k1, k1_launches_per_microbatch(cfg) * cfg.microbatches
                      * MOE_TRAIN_STEPS,
                      lambda path: path.rsplit("/", 1)[-1] in ("router", "w_gate", "w_down"),
                      steps=MOE_TRAIN_STEPS, name="moe_train", profile=False)
    aux = [r["moe_aux"] for r in res["steps"]]
    if not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"moe_train: moe_aux {aux}")
    active = count_params(cfg, active_only=True)
    floor_ms = 6 * active * TRAIN_BATCH * TRAIN_SEQ / PEAK_BF16_FLOPS * 1e3
    res.update(active_params=active, floor_ms=floor_ms, moe_aux=aux,
               k1_per_step=res["launches"]["flash_attention"] // MOE_TRAIN_STEPS)
    emit({"phase": "moe_train summary", **{k: res[k] for k in (
        "active_params", "floor_ms", "moe_aux", "k1_per_step", "peak_mem_gb")},
          "step_ms": [r["step_ms"] for r in res["steps"]],
          "tokens_per_s": [r["tokens_per_s"] for r in res["steps"]]})
    return res


#: vision_serving / vision_parity / vision_train: llama-3.2-vision-90b at full
#: width cut to one whole cycle of its 100 layers (4 attn + 1 cross_only)
VISION_LAYERS = 5
VISION_LENGTHS = (64, 128, 192, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 1664, 1792,
                  1920, 2048)
VISION_MAX_SEQ = 4096
VISION_PARITY_PROMPT, VISION_PARITY_STEPS = 300, 24
#: a step is 8 microbatches (the config's) of 1 x VISION_TRAIN_SEQ tokens;
#: at 4096 K1's plain backward (fp32 scores, 4.3 GB a call at 64 heads) does
#: not fit beside the 65 GB of state and accumulators, so the step's tokens
#: are cut (never the widths or the 5-layer cycle)
VISION_TRAIN_STEPS, VISION_TRAIN_ROWS, VISION_TRAIN_SEQ = 2, 8, 2048
#: the cross layers' gate in the parity and train phases: tanh(0) = 0 at
#: init would make a cross layer add nothing
VISION_XGATE = 0.5
#: distributed: internlm2-20b at full width, this many layers, steps of
#: DIST_BATCH x DIST_SEQ tokens
DIST_LAYERS, DIST_STEPS, DIST_BATCH, DIST_SEQ = 2, 2, 4, 1024
DIST_LOSS_TOL = 5e-3                           # tests/test_use_pallas.py's loss tolerance
DIST_GRAD_NORM_TOL = 1e-3                      # train_parity's, on the first step's grads


def vision_cfg(**kw):
    """llama-3.2-vision-90b cut to ``VISION_LAYERS`` (one whole cycle)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_layer_defs

    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"), num_layers=VISION_LAYERS, **kw)
    assert [d.mixer for d in build_layer_defs(cfg)] == ["attn"] * 4 + ["cross_only"]
    return cfg


def feed_image(eng, image):
    """``eng`` with ``image`` (1, image tokens, d_model) as every admission's
    image embeddings in place of the frontend stub's zeros."""
    eng._batch_extras = lambda B: {"image_embeds": image.expand(B, -1, -1).contiguous()}
    return eng


def vision_serving_phase() -> dict:
    """llama-3.2-vision-90b at full width cut to 5 of 100 layers (one cycle:
    4 ``attn`` + 1 ``cross_only``; 6.50 B parameters) in bf16 with random
    seeded weights, ``xgate = 0.5`` and one seeded image in every admission
    of every engine (under the frontend stub's zero embeddings, or the
    initial ``xgate = 0``, a cross layer adds nothing):
    ``ServingEngine(batch_size=8, max_seq=4096)``, graphed, 16 requests of
    64-2048 tokens.  K1 must launch in no prefill (the serving
    path reaches none, as in the reference).  An eager engine serves the
    same requests with identical tokens; one step's logits through the
    graph are bit-equal to the eager step's; then the paged engine (attn
    K/V in the pool, the image K/V resident, no prefix cache) serves them,
    and each request's first token must be the contiguous engine's (the
    same B=1 prefill).  Reported: prime ms against each admission's bound,
    step ms against one read of the weights, the rows' image K/V and the
    live K/V, tokens/s, the device idle share of 8 decode steps, peak GB."""
    from repro_torch.models import count_params, model_specs
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServingEngine

    cfg = vision_cfg(use_pallas=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), seed=0, device="cuda")
    params["decoder"]["blocks"]["4"]["xgate"].fill_(VISION_XGATE)
    image = torch.randn((1, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                        device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    work = serving_work(cfg)
    budgets = np.random.default_rng(0).permutation(
        np.linspace(8, 64, len(VISION_LENGTHS)).astype(int))
    trace = new_trace(cfg, VISION_LENGTHS, budgets, seed=7)
    eng = feed_image(ServingEngine(cfg, params, batch_size=8, max_seq=VISION_MAX_SEQ), image)
    reset_counts()
    run = serve_trace(eng, trace)
    launches = read_counts()
    if launches["flash_attention"]:
        raise AssertionError(f"vision_serving: K1 launched {launches['flash_attention']} times")
    prime = [dict(prompt=len(p), ms=a["ms"], **prefill_bound(cfg, work, len(p), 0))
             for (_, p, _, _), a in zip(trace, run["admissions"])]
    kv = run["step_kv_tokens"] / run["metrics"]["decode_steps"]
    rows = run["step_rows"] / run["metrics"]["decode_steps"]
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=count_params(cfg), init_s=init_s,
               batch=8, max_seq=VISION_MAX_SEQ, requests=len(trace), launches=launches,
               prime=prime, prime_ms=run["metrics"]["prefill_ms"] / len(trace),
               prime_bound_ms_mean=sum(p["bound_ms"] for p in prime) / len(prime),
               step_ms=run["step_ms"], step_ms_median=run["step_ms_median"],
               step_bound_ms=decode_bound_ms(work, kv, rows),
               step_bound_ms_full_batch_no_kv=decode_bound_ms(work, 0, 8),
               mean_cached_tokens_per_step=kv, mean_rows_per_step=rows,
               kv_token_bytes=work["kv_token_bytes"], row_cross_bytes=work["row_cross_bytes"],
               decode_steps=run["metrics"]["decode_steps"], tokens=run["metrics"]["tokens"],
               tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"])
    res["logits"] = graph_logits_check(eng, cfg, 64, resident=("blocks", "4", "ck"))
    if not res["logits"]["resident_abs_max"] > 0:
        raise AssertionError(f"vision_serving: the live rows' image K/V are zero: "
                             f"{res['logits']}")
    if not res["logits"]["bit_equal"]:
        raise AssertionError(f"vision_serving: graphed logits differ from eager: {res['logits']}")
    res["window"] = decode_window(eng, cfg, 64)
    del eng
    torch.cuda.empty_cache()
    res["eager"] = graphed_against_eager(cfg, params, trace, run, image=image,
                                         max_seq=VISION_MAX_SEQ)
    paged = feed_image(ServingEngine(cfg, params, batch_size=8, max_seq=VISION_MAX_SEQ,
                                     paged=True, page_size=16), image)
    prun = serve_trace(paged, trace)
    for (rid, prompt, _, _), rp, rc in zip(trace, prun["requests"], run["requests"]):
        if rp.generated[0] != rc.generated[0]:
            raise AssertionError(f"vision_serving: {rid} ({len(prompt)} tokens) paged first "
                                 f"token {rp.generated[0]}, contiguous {rc.generated[0]}")
    res["paged"] = paged_run_summary(cfg, work, prun, trace)
    res["paged"].update(check_paged_run(paged, prun, trace, 0, "vision_serving"),
                        token_agreement_bf16=token_agreement(prun["requests"], run["requests"]))
    if res["paged"]["prefix_hits"]:
        raise AssertionError("vision_serving: a prefix hit without a prefix cache")
    del paged, prun
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "vision_serving", **res})
    del params
    torch.cuda.empty_cache()
    return res


def vision_parity_phase() -> dict:
    """llama-3.2-vision-90b at full width, 5 layers, fp32 (TF32 off), with
    ``xgate = 0.5`` and image embeddings drawn from a seeded normal: a
    prefill of ``VISION_PARITY_PROMPT`` tokens and then
    ``VISION_PARITY_STEPS`` decode steps, layer by layer from the same
    input, against the full forward of the whole sequence: every step's
    output within ``LAYER_REL`` of the largest output at its position.  The
    image K/V the prefill leaves in the cache (layer by layer and through
    the model's prefill step) must equal ``cross_kv`` of the image
    embeddings bit for bit."""
    from repro_torch.models import build_prefill_step, model_specs
    from repro_torch.models import attention as attn
    from repro_torch.models.common import init_params
    from repro_torch.models.model import _decoder, _embed_tokens
    from repro_torch.models.transformer import (apply_layer_decode, apply_layer_prefill,
                                                layer_cache)
    from repro_torch.serving.cache_utils import extend_cache

    cfg = vision_cfg(param_dtype="float32", compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_specs(cfg), seed=1, device="cuda")
    params["decoder"]["blocks"]["4"]["xgate"].fill_(VISION_XGATE)
    n, steps = VISION_PARITY_PROMPT, VISION_PARITY_STEPS
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, n + steps), generator=gen, device="cuda")
    image = torch.randn((1, cfg.num_image_tokens, cfg.d_model), generator=gen, device="cuda")
    positions = torch.arange(n + steps, device="cuda")
    dec = _decoder(cfg)
    rel, cross_equal = [], []
    with torch.inference_mode():
        x = _embed_tokens(cfg, params, tokens)
        for group, key, r, d, lp in dec._layers(params["decoder"]):
            full, _, _ = apply_layer_prefill(cfg, d, lp, x, positions, image, 0.0)
            _, cache, _ = apply_layer_prefill(cfg, d, lp, x[:, :n], positions[:n], image, 0.0)
            if d.mixer == "cross_only":
                ckv = attn.cross_kv(lp["mixer"], image)
                cross_equal.append(torch.equal(cache["ck"], ckv["k"])
                                   and torch.equal(cache["cv"], ckv["v"]))
            cache = extend_cache(layer_cache(cfg, d, 1, n + steps, "cuda"), cache, n)
            errs = []
            for t in range(n, n + steps):
                out, _ = apply_layer_decode(cfg, d, lp, x[:, t:t + 1], cache, t, 0.0)
                want = full[:, t:t + 1]
                errs.append(((out - want).abs().max() / want.abs().max()).item())
            rel.append(errs)
            if not all(e <= LAYER_REL for e in errs):
                raise AssertionError(f"vision_parity: layer {len(rel) - 1} ({d.mixer}) decode "
                                     f"differs from the full forward by {max(errs):.3e} of "
                                     "the largest output")
            x = full
        pcache, _ = build_prefill_step(cfg)(params, {"tokens": tokens[:, :n],
                                                     "image_embeds": image})
        ckv = attn.cross_kv({k: v[0] for k, v in params["decoder"]["blocks"]["4"]["mixer"]
                             .items()}, image)
        cross_equal.append(torch.equal(pcache["blocks"]["4"]["ck"][0], ckv["k"])
                           and torch.equal(pcache["blocks"]["4"]["cv"][0], ckv["v"]))
    if not all(cross_equal):
        raise AssertionError(f"vision_parity: the cached image K/V are not cross_kv's: "
                             f"{cross_equal}")
    res = dict(arch=cfg.name, layers=cfg.num_layers, dtype="float32", tf32=False,
               xgate=VISION_XGATE, prompt=n, steps=steps, limit=LAYER_REL,
               layer_rel_err=[max(e) for e in rel], max_layer_rel_err=max(max(e) for e in rel),
               image_kv_equal=cross_equal, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "vision_parity", **res})
    del params, pcache
    torch.cuda.empty_cache()
    return res


def k1_launches_per_microbatch(cfg) -> int:
    """K1 launches of one microbatch's forward and backward, read off the
    stack's structure: each ``attn`` layer's self-attention once, and once
    more for the recompute of the repeated cycle's blocks under a remat
    policy other than ``"nothing"`` (prefix and suffix layers are not
    rematerialised, as in the reference)."""
    from repro_torch.models.transformer import Stack

    stack = Stack(cfg)
    attn = lambda defs: sum(d.mixer == "attn" for d in defs)
    again = 2 if cfg.remat_policy != "nothing" else 1
    return attn(stack.prefix) + attn(stack.suffix) + again * stack.reps * attn(stack.cycle)


def vision_train_phase(k1) -> dict:
    """llama-3.2-vision-90b at full width, 5 layers, bf16 params and the
    config's bf16 moments, its ``"full"`` remat and 8 microbatches,
    ``use_pallas=True``, ``xgate = 0.5``: ``VISION_TRAIN_STEPS`` steps of
    8 x 1 x ``VISION_TRAIN_SEQ`` tokens, each batch built here with seeded
    image embeddings (the launcher's synthetic data has none, as the
    reference's).  K1 must launch as often as the stack's structure says
    (``k1_launches_per_microbatch``, counted before the run); loss and grad
    norm finite; the cross layer's gate and projections must receive a
    gradient.  Step ms, tokens/s against the 6·N·D/peak floor, peak GB."""
    from repro_torch.models import count_params
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.training.data import SyntheticTokenDataset

    cfg = vision_cfg(use_pallas=True)
    assert (cfg.remat_policy, cfg.microbatches, cfg.moment_dtype) == ("full", 8, "bfloat16")
    expected = k1_launches_per_microbatch(cfg) * cfg.microbatches * VISION_TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, device="cuda")
    state.params["decoder"]["blocks"]["4"]["xgate"].fill_(VISION_XGATE)
    step = build_train_step(cfg)
    data = SyntheticTokenDataset(cfg.vocab_size, VISION_TRAIN_SEQ, VISION_TRAIN_ROWS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    records = []
    reset_counts()
    for i in range(VISION_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda", torch.long)
                 for k, v in data.batch_at(i).items()}
        batch["image_embeds"] = torch.randn(
            (VISION_TRAIN_ROWS, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device="cuda").to(cfg.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        vals = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        records.append(dict(step=i, loss=vals["loss"], grad_norm=vals["grad_norm"],
                            step_ms=ms, tokens_per_s=VISION_TRAIN_ROWS * VISION_TRAIN_SEQ
                            / (ms / 1e3)))
        if not (math.isfinite(vals["loss"]) and math.isfinite(vals["grad_norm"])):
            raise AssertionError(f"vision_train step {i}: {vals}")
    launches = read_counts()
    if launches["flash_attention"] != expected:
        raise AssertionError(f"vision_train: K1 launched {launches['flash_attention']} times, "
                             f"expected {expected} from the stack")
    nu = state.opt.nu["decoder"]["blocks"]["4"]
    no_grad = [k for k, t in (("xgate", nu["xgate"]), *nu["mixer"].items()) if not t.any()]
    if no_grad:
        raise AssertionError(f"vision_train: cross layer leaves without a gradient: {no_grad}")
    n = count_params(cfg)
    floor_ms = 6 * n * VISION_TRAIN_ROWS * VISION_TRAIN_SEQ / PEAK_BF16_FLOPS * 1e3
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=n, rows=VISION_TRAIN_ROWS,
               seq=VISION_TRAIN_SEQ, microbatches=cfg.microbatches,
               remat_policy=cfg.remat_policy, moment_dtype=cfg.moment_dtype,
               xgate=VISION_XGATE, launches=launches, k1_expected=expected,
               k1_per_step=launches["flash_attention"] // VISION_TRAIN_STEPS,
               steps=records, floor_ms=floor_ms,
               state_gb=sum(t.numel() * t.element_size() for tree in (
                   state.params, state.opt.mu, state.opt.nu) for _, t in tree_leaves(tree)) / 1e9,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "vision_train", **res})
    del state
    torch.cuda.empty_cache()
    return res


def distributed_phase() -> dict:
    """internlm2-20b at full width, ``DIST_LAYERS`` layers,
    ``use_pallas=True``: ``DIST_STEPS`` steps of ``DIST_BATCH`` x
    ``DIST_SEQ`` tokens through the launcher's loop, once on a 1×1 mesh
    (``make_smoke_mesh``: an NCCL process group of one) under
    ``sharding_ctx(mesh, RECIPES["baseline"])`` with the state placed by
    ``param_shardings``, and once with no context; in bf16, then in fp32
    (TF32 off).  Under the context ``sp_gqa_block`` takes each layer (its
    axes have size 1, which it does not decline, as the reference's does
    not) and calls the plain attention without ``cfg``, so K1 runs only
    without the context; a third bf16 run with no context and no kernel
    (``use_pallas=False``) takes the same attention as the context's.  The
    losses of each pair must agree within ``DIST_LOSS_TOL``, and the first
    step's grad norms (the same parameters) within ``DIST_GRAD_NORM_TOL``
    where the attention path is the same: the fp32 pair and the context
    against the bf16 run without the kernel (bf16's K1 run is reported:
    its backward recomputes in fp32, the plain path's in bf16).  Later
    steps are reported: AdamW's first update moves an element by about lr
    whatever the sign of a grad near zero, so rounding parts the
    parameters.  This is all one card shows of the distributed layer;
    several cards are not measured."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import RECIPES
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import train_loop

    base = dataclasses.replace(get_config("internlm2-20b"), num_layers=DIST_LAYERS,
                               use_pallas=True)
    mesh = make_smoke_mesh(device="cuda")
    runs = {}
    try:
        context = dict(mesh=mesh, recipe=RECIPES["baseline"])
        for dtype, name, kw, kernel in (("bfloat16", "context", context, True),
                                        ("bfloat16", "plain", {}, True),
                                        ("bfloat16", "plain without K1", {}, False),
                                        ("float32", "context", context, True),
                                        ("float32", "plain", {}, True)):
            cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype,
                                      use_pallas=kernel)
            name = f"{dtype} {name}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            state, records = train_loop(cfg, steps=DIST_STEPS, batch_size=DIST_BATCH,
                                        seq=DIST_SEQ, device="cuda", log=lambda s: None, **kw)
            runs[name] = dict(launches=read_counts()["flash_attention"],
                              loss=[r["loss"] for r in records],
                              grad_norm=[r["grad_norm"] for r in records],
                              step_ms=[r["step_ms"] for r in records],
                              tokens_per_s=[r["tokens_per_s"] for r in records],
                              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            del state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    per_run = k1_launches_per_microbatch(base) * base.microbatches * DIST_STEPS
    expected = {name: per_run if name.endswith(" plain") else 0 for name in runs}
    pairs = {"bfloat16": ("bfloat16 context", "bfloat16 plain"),
             "bfloat16 without K1": ("bfloat16 context", "bfloat16 plain without K1"),
             "float32": ("float32 context", "float32 plain")}
    diff, gn_rel = {}, {}
    for key, (a, b) in pairs.items():
        diff[key] = max(abs(x - y) for x, y in zip(runs[a]["loss"], runs[b]["loss"]))
        gn_rel[key] = [abs(x / y - 1) for x, y in zip(runs[a]["grad_norm"], runs[b]["grad_norm"])]
    res = dict(arch=base.name, layers=base.num_layers, batch=DIST_BATCH, seq=DIST_SEQ,
               steps=DIST_STEPS, mesh={"data": 1, "model": 1}, backend="nccl",
               recipe="baseline", runs=runs, k1_expected=expected, max_loss_diff=diff,
               loss_tol=DIST_LOSS_TOL, grad_norm_rel_diff=gn_rel,
               grad_norm_tol_first_step=DIST_GRAD_NORM_TOL)
    emit({"phase": "distributed", **res})
    held = ("bfloat16 without K1", "float32")
    if (max(diff.values()) > DIST_LOSS_TOL
            or max(gn_rel[k][0] for k in held) > DIST_GRAD_NORM_TOL
            or not all(math.isfinite(x) for r in runs.values() for x in r["loss"])):
        raise AssertionError(f"distributed: losses or grad norms part: {runs}")
    for name, n in expected.items():
        if runs[name]["launches"] != n:
            raise AssertionError(f"distributed: K1 launched {runs[name]['launches']} times "
                                 f"{name}, expected {n}")
    return res


def encoder_breakdown(cfg, params) -> dict:
    """Time one B=1 encoder pass (the admission's bulk) with and without K1."""
    from repro_torch.models.model import _encode

    frames = torch.zeros((1, cfg.encoder_frames, cfg.d_model), dtype=cfg.dtype, device="cuda")
    out = {}
    with torch.inference_mode():
        for name, use in (("encoder_ms_kernel", True), ("encoder_ms_plain", False)):
            c = dataclasses.replace(cfg, use_pallas=use)
            out[name] = cuda_ms(lambda: _encode(c, params, frames, cfg.dtype), iters=5, warmup=1)
    return out


def parity_phase(fa, cfg) -> dict:
    """Full-width fp32 encoder: kernel path against the plain path.

    The randomly initialized 32-layer stack is chaotic: the plain path alone
    turns a 1e-6 relative change of its input into an O(1) change of its
    output (``sensitivity`` below), so a free-running comparison measures
    the weights, not the kernel.  The check is therefore teacher-forced: at
    every layer the same input (the plain path's) goes through the layer
    with and without the kernel, and the largest difference over all layers
    must be <= 1e-3.  The free-running difference is reported beside the
    sensitivity.
    """
    from repro_torch.models import common as cm
    from repro_torch.models.model import _encode, _encoder, _sinusoid
    from repro_torch.models.transformer import _at, apply_layer_train

    plain_cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                    use_pallas=False)
    kern_cfg = dataclasses.replace(plain_cfg, use_pallas=True)
    enc = _encoder(plain_cfg)
    specs = {"encoder": enc.specs(), "enc_norm": cm.norm_spec(plain_cfg, cfg.d_model)}
    params = cm.init_params(specs, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn((1, cfg.encoder_frames, cfg.d_model), generator=gen, device="cuda")
    pos = torch.arange(cfg.encoder_frames, device="cuda")
    (ld,) = enc.cycle
    layer_err = []
    with torch.inference_mode():
        before = fa.flash_attention.launches
        x = frames + _sinusoid(pos, cfg.d_model)
        for r in range(enc.reps):
            lp = _at(params["encoder"]["blocks"]["0"], r)
            plain, _ = apply_layer_train(plain_cfg, ld, lp, x, pos, None, 0.0, True)
            kern, _ = apply_layer_train(kern_cfg, ld, lp, x, pos, None, 0.0, True)
            assert torch.isfinite(kern).all(), f"layer {r}: non-finite kernel output"
            layer_err.append((plain - kern).abs().max().item())
            x = plain
        launched = fa.flash_attention.launches - before
        ref = _encode(plain_cfg, params, frames, torch.float32)
        free = (_encode(kern_cfg, params, frames, torch.float32) - ref).abs().max().item()
        sens = (_encode(plain_cfg, params, frames * (1 + 1e-6), torch.float32)
                - ref).abs().max().item()
    torch.cuda.synchronize()
    err = max(layer_err)
    assert launched == cfg.encoder_layers, launched
    assert err <= 1e-3, f"fp32 encoder: kernel layer differs from plain by {err:.3e}"
    res = dict(max_abs_err=err, layer_err=layer_err, launches=launched,
               free_running_err=free, sensitivity_1e6=sens,
               residual_abs_max=x.abs().max().item())
    emit({"phase": "parity", **res})
    return res


def train_phase(cfg, kernel, expected: int, needs_grad, steps: int = TRAIN_STEPS,
                name: str = "train", profile: bool = True) -> dict:
    """``cfg`` at full width through the port's launcher loop: ``steps`` steps
    of 8 x 4096 tokens in ``cfg.microbatches`` microbatches.  ``kernel`` (the
    wrapper with the path's launch count) must launch ``expected`` times, and
    every stacked parameter whose path ``needs_grad`` accepts must have
    received a gradient in every layer.  ``profile`` adds one profiled step
    of a single microbatch."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models import count_params
    from repro_torch.models.common import tree_leaves

    assert cfg.param_dtype == "bfloat16" and cfg.moment_dtype == "float32"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, records = train_loop(cfg, steps=steps, batch_size=TRAIN_BATCH,
                                seq=TRAIN_SEQ, device="cuda", log=lambda s: None)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"train step {r['step']}: loss {r['loss']}, "
                                 f"grad norm {r['grad_norm']}")
    if len(records) != steps or launches[kernel.__name__] != expected:
        raise AssertionError(f"{kernel.__name__} launched {launches[kernel.__name__]} times in "
                             f"{len(records)} steps, expected {expected}")
    # a parameter whose grad was ever non-zero has a non-zero second moment;
    # stacked leaves carry one layer per row
    checked = [(path, nu.flatten(1).abs().sum(1)) for path, nu in tree_leaves(state.opt.nu)
               if "/blocks/" in path and needs_grad(path)]
    if not checked:
        raise AssertionError("no parameter was checked for a gradient")
    no_grad = [f"{path}[{i}]" for path, per_layer in checked
               for i in (per_layer > 0).logical_not().nonzero().flatten().tolist()]
    if no_grad:
        raise AssertionError(f"parameters without a gradient: {no_grad}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=count_params(cfg),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=cfg.microbatches,
               remat_policy=cfg.remat_policy, launches=launches, grads_checked=len(checked),
               wall_s=wall_s, steps=records, peak_mem_gb=peak_gb,
               **memory_breakdown(cfg, state))
    emit({"phase": f"{name} {cfg.name}", **res})
    if profile:
        emit({"phase": f"train_profile {cfg.name}", **profile_train_step(cfg, state)})
    del state
    torch.cuda.empty_cache()
    return res


def memory_breakdown(cfg, state) -> dict:
    """What the train state holds (params and moments), the step's fp32 grad
    accumulators, and the peak of one microbatch's forward and backward
    alone on that state (no accumulators, no update): the step's peak less
    these three is what the AdamW update adds."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.data import SyntheticTokenDataset
    from repro_torch.training.train_step import _grad_fn

    state_gb = sum(t.numel() * t.element_size() for tree in (state.params, state.opt.mu,
                                                             state.opt.nu)
                   for _, t in tree_leaves(tree)) / 1e9
    rows = TRAIN_BATCH // cfg.microbatches
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in
             SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, rows).batch_at(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, grads = _grad_fn(cfg, state.params, batch)
    del grads
    torch.cuda.synchronize()
    return dict(state_gb=state_gb,
                grad_accum_gb=sum(t.numel() for _, t in tree_leaves(state.params)) * 4 / 1e9,
                peak_fwd_bwd_gb=torch.cuda.max_memory_allocated() / 1e9)


def profile_train_step(cfg, state) -> dict:
    """Device busy and idle share over one more train step of a single
    microbatch (2 x 4096 tokens: a quarter of the step's events, which the
    profiler records one by one), and the device time by kernel."""
    from repro_torch.training import build_train_step
    from repro_torch.training.data import SyntheticTokenDataset

    rows = TRAIN_BATCH // cfg.microbatches
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in
             SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, rows).batch_at(0).items()}
    step = build_train_step(dataclasses.replace(cfg, microbatches=1))
    torch.cuda.synchronize()
    return dict(rows=rows, seq=TRAIN_SEQ, **device_profile(lambda: step(state, batch)))


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall ms, device busy ms,
    idle share and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own row repeats its kernels' time
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms == 0:                     # the profiler saw no device activity
        return {"profile": "not measured"}
    # what the host asked of the driver: kernel launches, and graph launches
    # (each runs a whole captured step's kernels)
    host_calls = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS}
    return {"profile_wall_ms": wall_ms, "profile_device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_launches": sum(n for _, _, n in rows), "host_launch_calls": host_calls,
            "top_device_ms": [[k[:80], ms, n] for k, ms, n in rows[:10]]}


#: runtime and driver calls that start work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def train_parity_phase(arch: str, layers: int, kernel, expected: int) -> dict:
    """``arch`` at full width in fp32 at ``layers`` layers, B=1, S=1024:
    ``loss_fn`` and its grads through the kernel (``expected`` launches)
    against the plain path, from the same params and batch.  Beside it, the
    plain path's own change when every parameter moves by 1e-7 relative
    (``sensitivity_1e7``): how far fp32 rounding alone moves the grad norm."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.training.data import SyntheticTokenDataset
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import _grad_fn

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, param_dtype="float32",
                              compute_dtype="float32", use_pallas=False, remat_policy="nothing")
    params = init_params(model_specs(cfg), seed=1, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in
             SyntheticTokenDataset(cfg.vocab_size, 1024, 1).batch_at(0).items()}
    out, grads = {}, {}
    for name, use in (("kernel", True), ("plain", False)):
        before = kernel.launches
        (loss, _), grads[name] = _grad_fn(dataclasses.replace(cfg, use_pallas=use), params, batch)
        out[name] = (loss.item(), global_norm(grads[name]).item(), kernel.launches - before)
    leaf_diff = max(((grads["kernel"][k] - g).abs().max() / g.abs().max()).item()
                    for k, g in grads["plain"].items())
    del grads
    gen = torch.Generator(device="cuda").manual_seed(4)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen,
                                                              device="cuda")), params)
    (loss_n, _), grads_n = _grad_fn(cfg, nudged, batch)
    sens = dict(loss=abs(loss_n.item() - out["plain"][0]),
                grad_norm=abs(global_norm(grads_n).item() - out["plain"][1]) / out["plain"][1])
    del nudged, grads_n
    dloss = abs(out["kernel"][0] - out["plain"][0])
    dnorm = abs(out["kernel"][1] - out["plain"][1]) / out["plain"][1]
    if out["kernel"][2] != expected or out["plain"][2] != 0:
        raise AssertionError(f"train-parity {arch}: {kernel.__name__} launches "
                             f"{out['kernel'][2]} / {out['plain'][2]}, expected {expected} / 0")
    if not (dloss <= 5e-3 and dnorm <= 1e-3):
        raise AssertionError(f"train-parity {arch}: |dloss| {dloss:.3e} (limit 5e-3), relative "
                             f"grad-norm difference {dnorm:.3e} (limit 1e-3)")
    res = dict(arch=arch, layers=layers, seq=1024, launches=expected,
               loss_kernel=out["kernel"][0], loss_plain=out["plain"][0], abs_loss_diff=dloss,
               grad_norm_kernel=out["kernel"][1], grad_norm_plain=out["plain"][1],
               rel_grad_norm_diff=dnorm, max_rel_leaf_grad_diff=leaf_diff,
               sensitivity_1e7=sens)
    emit({"phase": f"train_parity {arch}", **res})
    del params
    torch.cuda.empty_cache()
    return res


#: train_substrate: rwkv6-7b at full width, cut to 2 of 32 layers
SUBSTRATE_LAYERS, SUBSTRATE_BATCH, SUBSTRATE_SEQ, SUBSTRATE_QUANTUM = 2, 8, 1024, 2
#: the straggler's stall, in median steps: past STRAGGLER_FACTOR (2) with room
STRAGGLER_STALL = 2.5


def train_substrate_phase(k3) -> dict:
    """The port's ``GpuNodeSubstrate`` driven as a control plane drives it
    (duck-typed sessions; no plane on the card): rwkv6-7b at full width cut
    to ``SUBSTRATE_LAYERS`` layers, bf16 params, fp32 moments,
    ``use_pallas=True``, ``remat_policy`` at its default (``"full"``), batch 8
    x 1024 tokens in 4 microbatches.  ``prepare`` (the warm-up step), three
    quanta of ``SUBSTRATE_QUANTUM`` steps (only the first saves a
    checkpoint), the twin's predicted step beside the measured one and the
    6·N·D/peak floor, a straggler that must read DEGRADED in the quantum's
    telemetry and in ``snapshot()``, ``reset("restore_checkpoint")`` back to
    the saved step with the slowdown cleared, the substrate dropped (memory
    back within 64 MiB with no cycle collection), and a second substrate on
    the same directory resuming from the saved step.  K3 must launch twice
    per layer and microbatch in every step (the forward and its recompute),
    the warm-up's included."""
    import shutil
    import types

    from repro_torch.configs import get_config
    from repro_torch.models import count_params
    from repro_torch.roofline.analysis import HW, model_flops
    from repro_torch.substrates import GpuNodeSubstrate

    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=SUBSTRATE_LAYERS,
                              use_pallas=True)
    assert cfg.remat_policy == "full" and cfg.moment_dtype == "float32"
    ckpt_dir = ROOT / "build" / "train_substrate_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    per_step = SUBSTRATE_LAYERS * cfg.microbatches * 2

    def session(steps, **payload):
        return types.SimpleNamespace(task=types.SimpleNamespace(
            task_id="train", payload=dict(steps=steps, **payload)))

    def new_substrate(recipe):
        return GpuNodeSubstrate(cfg.name, cfg=cfg, device="cuda", recipe=recipe,
                                steps_per_invoke=SUBSTRATE_QUANTUM, batch=SUBSTRATE_BATCH,
                                seq=SUBSTRATE_SEQ, ckpt_dir=str(ckpt_dir))

    def launched(fn, steps, what):
        before = k3.launches
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        if k3.launches - before != per_step * steps:
            raise AssertionError(f"train_substrate {what}: K3 launched {k3.launches - before} "
                                 f"times in {steps} steps, expected {per_step * steps}")
        return out, seconds

    def quantum(sub, what, **payload):
        raw, wall_s = launched(lambda: sub.invoke(session(SUBSTRATE_QUANTUM, **payload)),
                               SUBSTRATE_QUANTUM, what)
        tele = raw["telemetry"]
        if not (math.isfinite(tele["loss"]) and math.isfinite(tele["grad_norm"])):
            raise AssertionError(f"train_substrate {what}: {tele}")
        return raw, dict(what=what, step=raw["output"]["step"], wall_s=wall_s,
                         backend_ms=raw["backend_ms"],
                         **{k: tele[k] for k in ("loss", "grad_norm", "step_ms", "tokens_per_s",
                                                 "drift_score", "health_status")})

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sub = new_substrate("baseline")
    _, prepare_s = launched(lambda: sub.prepare(None), 1, "prepare")
    if sub._step != 0:
        raise AssertionError(f"train_substrate: the warm-up counted as step {sub._step}")
    twin = sub.make_twin()
    quanta = []
    for q in range(3):
        if q == 2:
            predicted = twin.surrogate.simulate(session(SUBSTRATE_QUANTUM).task)
        raw, rec = quantum(sub, f"quantum {q}", checkpoint=q == 0)
        if q == 0:
            rec["checkpoint_s"] = rec["wall_s"] - rec["backend_ms"] / 1e3
        twin.surrogate.observe(None, raw)
        quanta.append(rec)
    saved = sub._ckpt.list_steps()
    if saved != [SUBSTRATE_QUANTUM]:
        raise AssertionError(f"train_substrate: checkpoints {saved}")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.glob("ckpt-*.npz"))
    n_params = count_params(cfg)
    floor_ms = model_flops(n_params, SUBSTRATE_BATCH * SUBSTRATE_SEQ) / HW.peak_flops * 1e3
    twin_check = dict(predicted_step_ms=predicted["telemetry"]["step_ms"],
                      measured_step_ms=quanta[2]["step_ms"], floor_6ND_ms=floor_ms,
                      divergence=twin.surrogate.divergence(raw["output"], predicted["output"]))

    median_ms = float(np.median(sub._step_times))
    sub.inject_straggler(STRAGGLER_STALL * median_ms / 1e3)
    _, slow = quantum(sub, "straggler", checkpoint=False)
    snap_slow = sub.snapshot().to_dict()
    if slow["health_status"] != "degraded" or snap_slow["health_status"] != "degraded":
        raise AssertionError(f"train_substrate: a {STRAGGLER_STALL}x stall read "
                             f"{slow['health_status']} / {snap_slow['health_status']}")
    t0 = time.perf_counter()
    sub.reset("restore_checkpoint")
    restore_s = time.perf_counter() - t0
    if sub._step != SUBSTRATE_QUANTUM or sub._injected_slowdown:
        raise AssertionError(f"train_substrate: reset left step {sub._step}, "
                             f"slowdown {sub._injected_slowdown}")
    _, after = quantum(sub, "after reset", checkpoint=False)
    if after["health_status"] != "healthy" or after["step"] != 2 * SUBSTRATE_QUANTUM:
        raise AssertionError(f"train_substrate: after the reset {after}")
    descriptor = sub.descriptor().to_dict()
    warmup_ms = sub._compile_ms
    del sub, twin
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - allocated
    if left > 64 << 20:
        raise AssertionError(f"train_substrate: {left} bytes still allocated after the "
                             f"substrate was dropped")

    sub = new_substrate("tp_only")
    launched(lambda: sub.prepare(None), 1, "second prepare")
    _, resumed = quantum(sub, "resumed", resume=True, checkpoint=False)
    resumed["restore_s"] = resumed["wall_s"] - resumed["backend_ms"] / 1e3
    if resumed["step"] != 2 * SUBSTRATE_QUANTUM:
        raise AssertionError(f"train_substrate: the second substrate resumed to {resumed}")
    if abs(resumed["loss"] - after["loss"]) > 5e-3:
        raise AssertionError(f"train_substrate: resumed loss {resumed['loss']} against "
                             f"{after['loss']} from the same checkpoint")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del sub
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = 2 + 6 * SUBSTRATE_QUANTUM                   # two warm-ups, six quanta
    if k3.launches != per_step * steps:
        raise AssertionError(f"train_substrate: K3 launched {k3.launches} times in {steps} "
                             f"steps")
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params, batch=SUBSTRATE_BATCH,
               seq=SUBSTRATE_SEQ, microbatches=cfg.microbatches, remat_policy=cfg.remat_policy,
               resource_id=descriptor["resource_id"], prepare_s=prepare_s, warmup_ms=warmup_ms,
               quanta=quanta + [slow, after, resumed], checkpoint_bytes=ckpt_bytes,
               checkpoint_save_s=quanta[0]["checkpoint_s"], restore_s=restore_s,
               reset_cost_ms=descriptor["capability"]["lifecycle"]["reset_cost_ms"],
               twin=twin_check, straggler_stall_ms=STRAGGLER_STALL * median_ms,
               median_step_ms=median_ms, snapshot_straggler=snap_slow,
               memory_left_bytes=left, peak_mem_gb=peak_gb, k3_per_step=per_step,
               k3_launches=k3.launches)
    emit({"phase": "train_substrate", **res})
    return res


#: dense_train: qwen2.5-32b at full width, cut to 2 of 64 layers; steps per policy
DENSE_LAYERS, DENSE_STEPS = 2, 2


def dense_train_phase(k1) -> dict:
    """qwen2.5-32b at full width (qkv bias) cut to ``DENSE_LAYERS`` layers,
    bf16 params, fp32 moments, ``use_pallas=True``: ``DENSE_STEPS`` steps of 8
    x 4096 tokens in 4 microbatches under ``remat_policy="nothing"``, then
    under ``"full"``.  K1 must launch once per layer and microbatch, twice
    under ``"full"`` (the backward recomputes each block's forward); every
    layer's q/k/v bias must receive a gradient."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-32b"), num_layers=DENSE_LAYERS,
                              use_pallas=True)
    assert cfg.qkv_bias and cfg.microbatches == 4
    runs = {}
    for policy in ("nothing", "full"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        runs[policy] = train_phase(
            c, k1, k1_launches_per_microbatch(c) * c.microbatches * DENSE_STEPS,
            lambda path: path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"),
            steps=DENSE_STEPS, name=f"dense_train {policy}", profile=False)
    return runs


def profile_window(eng, cfg, prompt_len: int = 16) -> dict:
    """Device busy and idle share over 8 admissions and 8 decode steps."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(1)
    for i in range(eng.batch_size):
        eng.submit(Request(f"p{i}", rng.integers(0, cfg.vocab_size, prompt_len)
                           .astype(np.int32), max_new_tokens=9))
    torch.cuda.synchronize()
    return device_profile(eng.drain)


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its name
    (demangled by ``c++filt`` where the toolkit's host tools have it), then
    its registers, barriers and spills; warnings are kept as they are."""
    names = re.findall(r"Compiling entry function '(\S+)'", log)
    try:
        shown = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        shown = names
    readable = {n: d.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1] or n
                for n, d in zip(names, shown)}
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name = readable.get(m.group(1), m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
        elif "warning" in ln.lower():
            out.append(ln.strip())
    return out


#: kernel wrappers by name, each with its ``launches`` count (filled by main)
KERNELS: dict = {}
#: the card, as nvidia-smi names it with its power limit (filled by main)
CARD = ["not read"]


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for path in getattr(fn, "path_launches", ()):
            fn.path_launches[path] = 0


def read_counts() -> dict:
    """Launches by kernel, and by kernel and path (``name/path``) where the
    wrapper counts its paths."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        counts.update((f"{name}/{path}", n) for path, n in getattr(fn, "path_launches", {}).items())
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import mha, mha_ref
    from repro_torch.kernels.rglru import breakdown as k2_breakdown
    from repro_torch.kernels.rglru import rglru_scan as k2
    from repro_torch.kernels.rglru.ops import linear_recurrence
    from repro_torch.kernels.rglru.ref import rglru_ref, rglru_sequential
    from repro_torch.kernels.rwkv6 import breakdown as k3_breakdown
    from repro_torch.kernels.rwkv6 import rwkv6_scan as k3
    from repro_torch.kernels.rwkv6.ops import time_mix_chunked, time_mix_ref, time_mix_scan
    from repro_torch.kernels.rwkv6.ref import rwkv6_subchunked

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD[0] = card.stdout.strip().splitlines()[0]
    print(CARD[0], flush=True)
    KERNELS.update((fn.__name__, fn) for fn in (fa.flash_attention, k2.rglru_scan, k3.rwkv6_scan))

    t0 = time.perf_counter()
    sources = (fa.SOURCE, k2.SOURCE, k3.SOURCE)
    with ThreadPoolExecutor(len(sources) + 2) as pool:   # one nvcc per source, together
        # the breakdowns' variants of K3 and K2, beside them
        k3_variants = pool.submit(k3_breakdown.build_variants)
        k2_variants = pool.submit(k2_breakdown.build_variants)
        libs = list(pool.map(build, sources))
        k3_variants, k2_variants = k3_variants.result(), k2_variants.result()
    ptxas = {str(lib.relative_to(ROOT)): ptxas_summary(lib.with_suffix(".log").read_text())
             for lib in libs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": ptxas})

    seconds = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        return out

    k1 = timed("kernels", kernel_phase, fa, mha, mha_ref)
    k3_res = timed("rwkv6_kernel", rwkv6_kernel_phase, k3,
                   lambda: k3_breakdown.breakdown(k3_variants), time_mix_scan, time_mix_ref,
                   time_mix_chunked, rwkv6_subchunked)
    k2_res = timed("rglru_kernel", rglru_kernel_phase, k2,
                   lambda: k2_breakdown.breakdown(k2_variants), linear_recurrence, rglru_ref,
                   rglru_sequential)
    cfg = dataclasses.replace(get_config("whisper-large-v3"), use_pallas=True)
    serving, params = timed("serving", serving_phase, cfg)
    graphs = {"whisper-large-v3": timed("decode_graph whisper", decode_graph_phase, cfg, params,
                                        ("contiguous",), 448, (16,))}
    paged_whisper = timed("paged_whisper", paged_whisper_phase, cfg, params)
    rng = np.random.default_rng(12)
    substrate = {"whisper-large-v3": timed(
        "serving_substrate whisper", serving_substrate_phase, cfg, params, max_seq=448,
        paged=False, prompts=[rng.integers(0, cfg.vocab_size, n) for n in range(8, 65, 8)],
        k1_per_admission=cfg.encoder_layers)}
    del params
    timed("parity", parity_phase, fa, cfg)
    rg_cfg = dataclasses.replace(get_config("recurrentgemma-9b"), use_pallas=True)
    rg_serving, params = timed("rg_serving", rg_serving_phase, rg_cfg)
    graphs["recurrentgemma-9b"] = timed("decode_graph recurrentgemma", decode_graph_phase,
                                        rg_cfg, params, ("contiguous",), RG_MAX_SEQ, (64,))
    del params
    torch.cuda.empty_cache()
    timed("rg_decode_parity", rg_decode_parity_phase, k2)
    lm_cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=LM_LAYERS)
    paged_serving, params = timed("paged_serving", paged_serving_phase, lm_cfg)
    graphs["internlm2-20b"] = timed("decode_graph internlm2", decode_graph_phase, lm_cfg, params,
                                    ("paged", "contiguous"), PAGED_MAX_SEQ, (1024,))
    prefix = rng.integers(0, lm_cfg.vocab_size, SUBSTRATE_PREFIX)
    substrate["internlm2-20b"] = timed(
        "serving_substrate internlm2", serving_substrate_phase, lm_cfg, params,
        max_seq=PAGED_MAX_SEQ, paged=True,
        prompts=[np.concatenate([prefix, rng.integers(0, lm_cfg.vocab_size, n)])
                 for n in (17, 40, 64, 100, 128, 160, 200, 256)], hold_divergence=True)
    del params
    torch.cuda.empty_cache()
    timed("paged_parity", paged_parity_phase)
    rwkv_serving = timed("rwkv_serving", rwkv_serving_phase,
                         dataclasses.replace(get_config("rwkv6-7b"), use_pallas=True))
    moe_serving = timed("moe_serving", paged_layout_phase, "moe_serving", dataclasses.replace(
        get_config("moonshot-v1-16b-a3b"), use_pallas=True), MOE_POOL_PAGES, False)
    mla_serving = timed("mla_serving", paged_layout_phase, "mla_serving", dataclasses.replace(
        get_config("deepseek-v2-236b"), num_layers=MLA_LAYERS, use_pallas=True), None, True)
    # the train phases keep every activation (no recompute), as they did before
    # the port had remat, so their launch counts and series stay comparable
    rwkv_cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=TRAIN_LAYERS,
                                   use_pallas=True, remat_policy="nothing")
    train = timed("train", train_phase, rwkv_cfg, k3.rwkv6_scan,
                  TRAIN_LAYERS * rwkv_cfg.microbatches * TRAIN_STEPS,
                  lambda path: "/mixer/" in path)
    rg_train_cfg = dataclasses.replace(rg_cfg, num_layers=RG_TRAIN_LAYERS, remat_policy="nothing")
    n_rec = sum(kind == "recurrent" for kind in rg_train_cfg.layer_kinds())
    rg_train = timed("rg_train", train_phase, rg_train_cfg, k2.rglru_scan,
                     n_rec * rg_train_cfg.microbatches * TRAIN_STEPS,
                     lambda path: path.rsplit("/", 1)[-1] in ("lam", "w_a", "w_x"))
    if rg_train["launches"]["rglru_scan/tma"] != rg_train["launches"]["rglru_scan"]:
        raise AssertionError(f"K2's launches by path in training: {rg_train['launches']}")
    if not 0 < graphs["recurrentgemma-9b"]["launches"]["rglru_scan/tma"] \
            == graphs["recurrentgemma-9b"]["launches"]["rglru_scan"]:
        raise AssertionError(f"K2 in decode_graph: {graphs['recurrentgemma-9b']['launches']}")
    whisper_graph = graphs["whisper-large-v3"]
    if whisper_graph["launches"]["flash_attention"] != cfg.encoder_layers * whisper_graph[
            "admissions"]:
        raise AssertionError(f"K1 in decode_graph: {whisper_graph['launches']} over "
                             f"{whisper_graph['admissions']} admissions")
    timed("train_parity", train_parity_phase, "rwkv6-7b", 2, k3.rwkv6_scan, 2)
    timed("rg_train_parity", train_parity_phase, "recurrentgemma-9b", RG_TRAIN_LAYERS,
          k2.rglru_scan, n_rec)
    train_substrate = timed("train_substrate", train_substrate_phase, k3.rwkv6_scan)
    dense = timed("dense_train", dense_train_phase, fa.flash_attention)
    moe_train = timed("moe_train", moe_train_phase, fa.flash_attention)
    vision = timed("vision_serving", vision_serving_phase)
    vision_parity = timed("vision_parity", vision_parity_phase)
    vision_train = timed("vision_train", vision_train_phase, fa.flash_attention)
    distributed = timed("distributed", distributed_phase)
    emit({"phase": "timing", "seconds": seconds, "total_s": time.perf_counter() - t0})
    paged_runs = paged_serving["runs"]
    emit({"phase": "summary", "internlm2-20b serving": {
        name: {k: [r[k] for r in runs] for k in (
            "prime_ms_miss_mean", "prime_ms_hit_mean", "step_ms", "step_bound_ms",
            "tokens_per_s") if k in runs[0]} for name, runs in paged_runs.items()} | {
        "prefix_hit_rate": [r["pool_stats"]["prefix_hit_rate"] for r in paged_runs["paged"]],
        "token_agreement_bf16": paged_serving["token_agreement_bf16"],
        "peak_mem_gb": paged_serving["peak_mem_gb"]},
        "recurrentgemma-9b serving": {
        k: rg_serving[k] for k in ("prime_ms", "step_ms", "tokens_per_s")} | {
        "device_idle_share": rg_serving["profile"].get("device_idle_share", "not measured")},
        "recurrentgemma-9b train": {
            "step_ms": [r["step_ms"] for r in rg_train["steps"]],
            "tokens_per_s": [r["tokens_per_s"] for r in rg_train["steps"]],
            "peak_mem_gb": rg_train["peak_mem_gb"]},
        "rwkv6-7b train_substrate": {
            "step_ms": [q["step_ms"] for q in train_substrate["quanta"]],
            "health": [q["health_status"] for q in train_substrate["quanta"]],
            **{k: train_substrate[k] for k in ("warmup_ms", "checkpoint_bytes",
                                                "checkpoint_save_s", "restore_s", "twin",
                                                "peak_mem_gb")}},
        "qwen2.5-32b dense_train": {policy: {
            "step_ms": [r["step_ms"] for r in run["steps"]],
            "tokens_per_s": [r["tokens_per_s"] for r in run["steps"]],
            "peak_mem_gb": run["peak_mem_gb"], "peak_fwd_bwd_gb": run["peak_fwd_bwd_gb"]}
            for policy, run in dense.items()},
        "rwkv6-7b serving": {k: rwkv_serving[k] for k in (
            "prime_ms", "prime_bound_ms_mean", "step_ms", "step_ms_median", "step_bound_ms",
            "tokens_per_s", "peak_mem_gb")} | {
            "eager_step_ms_median": rwkv_serving["eager"]["step_ms_median"],
            "window_idle_share_unprofiled": rwkv_serving["window"].get(
                "device_idle_share_unprofiled", "not measured"),
            "carry_max_layer_rel_err": rwkv_serving["carry"]["max_layer_rel_err"]},
        **{f"{r['arch']} {name}": {k: r["graphed"][k] for k in (
            "prime_ms_miss_mean", "prime_ms_hit_mean", "step_ms", "step_ms_median",
            "step_bound_ms", "tokens_per_s")} | {
            "step_bound_ms_active": r["step_bound_ms_active"],
            "eager_step_ms_median": r["eager"]["step_ms_median"],
            "dropped": r.get("dropped"), "peak_mem_gb": r["peak_mem_gb"],
            **({"token_agreement_bf16": r["contiguous"]["token_agreement_bf16"],
                "token_agreement_bf16_no_drops":
                    r["contiguous"]["no_drops"]["token_agreement_bf16"]}
               if "contiguous" in r else {}),
            "window_idle_share_unprofiled": r["window"].get("device_idle_share_unprofiled",
                                                            "not measured")}
           for name, r in (("moe_serving", moe_serving), ("mla_serving", mla_serving))},
        "llama-3.2-vision-90b serving": {k: vision[k] for k in (
            "layers", "prime_ms", "prime_bound_ms_mean", "step_ms", "step_ms_median",
            "step_bound_ms", "tokens_per_s", "peak_mem_gb")} | {
            "eager_step_ms_median": vision["eager"]["step_ms_median"],
            "paged_step_ms_median": vision["paged"]["step_ms_median"],
            "paged_token_agreement_bf16": vision["paged"]["token_agreement_bf16"],
            "logits_bit_equal": vision["logits"]["bit_equal"],
            "window_idle_share_unprofiled": vision["window"].get(
                "device_idle_share_unprofiled", "not measured")},
        "llama-3.2-vision-90b parity": {k: vision_parity[k] for k in (
            "layers", "max_layer_rel_err", "limit", "image_kv_equal")},
        "llama-3.2-vision-90b train": {
            "step_ms": [r["step_ms"] for r in vision_train["steps"]],
            "tokens_per_s": [r["tokens_per_s"] for r in vision_train["steps"]],
            **{k: vision_train[k] for k in ("layers", "floor_ms", "k1_per_step", "k1_expected",
                                            "peak_mem_gb")}},
        "internlm2-20b distributed": {k: distributed[k] for k in (
            "layers", "mesh", "max_loss_diff", "loss_tol", "grad_norm_rel_diff")} | {
            name: {k: r[k] for k in ("loss", "grad_norm", "step_ms", "launches")}
            for name, r in distributed["runs"].items()},
        "moonshot-v1-16b-a3b moe_train": {
            "step_ms": [r["step_ms"] for r in moe_train["steps"]],
            "tokens_per_s": [r["tokens_per_s"] for r in moe_train["steps"]],
            **{k: moe_train[k] for k in ("floor_ms", "moe_aux", "k1_per_step", "peak_mem_gb")}},
        "k2": {k: k2_res[k] for k in ("kernel_ms", "bound_ms", "copy_ceiling_ms",
                                      "kernel_ms_prefill", "bound_ms_prefill",
                                      "copy_ceiling_ms_prefill")},
        "decode_graph": {f"{arch} {layout}": {
            "step_ms_median": r["step_ms_median"],
            "window_idle_share": {f"{name} @{p}": w.get("device_idle_share", "not measured")
                                  for p, ws in r["windows"].items() for name, w in ws.items()},
            "window_idle_share_unprofiled": {
                f"{name} @{p}": w.get("device_idle_share_unprofiled", "not measured")
                for p, ws in r["windows"].items() for name, w in ws.items()},
            "logits_bit_equal": r["logits"]["bit_equal"], "graphs": r["graphs"],
            "graph_pool_bytes": r["graph_pool_bytes"]}
            for arch, g in graphs.items() for layout, r in g["layouts"].items()},
        "serving_substrate": {arch: {
            "divergence": [q["divergence"] for q in r["requests"]],
            "backlog_tokens": [q["backlog_tokens"] for q in r["requests"]],
            "total_ms": [q["total_ms"] for q in r["requests"]],
            "predicted_total_ms": [q["predicted_total_ms"] for q in r["requests"]]}
            for arch, r in substrate.items()}})

    rg_graph = graphs["recurrentgemma-9b"]["launches"]
    k2_launches = (rg_serving["k2_launches"] + rg_graph["rglru_scan"]
                   + rg_train["launches"]["rglru_scan"])
    k1_launches = {"serving": serving["k1_launches"],
                   "decode_graph": graphs["whisper-large-v3"]["launches"]["flash_attention"],
                   "paged_whisper": paged_whisper["k1_launches_paged"],
                   "paged_whisper_contiguous": paged_whisper["k1_launches_contiguous"],
                   "serving_substrate": substrate["whisper-large-v3"]["k1_launches"],
                   **{f"dense_train {policy}": run["launches"]["flash_attention"]
                      for policy, run in dense.items()},
                   "moe_train": moe_train["launches"]["flash_attention"],
                   "vision_train": vision_train["launches"]["flash_attention"],
                   **{f"distributed {name}": r["launches"]
                      for name, r in distributed["runs"].items()}}
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:31",
        "launches": sum(k1_launches.values()), "launches_by_phase": k1_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"], "shapes": {
            arch: {key: r[key] for key in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
            for arch, r in k1["shapes"].items()}}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/rglru_scan.py:22",
        "launches": k2_launches, "launches_serving": rg_serving["k2_launches"],
        "launches_decode_graph": rg_graph["rglru_scan"],
        "launches_train": rg_train["launches"]["rglru_scan"],
        "launches_by_path": {p: rg_serving["launches"][f"rglru_scan/{p}"]
                             + rg_graph[f"rglru_scan/{p}"]
                             + rg_train["launches"][f"rglru_scan/{p}"]
                             for p in k2.rglru_scan.path_launches},
        "max_abs_err": k2_res["max_abs_err"], "ms": k2_res["kernel_ms"],
        "ms_events": k2_res["kernel_events_ms"], "plain_ms": k2_res["plain_ms"],
        "bound_ms": k2_res["bound_ms"], "bound_by": k2_res["bound_by"],
        "copy_ceiling_ms": k2_res["copy_ceiling_ms"],
        "host_us_per_call": k2_res["host_us_per_call"], "shapes": {
            tag: {key: k2_res[key + suffix] for key in (
                "shape", "kernel_ms", "kernel_events_ms", "plain_ms", "bound_ms",
                "copy_ceiling_ms", "host_us_per_call")}
            for tag, suffix in (("prefill", "_prefill"), ("group", "_group"))},
        "ms_prefill": k2_res["kernel_ms_prefill"],
        "plain_ms_prefill": k2_res["plain_ms_prefill"],
        "bound_ms_prefill": k2_res["bound_ms_prefill"],
        "ptxas": ptxas[str(build(k2.SOURCE).relative_to(ROOT))], "library_ms": None}, {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6_scan.py:24",
        "launches": train["launches"]["rwkv6_scan"] + train_substrate["k3_launches"],
        "launches_by_phase": {"train": train["launches"]["rwkv6_scan"],
                              "train_substrate": train_substrate["k3_launches"]},
        "max_abs_err": k3_res["max_abs_err"],
        "ms": k3_res["kernel_ms"], "ms_events": k3_res["kernel_events_ms"],
        "plain_ms": k3_res["plain_chunked_ms"],
        "plain_sequential_ms": k3_res["plain_sequential_ms"],
        "bound_ms": k3_res["bound_ms"], "bound_by": k3_res["bound_by"],
        "bound_ms_fp32_units": k3_res["bound_ms_fp32_units"],
        "ptxas": ptxas[str(build(k3.SOURCE).relative_to(ROOT))],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
