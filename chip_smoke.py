#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) on any failed check:

1. build — compile the hand-written CUDA kernels of ``src/repro_torch/csrc``
   with nvcc, one process per source, all started together.
2. kernels — flash attention (K1) against its plain PyTorch version at every
   shape of ``tests/test_kernels.py``'s flash sweep and block-shape cases,
   and at the whisper-large-v3 encoder shape, where the kernel, the plain
   version and PyTorch's ``scaled_dot_product_attention`` (a yardstick the
   port never calls) are timed with CUDA events; K1's gradient (kernel
   forward, plain backward) against autograd through the plain version.
3. rwkv6 kernel — the RWKV-6 chunked scan (K3) against the sequential
   oracle ``rwkv6_ref`` at every shape of ``test_rwkv6_kernel_sweep`` in
   both dtypes, the chunk-32-vs-128 continuity case and the rwkv6-7b
   training shape (B=2, S=4096, H=64, hd=64, bf16), where the kernel and
   both plain versions (sequential and chunked) are timed.
4. serving — whisper-large-v3 at full width and depth (32 + 32 layers,
   d_model 1280, vocab 51866, 1500 frames) in bf16 with random seeded
   weights and ``use_pallas=True``: 16 requests through the continuous
   batching engine (``submit`` then ``drain``) and one ``generate`` group.
   Every encoder attention of every admission must have launched K1.
5. parity — the full-width fp32 encoder, layer by layer, through the kernel
   and through the plain path from the same input; the largest difference
   must be <= 1e-3 (see ``parity_phase`` for why per layer).
6. train — rwkv6-7b at full width (d_model 4096, 64 heads of 64, d_ff
   14336, vocab 65536) cut to 4 of 32 layers, bf16 params, fp32 moments,
   ``use_pallas=True``: 3 steps of the port's launcher loop at global batch
   8 x 4096 tokens in 4 microbatches.  K3 must launch once per layer and
   microbatch (48 times; the backward recomputes through the plain chunked
   version), loss and grad norm must be finite and every layer's mixer
   parameters must receive a gradient.
7. train-parity — the same width in fp32 at depth 2, B=1, S=1024: the loss
   and its grads through K3 against the plain path, within 5e-3 on the loss
   and 1e-3 relative on the grad norm.

Output: the card (``nvidia-smi`` name and power limit), one JSON line per
phase, the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
SWEEP = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 1, 128),
         (2, 192, 6, 3, 32), (1, 128, 4, 2, 128)]
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}   # (rtol, atol)
#: K1's gradient: (rtol, atol)
GRAD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
#: tests/test_kernels.py::test_rwkv6_kernel_sweep (B, S, H, hd, chunk)
RWKV_SWEEP = [(1, 64, 2, 32, 32), (2, 128, 4, 64, 32), (1, 256, 2, 16, 64)]
#: the largest difference relative to the largest output, as that sweep
RWKV_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TRAIN_SHAPE = (2, 4096, 64, 64)                 # B, S, H, hd of one rwkv6-7b microbatch
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 3, 8, 4096


def emit(obj) -> None:
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


def attention_inputs(B, S, H, K, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v


def check_close(name, out, ref, dtype) -> float:
    rtol, atol = TOL[dtype]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    bad = err > atol + rtol * r.abs()
    if not torch.isfinite(o).all() or bad.any():
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {err.max().item():.3e}, "
                             f"{int(bad.sum())} elements out of tolerance)")
    return err.max().item()


def kernel_phase(fa, mha, mha_ref) -> dict:
    """K1 against its plain version; times at the serving shape."""
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

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel_ms = cuda_ms(lambda: mha(q, k, v, causal=False))
    plain_ms = cuda_ms(lambda: mha_ref(q, k, v, causal=False), iters=5)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    kernel_ms_fp32 = cuda_ms(lambda: mha(q32, k32, v32, causal=False), iters=5)
    flops = 4 * B * H * S * S * hd                        # QK^T and PV, bidirectional
    nbytes = 4 * B * S * H * hd * q.element_size()        # q, k, v read once, o written once
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes"
    bound_ms_fp32 = max(flops / PEAK_FP32_FLOPS, 2 * nbytes / PEAK_BYTES) * 1e3
    res = dict(cases=cases, shape=list(SERVING_SHAPE), max_abs_err=err,
               max_abs_err_fp32=err32, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               kernel_ms_fp32=kernel_ms_fp32, bound_ms_fp32=bound_ms_fp32,
               flops=flops, bytes=nbytes)
    res["grad_max_rel_err"] = flash_grad_check(mha, mha_ref)
    emit({"phase": "kernels", **res})
    return res


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


def check_rel(name, out, ref, limit) -> float:
    out, ref = out.float(), ref.float()
    err = ((out - ref).abs().max() / (ref.abs().max() + 1e-6)).item()
    if not torch.isfinite(out).all() or not err < limit:
        raise AssertionError(f"{name}: K3 disagrees with rwkv6_ref (relative error "
                             f"{err:.3e}, limit {limit:.0e})")
    return err


def rwkv6_work(B, S, H, hd, C, elem_bytes):
    """(FLOPs, bytes) of the chunked scan on these shapes: per chunk the
    strict lower triangle of the pairwise matrix (sub, exp, 2 mul, add per
    channel), its diagonal, A.V over the triangle, the decayed reads r.S and
    the state update S*decay + k^T.v, plus the decay folds; r, k, v, y in
    their dtype and lw in fp32, each read or written once."""
    pairs = C * (C - 1) // 2
    per_chunk = (5 * pairs * hd + 3 * C * hd + 2 * (pairs + C) * hd + 2 * C * hd * hd
                 + 4 * C * hd + hd * hd * (1 + 2 * C))
    flops = B * H * (S // C) * per_chunk
    nbytes = B * S * H * hd * (4 * elem_bytes + 4) + H * hd * 4
    return flops, nbytes


def rwkv6_kernel_phase(k3, time_mix_scan, time_mix_ref, time_mix_chunked) -> dict:
    """K3 against the sequential oracle; times at the training shape."""
    cases = 0
    for i, (B, S, H, hd, chunk) in enumerate(RWKV_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = rwkv_inputs(B, S, H, hd, dtype, seed=i)
            check_rel(f"sweep {(B, S, H, hd, chunk, dtype)}", time_mix_scan(*args, chunk=chunk),
                      time_mix_ref(*args), RWKV_LIMIT[dtype])
            cases += 1
    args = rwkv_inputs(1, 128, 2, 32, torch.float32, seed=5, lw_high=1.0)
    o32, o128 = time_mix_scan(*args, chunk=32), time_mix_scan(*args, chunk=128)
    continuity = check_rel("continuity 32 vs 128", o32, o128, RWKV_LIMIT[torch.float32])
    check_rel("continuity 128", o128, time_mix_ref(*args), RWKV_LIMIT[torch.float32])
    cases += 2

    B, S, H, hd = TRAIN_SHAPE
    args = rwkv_inputs(B, S, H, hd, torch.bfloat16, seed=9)
    out = time_mix_scan(*args)
    with torch.no_grad():
        ref = time_mix_ref(*args)
    rel = check_rel("training shape bf16", out, ref, RWKV_LIMIT[torch.bfloat16])
    abs_err = (out.float() - ref.float()).abs().max().item()
    cases += 1
    torch.cuda.synchronize()

    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: time_mix_scan(*args), iters=10)
        chunked_ms = cuda_ms(lambda: time_mix_chunked(*args), iters=3, warmup=1)
        sequential_ms = cuda_ms(lambda: time_mix_ref(*args), iters=1, warmup=1)
    # what one layer and microbatch of the train step pays: K3 forward, then
    # the backward recomputing through the chunked plain version
    leaves = [t.detach().requires_grad_() for t in args]
    g = torch.randn_like(out)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(time_mix_scan(*leaves), leaves, g),
                         iters=2, warmup=1)
    flops, nbytes = rwkv6_work(B, S, H, hd, 32, 2)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    res = dict(cases=cases, shape=list(TRAIN_SHAPE), chunk=32, max_abs_err=abs_err,
               max_rel_err=rel, continuity_rel_err=continuity, kernel_ms=kernel_ms,
               plain_chunked_ms=chunked_ms, plain_sequential_ms=sequential_ms,
               fwd_bwd_ms=fwd_bwd_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops > t_bytes else "bytes",
               flops=flops, bytes=nbytes, smem_bytes=k3.smem_bytes(32, hd))
    emit({"phase": "rwkv6_kernel", **res})
    return res


def serving_phase(fa, cfg, n_requests: int = 16) -> dict:
    """whisper-large-v3 at full size through the port's engine."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=8, max_seq=448, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # record (on the device) whether any step produced a NaN logit
    nan_flags = []

    def watch(step):
        def run(*args):
            cache, logits = step(*args)
            nan_flags.append(torch.isnan(logits).any())
            return cache, logits
        return run

    eng._prefill, eng._decode = watch(eng._prefill), watch(eng._decode)

    rng = np.random.default_rng(0)
    lengths = np.linspace(4, 64, n_requests).astype(int)
    budgets = rng.permutation(np.linspace(8, 64, n_requests).astype(int))
    reqs = [Request(f"r{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=int(m)) for i, (n, m) in enumerate(zip(lengths, budgets))]
    group = [Request(f"g{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     max_new_tokens=16) for i, n in enumerate((5, 17, 33, 60))]

    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.drain()
    cb_wall_s = time.perf_counter() - t0
    cb_metrics = dict(eng.metrics)
    t0 = time.perf_counter()
    eng.generate(group)
    gen_wall_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches

    for r in reqs + group:
        assert r.done and len(r.generated) == r.max_new_tokens, r.request_id
        assert all(0 <= t < cfg.vocab_size for t in r.generated), r.request_id
    assert not torch.stack(nan_flags).any().item(), "NaN logits in serving"
    prefills = len(reqs) + 1                  # one B=1 prime per request, one group prefill
    assert launches == cfg.encoder_layers * prefills, (
        f"K1 launched {launches} times, expected {cfg.encoder_layers} x {prefills}")
    gen_steps = eng.metrics["decode_steps"] - cb_metrics["decode_steps"]
    res = dict(
        arch=cfg.name, params=sum(t.numel() for _, t in tree_leaves(eng.params)),
        init_s=init_s, requests=len(reqs), prefills=prefills, k1_launches=launches,
        prime_ms=cb_metrics["prefill_ms"] / len(reqs),
        step_ms=cb_metrics["decode_ms"] / cb_metrics["decode_steps"],
        decode_steps=cb_metrics["decode_steps"], tokens=cb_metrics["tokens"],
        tokens_per_s=cb_metrics["tokens"] / cb_wall_s, wall_s=cb_wall_s,
        generate_prefill_ms=eng.metrics["prefill_ms"] - cb_metrics["prefill_ms"],
        generate_step_ms=(eng.metrics["decode_ms"] - cb_metrics["decode_ms"]) / gen_steps,
        generate_tokens_per_s=sum(r.max_new_tokens for r in group) / gen_wall_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res.update(encoder_breakdown(cfg, eng.params))
    emit({"phase": "serving", **res})
    emit({"phase": "profile", **profile_window(eng, cfg)})
    del eng
    torch.cuda.empty_cache()
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
            plain = apply_layer_train(plain_cfg, ld, lp, x, pos, None, True)
            kern = apply_layer_train(kern_cfg, ld, lp, x, pos, None, True)
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


def train_phase(k3, fa) -> dict:
    """rwkv6-7b at full width, 4 of 32 layers, through the port's launcher
    loop: 3 steps of 8 x 4096 tokens in 4 microbatches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import count_params
    from repro_torch.models.common import tree_leaves

    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=TRAIN_LAYERS, use_pallas=True)
    assert cfg.param_dtype == "bfloat16" and cfg.moment_dtype == "float32"
    torch.cuda.reset_peak_memory_stats()
    k3.rwkv6_scan.launches = fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    state, records = train_loop(cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                                seq=TRAIN_SEQ, device="cuda", log=lambda s: None)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, k1_launches = k3.rwkv6_scan.launches, fa.flash_attention.launches

    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"train step {r['step']}: loss {r['loss']}, "
                                 f"grad norm {r['grad_norm']}")
    expected = TRAIN_LAYERS * cfg.microbatches * TRAIN_STEPS
    if len(records) != TRAIN_STEPS or launches != expected:
        raise AssertionError(f"K3 launched {launches} times in {len(records)} steps, "
                             f"expected {expected}")
    # a parameter whose grad was ever non-zero has a non-zero second moment
    no_grad = [f"{path}[{layer}]" for path, nu in tree_leaves(state.opt.nu)
               if "/mixer/" in path for layer in range(TRAIN_LAYERS)
               if not nu[layer].abs().sum().item() > 0]
    if no_grad:
        raise AssertionError(f"mixer parameters without a gradient: {no_grad}")
    res = dict(arch=cfg.name, layers=TRAIN_LAYERS, params=count_params(cfg),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=cfg.microbatches,
               k3_launches=launches, k1_launches=k1_launches, wall_s=wall_s, steps=records,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "train", **res})
    emit({"phase": "train_profile", **profile_train_step(cfg, state)})
    del state
    torch.cuda.empty_cache()
    return res


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
    return {"profile_wall_ms": wall_ms, "profile_device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_launches": sum(n for _, _, n in rows),
            "top_device_ms": [[k[:80], ms, n] for k, ms, n in rows[:10]]}


def train_parity_phase(k3) -> dict:
    """Full-width rwkv6-7b in fp32 at depth 2: ``loss_fn`` and its grads
    through K3 against the plain path, from the same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_specs
    from repro_torch.models.common import init_params
    from repro_torch.training.data import SyntheticTokenDataset
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import _grad_fn

    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=2, param_dtype="float32",
                              compute_dtype="float32", use_pallas=False)
    params = init_params(model_specs(cfg), seed=1, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in
             SyntheticTokenDataset(cfg.vocab_size, 1024, 1).batch_at(0).items()}
    out, grads = {}, {}
    for name, use in (("kernel", True), ("plain", False)):
        before = k3.rwkv6_scan.launches
        (loss, _), grads[name] = _grad_fn(dataclasses.replace(cfg, use_pallas=use), params, batch)
        out[name] = (loss.item(), global_norm(grads[name]).item(),
                     k3.rwkv6_scan.launches - before)
    leaf_diff = max(((grads["kernel"][k] - g).abs().max() / g.abs().max()).item()
                    for k, g in grads["plain"].items())
    del grads
    dloss = abs(out["kernel"][0] - out["plain"][0])
    dnorm = abs(out["kernel"][1] - out["plain"][1]) / out["plain"][1]
    if out["kernel"][2] != cfg.num_layers or out["plain"][2] != 0:
        raise AssertionError(f"train-parity: K3 launches {out['kernel'][2]} / {out['plain'][2]}")
    if not (dloss <= 5e-3 and dnorm <= 1e-3):
        raise AssertionError(f"train-parity: |dloss| {dloss:.3e} (limit 5e-3), relative "
                             f"grad-norm difference {dnorm:.3e} (limit 1e-3)")
    res = dict(layers=cfg.num_layers, seq=1024, loss_kernel=out["kernel"][0],
               loss_plain=out["plain"][0], abs_loss_diff=dloss,
               grad_norm_kernel=out["kernel"][1], grad_norm_plain=out["plain"][1],
               rel_grad_norm_diff=dnorm, max_rel_leaf_grad_diff=leaf_diff)
    emit({"phase": "train_parity", **res})
    del params
    torch.cuda.empty_cache()
    return res


def profile_window(eng, cfg) -> dict:
    """Device busy and idle share over 8 admissions and 8 decode steps."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(1)
    for i in range(eng.batch_size):
        eng.submit(Request(f"p{i}", rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                           max_new_tokens=9))
    torch.cuda.synchronize()
    return device_profile(eng.drain)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import mha, mha_ref
    from repro_torch.kernels.rwkv6 import rwkv6_scan as k3
    from repro_torch.kernels.rwkv6.ops import time_mix_chunked, time_mix_ref, time_mix_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    sources = (fa.SOURCE, k3.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:       # one nvcc per source, together
        libs = list(pool.map(build, sources))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": {
        str(lib.relative_to(ROOT)): [ln.strip() for ln in lib.with_suffix(".log").read_text()
                                     .splitlines() if "registers" in ln or "spill" in ln]
        for lib in libs}})

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    k1 = timed("kernels", kernel_phase, fa, mha, mha_ref)
    k3_res = timed("rwkv6_kernel", rwkv6_kernel_phase, k3, time_mix_scan, time_mix_ref,
                   time_mix_chunked)
    cfg = dataclasses.replace(get_config("whisper-large-v3"), use_pallas=True)
    serving = timed("serving", serving_phase, fa, cfg)
    timed("parity", parity_phase, fa, cfg)
    train = timed("train", train_phase, k3, fa)
    timed("train_parity", train_parity_phase, k3)
    emit({"phase": "timing", "seconds": seconds, "total_s": time.perf_counter() - t0})

    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:31",
        "launches": serving["k1_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6_scan.py:24",
        "launches": train["k3_launches"], "max_abs_err": k3_res["max_abs_err"],
        "ms": k3_res["kernel_ms"], "plain_ms": k3_res["plain_chunked_ms"],
        "plain_sequential_ms": k3_res["plain_sequential_ms"],
        "bound_ms": k3_res["bound_ms"], "bound_by": k3_res["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
