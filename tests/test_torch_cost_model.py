"""PyTorch port, serving cost model: ``repro_torch.roofline`` against
``repro.roofline`` under the same ``Hardware`` figures (one H100 SXM, bf16
dense).  Everything the two compute from shapes and observations must be
equal — the roofline terms, the step bound, the cache's bytes, the step
price after the same observations — except the prefill price, which the
port repairs twice: the reference floors a prompt of n tokens at n weight
reads, the port at one (``max(2·N·n / peak, weight_bytes / hbm_bw)``,
ROADMAP C3); and the reference prices n tokens at n times the median
observed ms per token, the port at a fixed part plus a per-token part
fitted to the observed (tokens, ms) pairs (ROADMAP C5).  Where the two
differ the test states the reference's value beside the port's."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.roofline.analysis import Hardware as JaxHardware
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.roofline.analysis import roofline_terms as jax_roofline_terms
from repro.roofline.serving import ServingCostModel as JaxCostModel
from repro_torch.configs import get_config, reduced
from repro_torch.models import count_params, paged_support
from repro_torch.roofline import HW, Hardware, model_flops, roofline_terms
from repro_torch.roofline.serving import ServingCostModel

JAX_HW = JaxHardware(name=HW.name, peak_flops=HW.peak_flops, hbm_bw=HW.hbm_bw,
                     link_bw=HW.link_bw, hbm_bytes=HW.hbm_bytes)
_BYTES = {"float32": 4, "bfloat16": 2}
ARCHS = ["internlm2-20b", "whisper-large-v3", "recurrentgemma-9b"]
CASES = [(arch, paged) for arch in ARCHS for paged in (False, True)
         if not paged or paged_support(reduced(get_config(arch)))[0]]


def test_default_hardware_is_the_card():
    assert (HW.peak_flops, HW.hbm_bw, HW.hbm_bytes, HW.link_bw) == (989e12, 3.35e12, 80e9,
                                                                    450e9)


@pytest.mark.parametrize("seed", range(4))
def test_roofline_terms_and_model_flops_match_reference(seed):
    rng = np.random.default_rng(seed)
    hw = Hardware(name="x", peak_flops=float(rng.uniform(1e12, 1e15)),
                  hbm_bw=float(rng.uniform(1e11, 1e13)), link_bw=float(rng.uniform(1e9, 1e12)),
                  hbm_bytes=80e9)
    jhw = JaxHardware(**dataclasses.asdict(hw))
    for _ in range(16):
        f, b, c = (float(x) for x in 10.0 ** rng.uniform(6, 16, 3))
        assert roofline_terms(f, b, c, hw) == jax_roofline_terms(f, b, c, jhw)
        n, tokens = int(rng.integers(1, 10 ** 11)), int(rng.integers(1, 10 ** 6))
        for kind in ("train", "inference"):
            assert model_flops(n, tokens, kind) == jax_model_flops(n, tokens, kind)
    assert roofline_terms(0.0, 0.0, 0.0, hw) == jax_roofline_terms(0.0, 0.0, 0.0, jhw)


def _pair(arch, paged, batch_size=2, max_seq=64, full=False):
    jcfg = jax_get_config(arch) if full else jax_reduced(jax_get_config(arch))
    tcfg = get_config(arch) if full else reduced(get_config(arch))
    kw = dict(page_size=8, pool_pages=16) if paged else {}
    return (JaxCostModel(jcfg, batch_size=batch_size, max_seq=max_seq, hw=JAX_HW, **kw),
            ServingCostModel(tcfg, batch_size=batch_size, max_seq=max_seq, **kw))


@pytest.mark.parametrize("arch,paged", CASES)
def test_cost_model_matches_reference(arch, paged):
    ref, port = _pair(arch, paged)
    for name in ("step_lb_ms", "kv_hbm_bytes", "bytes_per_page", "resident_cache_bytes"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.step_ms() == ref.step_ms() == port.step_lb_ms
    rng = np.random.default_rng(1)
    for ms in rng.uniform(0.0, 3.0 * port.step_lb_ms, 80):    # past WINDOW: old ones drop
        ref.observe_step(float(ms))
        port.observe_step(float(ms))
    assert port.step_ms() == ref.step_ms()
    assert port.page_hbm_bytes(5, 3) == ref.page_hbm_bytes(5, 3)
    want, got = ref.snapshot(), port.snapshot()
    for key in ("step_lb_ms", "step_ms", "dominant", "observed_steps", "observed_prefills"):
        assert got[key] == want[key], key
    assert ("bytes_per_page" in got) == ("bytes_per_page" in want) == paged
    # the added keys: the weight read that floors any prefill, and the fit
    assert set(got) - set(want) == {"prefill_weight_read_ms", "prefill_fixed_ms",
                                    "prefill_ms_per_token"}


@pytest.mark.parametrize("arch,paged", CASES)
@pytest.mark.parametrize("rate", [1.5, 2.0, 3.0])
def test_prefill_matches_reference_where_observation_exceeds_both_floors(arch, paged, rate):
    """Prefills observed at one per-token rate above the reference's
    per-token floor (itself the larger of the port's two floors at one
    token), at three lengths: the port's fit is that rate with no fixed
    part, the reference's median is the same rate, and the prices agree."""
    ref, port = _pair(arch, paged)
    ms_tok = ref.prefill_lb_ms_per_token * rate
    for n in (10, 11, 12):
        ref.observe_prefill(n, ms_tok * n)
        port.observe_prefill(n, ms_tok * n)
    for n in (1, 7, 64, 2048):
        assert port.prefill_ms(n) == pytest.approx(ref.prefill_ms(n), rel=1e-12)
    for args, kw in (((16, 8), {}), ((16, 8, 12), dict(backlog_prefill_tokens=40)),
                     ((40, 3, 0), dict(cached_prefix_tokens=16))):
        assert port.predict_request_ms(*args, **kw) == pytest.approx(
            ref.predict_request_ms(*args, **kw), rel=1e-12)


@pytest.mark.parametrize("arch,paged", CASES)
def test_prefill_floor_is_one_weight_read_not_one_per_token(arch, paged):
    """With nothing observed: the port's floor is max(n · 2N/peak, the
    weights once); the reference's is n · max(2N/peak, the weights once)."""
    ref, port = _pair(arch, paged)
    cfg = reduced(get_config(arch))
    n_params = count_params(cfg)
    compute_tok = 2 * n_params / HW.peak_flops * 1e3
    weights = n_params * _BYTES[cfg.param_dtype] / HW.hbm_bw * 1e3
    assert port.prefill_lb_ms_per_token == pytest.approx(compute_tok, rel=1e-12)
    assert port.prefill_weight_read_ms == pytest.approx(weights, rel=1e-12)
    assert ref.prefill_lb_ms_per_token == pytest.approx(max(compute_tok, weights), rel=1e-12)
    assert port.prefill_ms(0) == ref.prefill_ms(0) == 0.0
    for n in (1, 16, 512, 4096):
        floor = max(n * compute_tok, weights)
        assert port.prefill_ms(n) == pytest.approx(floor, rel=1e-12)
        reference = n * max(compute_tok, weights)
        assert ref.prefill_ms(n) == pytest.approx(reference, rel=1e-12)
        assert port.prefill_ms(n) <= ref.prefill_ms(n)
    # with no backlog the backlog's prefill term is 0 in both: the
    # prediction is the request's own prefill plus its decode steps
    step = port.step_ms()
    assert port.predict_request_ms(16, 8) == pytest.approx(
        port.safety * (max(16 * compute_tok, weights) + 7 * step), rel=1e-12)
    assert ref.predict_request_ms(16, 8) == pytest.approx(
        ref.safety * (16 * max(compute_tok, weights) + 7 * step), rel=1e-12)


def test_cost_model_prices_prefill_backlog_and_prefix_hits():
    """``tests/test_serving_paged.py``'s case, on the port.  With nothing
    observed, a 32- or 8-token prefill of the reduced model is floored by
    the same one weight read, so the prefix hit saves nothing there (the
    reference's per-token floor prices it lower); once a prefill is
    observed (the adapter's calibration request), the price follows the
    prefilled tokens and the hit is cheaper."""
    cfg = reduced(get_config("internlm2-20b"))
    cost = ServingCostModel(cfg, batch_size=2, max_seq=64, page_size=8, pool_pages=16)
    ref = JaxCostModel(jax_reduced(jax_get_config("internlm2-20b")), batch_size=2, max_seq=64,
                       page_size=8, pool_pages=16, hw=JAX_HW)
    floored = cost.predict_request_ms(32, 8, cached_prefix_tokens=24)
    assert floored == cost.predict_request_ms(32, 8)
    assert ref.predict_request_ms(32, 8, cached_prefix_tokens=24) < ref.predict_request_ms(32, 8)
    cost.observe_prefill(8, 8 * cost.prefill_weight_read_ms)
    base = cost.predict_request_ms(32, 8)
    with_backlog = cost.predict_request_ms(32, 8, backlog_prefill_tokens=64)
    with_prefix = cost.predict_request_ms(32, 8, cached_prefix_tokens=24)
    assert with_backlog > base
    assert with_prefix < base
    assert cost.bytes_per_page > 0
    assert cost.page_hbm_bytes(4) == (cost.resident_cache_bytes + 4 * cost.bytes_per_page)
    assert cost.page_hbm_bytes(4, 2) > cost.page_hbm_bytes(4)


class _Allocations(TorchFunctionMode):
    """Bytes of every tensor a torch call creates off the ``meta`` device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.bytes += t.numel() * t.element_size()
        return out


@pytest.mark.parametrize("paged", [False, True])
def test_full_size_internlm2_prices_on_meta(paged):
    """Full-size internlm2-20b at batch 8, max_seq 4096 (the card's serving
    configuration): the cost model counts a 6.4 GB cache from meta tensors
    without allocating it, prices a 2048-token prefill at its compute
    (2·N·2048 / 989e12, about 82 ms) where the reference prices 2048 weight
    reads (24,284 ms), and keeps the reference's step bound (13.78 ms)."""
    kw = dict(page_size=16, pool_pages=2048) if paged else {}
    cfg = get_config("internlm2-20b")
    with _Allocations() as seen:
        port = ServingCostModel(cfg, batch_size=8, max_seq=4096, **kw)
    assert seen.bytes < 1 << 20
    ref = JaxCostModel(jax_get_config("internlm2-20b"), batch_size=8, max_seq=4096, hw=JAX_HW,
                       **kw)
    n_params = count_params(cfg)
    assert n_params == 19_861_149_696
    assert port.kv_hbm_bytes == ref.kv_hbm_bytes == 8 * 4096 * 196608
    assert port.step_lb_ms == ref.step_lb_ms == pytest.approx(13.7805, abs=1e-4)
    want = 2 * n_params * 2048 / HW.peak_flops * 1e3
    assert port.prefill_ms(2048) == pytest.approx(want, rel=1e-12)
    assert port.prefill_ms(2048) == pytest.approx(82.256, abs=1e-3)
    assert ref.prefill_ms(2048) == pytest.approx(24283.96, abs=0.01)


def test_prefill_fit_prices_a_long_prompt_from_two_lengths():
    """ROADMAP C5 on full-size internlm2-20b (paged, as the adapter serves
    it): an 8-token prefill observed at 95 ms (almost all fixed cost) and a
    512-token one at 160 ms.  The port fits 93.97 ms + 0.129 ms a token and
    prices 768 tokens at 193.02 ms.  The reference prices them at 768 times
    its median ms per token, floored at one weight read a token: 9,120 ms
    from the 8-token sample alone (the one sample its adapter's calibration
    gives it), and 9,106.5 ms, the floor, from both."""
    cfg = get_config("internlm2-20b")
    kw = dict(batch_size=8, max_seq=4096, page_size=16, pool_pages=2048)
    port = ServingCostModel(cfg, **kw)
    ref = JaxCostModel(jax_get_config("internlm2-20b"), hw=JAX_HW, **kw)
    ref.observe_prefill(8, 95.0)
    assert ref.prefill_ms(768) == pytest.approx(9120.0, rel=1e-12)
    port.observe_prefill(8, 95.0)
    for model in (port, ref):
        model.observe_prefill(512, 160.0)
    slope = 65.0 / 504
    fixed = 95.0 - 8 * slope
    assert port.prefill_ms(768) == pytest.approx(fixed + 768 * slope, rel=1e-12)
    assert port.prefill_ms(768) == pytest.approx(193.02, abs=0.01)
    # the median of 11.875 and 0.3125 ms a token is under the reference's
    # per-token floor of one weight read (11.857 ms), so the floor prices it
    assert (95.0 / 8 + 160.0 / 512) / 2 < ref.prefill_lb_ms_per_token
    assert ref.prefill_ms(768) == pytest.approx(768 * ref.prefill_lb_ms_per_token, rel=1e-12)
    assert ref.prefill_ms(768) == pytest.approx(9106.5, abs=0.1)
    snap = port.snapshot()
    assert snap["prefill_fixed_ms"] == round(fixed, 6)
    assert snap["prefill_ms_per_token"] == round(slope, 6)
    assert snap["observed_prefills"] == 2
    # the observed points themselves are priced as observed
    assert port.prefill_ms(8) == pytest.approx(95.0, rel=1e-12)
    assert port.prefill_ms(512) == pytest.approx(160.0, rel=1e-12)


def test_prefill_fit_floors():
    """One length observed: the slope is the per-token compute floor and
    the fixed part takes the rest.  Prefills that grow slower than that
    floor keep the floor's slope; a fixed part never goes below 0."""
    cfg = reduced(get_config("internlm2-20b"))
    cost = ServingCostModel(cfg, batch_size=2, max_seq=64)
    floor = cost.prefill_lb_ms_per_token
    cost.observe_prefill(8, 5.0)
    cost.observe_prefill(8, 7.0)
    snap = cost.snapshot()
    assert snap["prefill_ms_per_token"] == round(floor, 6)
    assert snap["prefill_fixed_ms"] == round(6.0 - 8 * floor, 6)
    assert cost.prefill_ms(40) == pytest.approx(6.0 + 32 * floor, rel=1e-12)
    falling = ServingCostModel(cfg, batch_size=2, max_seq=64)
    falling.observe_prefill(4, 9.0)
    falling.observe_prefill(40, 3.0)
    assert falling.snapshot()["prefill_ms_per_token"] == round(floor, 6)
    steep = ServingCostModel(cfg, batch_size=2, max_seq=64)
    steep.observe_prefill(10, 1e-9)
    steep.observe_prefill(20, 10.0)
    assert steep.snapshot()["prefill_fixed_ms"] == 0.0
    assert steep.prefill_ms(30) == pytest.approx(30 * (10.0 - 1e-9) / 10, rel=1e-12)
