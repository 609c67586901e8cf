"""PyTorch port, training slice: loss, grads, AdamW, the train step, data,
checkpoints and the launcher against the JAX package, on the same parameters
(JAX ``init_params`` → ``_flatten`` → ``params_from_jax``) and the same numpy
batches, at reduced fp32 configs.

Tolerances are the JAX suite's: 5e-3 on the loss and rtol 1e-3 / atol 1e-4
on grads (``tests/test_use_pallas.py``).  With ``use_pallas`` the JAX side
runs its Pallas kernels in interpret mode and the port its plain versions
(CPU tensors)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import loss_fn as jax_loss_fn
from repro.models import model_specs as jax_model_specs
from repro.models.common import init_params as jax_init_params
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import apply_updates as jax_apply_updates
from repro.training import build_train_step as jax_build_train_step
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import init_train_state as jax_init_train_state
from repro.training.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.training.checkpoint import _flatten
from repro.training.data import SyntheticTokenDataset as JaxDataset
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launcher
from repro_torch.models import loss_fn
from repro_torch.models import common as cm
from repro_torch.training import (AdamWConfig, TrainState, apply_updates, build_train_step,
                                  init_opt_state, init_train_state)
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenDataset
from repro_torch.weights import params_from_jax

ARCHS = ["rwkv6-7b", "internlm2-20b", "recurrentgemma-9b"]
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _configs(arch, **kw):
    # three layers of recurrentgemma-9b: one (recurrent, recurrent, local_attn) cycle
    layers = 3 if arch == "recurrentgemma-9b" else 2
    kw = dict(dict(vocab_size=128, attn_chunk=64, num_layers=layers), **kw)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw)
    if arch == "recurrentgemma-9b":
        # the reference's Pallas K2 fails on this JAX version (ROADMAP C):
        # the JAX side takes its plain associative scan, which K2 is held to
        jcfg = dataclasses.replace(jcfg, use_pallas=False)
    return jcfg, reduced(get_config(arch), **kw)


def _params(jcfg, seed):
    jp = jax_init_params(jax_model_specs(jcfg), seed=seed)
    return jp, params_from_jax(_flatten(jp), device="cpu")


def _batch(rows, seq, vocab, seed):
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, vocab, (rows, seq)).astype(np.int32) for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


def _assert_tree_close(tflat, jflat, **tol):
    """Port tree (flat path → tensor) against a JAX tree's ``_flatten``."""
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(jflat[key], np.float32), err_msg=key, **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_matches_jax(arch, use_pallas):
    jcfg, tcfg = _configs(arch, use_pallas=use_pallas)
    jp, tp = _params(jcfg, seed=2)
    jb, tb = _batch(2, 64, 128, seed=1)
    jl, jm = jax.jit(lambda p, b: jax_loss_fn(jcfg, p, b))(jp, jb)
    tl, tm = loss_fn(tcfg, tp, tb)
    assert abs(float(tl) - float(jl)) < 5e-3
    assert abs(float(tm["xent"]) - float(jm["xent"])) < 5e-3
    assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0


def _port_grads(tcfg, tp, tb):
    leaves = {path: t.detach().clone().requires_grad_() for path, t in cm.tree_leaves(tp)}
    loss, _ = loss_fn(tcfg, cm.tree_from_paths(tp, leaves), tb)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_grads_match_plain(arch):
    """``test_pallas_grads_match_reference`` run on the port: grads through
    the kernel ops (plain versions on CPU tensors, under autograd) against
    the model's own plain path."""
    jcfg, tcfg = _configs(arch, vocab_size=64)
    _, tp = _params(jcfg, seed=5)
    _, tb = _batch(2, 64, 64, seed=3)
    g0 = _port_grads(tcfg, tp, tb)
    g1 = _port_grads(dataclasses.replace(tcfg, use_pallas=True), tp, tb)
    for key in g0:
        torch.testing.assert_close(g1[key], g0[key], **GRAD_TOL, msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    """The port's grads against the JAX package's, both with ``use_pallas``.

    Each leaf is held to rtol 1e-3 / atol 1e-4, or to twice the JAX
    package's own change when its parameters move by 1e-7 relative (fp32
    rounding), whichever is larger: reduced internlm2-20b's embedding grads
    move by ~8e-4 under that perturbation (rmsnorm over embeddings of
    std 0.02), so no fp32 summation order can meet 1e-4 there."""
    jcfg, tcfg = _configs(arch, vocab_size=64, use_pallas=True)
    jp, tp = _params(jcfg, seed=5)
    jb, tb = _batch(2, 64, 64, seed=3)
    grad = jax.jit(jax.grad(lambda p: jax_loss_fn(jcfg, p, jb)[0]))
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    rng = np.random.default_rng(6)
    nudged = jax.tree_util.tree_unflatten(
        tdef, [x * (1 + 1e-7 * rng.normal(size=x.shape).astype(np.float32)) for x in leaves])
    jg, jg_nudged = _flatten(grad(jp)), _flatten(grad(nudged))
    tg = _port_grads(tcfg, tp, tb)
    assert sorted(tg) == sorted(jg)
    for key, ref in jg.items():
        diff = np.abs(tg[key].numpy() - ref)
        noise = 2 * np.max(np.abs(jg_nudged[key] - ref))
        bound = np.maximum(GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(ref), noise)
        assert np.all(diff <= bound), (key, float(diff.max()), noise)


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else None)


#: a few leaves of the reduced rwkv6-7b shapes, bf16 and fp32 params
_LEAVES = {"embed": ((128, 64), "bfloat16"), "decoder/blocks/0/mixer/u": ((2, 4, 16), "float32"),
           "decoder/blocks/0/mixer/tm_w1": ((2, 64, 40), "float32")}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(moment_dtype):
    """Two AdamW steps on identical grads against the reference op by op.
    lr 1e-2 with a warmup of one step, so the update is large enough to
    show (with the default warmup of 100 the first step moves a parameter by
    about 3e-6)."""
    rng = np.random.default_rng(8)
    p0 = {k: rng.normal(size=shape).astype(np.float32) for k, (shape, _) in _LEAVES.items()}
    tp = params_from_jax(p0, device="cpu")
    tp["embed"] = tp["embed"].to(torch.bfloat16)
    jp = cm.tree_map(_to_jax, tp)
    jhp, thp = JaxAdamWConfig(lr=1e-2, warmup_steps=1), AdamWConfig(lr=1e-2, warmup_steps=1)
    jstate, tstate = jax_init_opt_state(jp, moment_dtype), init_opt_state(tp, moment_dtype)
    # bf16 moments mean bf16 update arithmetic, rounded after every operation
    # as JAX does op by op: bit-equal.  (Under jit XLA fuses the chain and
    # keeps fp32 in between, which moves a param by up to one bf16 step.)
    tol = dict(rtol=1e-6, atol=1e-7) if moment_dtype == "float32" else dict(rtol=0, atol=0)
    for _ in range(2):
        g = {k: (rng.normal(size=shape) * 0.3).astype(np.float32) for k, (shape, _) in _LEAVES.items()}
        tg = params_from_jax(g, device="cpu")
        jg = cm.tree_map(_to_jax, tg)
        jp, jstate, jm = jax_apply_updates(jhp, jp, jg, jstate)
        tp, tstate, tm = apply_updates(thp, tp, tg, tstate)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        assert int(tstate.step) == int(jstate.step)
        _assert_tree_close(dict(cm.tree_leaves(tp)), _flatten(jp), **tol)
        _assert_tree_close(dict(cm.tree_leaves(tstate.mu)), _flatten(jstate.mu), **tol)
        _assert_tree_close(dict(cm.tree_leaves(tstate.nu)), _flatten(jstate.nu), **tol)
    assert tp["embed"].dtype == torch.bfloat16
    assert all(t.dtype == getattr(torch, moment_dtype) for _, t in cm.tree_leaves(tstate.mu))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_in_slices_is_exact(monkeypatch, moment_dtype):
    """The update runs leaf by leaf in slices of ``UPDATE_SLICE`` elements:
    slices of 7 (ragged last slice, several per leaf) give the same bits,
    written in place, as one slice per leaf."""
    from repro_torch.training import optimizer

    rng = np.random.default_rng(9)
    p0 = {k: rng.normal(size=shape).astype(np.float32) for k, (shape, _) in _LEAVES.items()}
    g = params_from_jax({k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                         for k, v in p0.items()}, device="cpu")
    hp = AdamWConfig(lr=1e-2, warmup_steps=1)
    out = []
    for slice_len in (1 << 24, 7):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_len)
        tp = params_from_jax(p0, device="cpu")
        state = init_opt_state(tp, moment_dtype)
        for _ in range(2):
            tp, state, _ = apply_updates(hp, tp, g, state)
        out.append([t for tree in (tp, state.mu, state.nu) for _, t in cm.tree_leaves(tree)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_steps_match_jax():
    """Two steps of ``build_train_step`` with two microbatches for the
    slice's arch: loss, grad_norm and the params after each step.  eps 1e-3
    bounds Adam's response to a grad difference (lr/eps = 10); with eps 1e-8
    a parameter whose grad is ~0 moves by ±lr on the sign of fp32 noise.
    (Reduced internlm2-20b's grads are too sensitive to fp32 rounding for a
    multi-step comparison: see ``test_grads_match_jax``.)"""
    jcfg, tcfg = _configs("rwkv6-7b", microbatches=2, use_pallas=True)
    jp, tp = _params(jcfg, seed=9)
    jstate = jax_init_train_state(jcfg)._replace(params=jp)
    jstate = jstate._replace(opt=jax_init_opt_state(jp, jcfg.moment_dtype))
    tstate = TrainState(tp, init_opt_state(tp, tcfg.moment_dtype))
    jhp, thp = (JaxAdamWConfig(lr=1e-2, warmup_steps=1, eps=1e-3),
                AdamWConfig(lr=1e-2, warmup_steps=1, eps=1e-3))
    jstep, tstep = jax.jit(jax_build_train_step(jcfg, jhp)), build_train_step(tcfg, thp)
    for s in range(2):
        jb, tb = _batch(4, 64, 128, seed=20 + s)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 5e-3
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        _assert_tree_close(dict(cm.tree_leaves(tstate.params)), _flatten(jstate.params),
                           **GRAD_TOL)


def test_synthetic_dataset_matches_reference():
    for host in range(2):
        ref = JaxDataset(256, 16, 3, seed=5, host_id=host, num_hosts=2)
        ours = SyntheticTokenDataset(256, 16, 3, seed=5, host_id=host, num_hosts=2)
        for (a, b), _ in zip(zip(iter(ref), iter(ours)), range(3)):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        assert ref.state_dict() == ours.state_dict()
    ours.load_state_dict({"step": 7, "seed": 5})
    np.testing.assert_array_equal(next(iter(ours))["tokens"],
                                  JaxDataset(256, 16, 3, seed=5, host_id=1,
                                             num_hosts=2).batch_at(7)["tokens"])


def _jax_state(jcfg, steps):
    """A JAX train state with non-zero moments."""
    state = jax_init_train_state(jcfg, seed=3)
    step = jax.jit(jax_build_train_step(jcfg, JaxAdamWConfig(lr=1e-2, warmup_steps=1)))
    for s in range(steps):
        state, _ = step(state, _batch(2, 32, jcfg.vocab_size, seed=s)[0])
    return state


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoint_from_jax_restores_into_port(tmp_path, param_dtype):
    jcfg, tcfg = _configs("rwkv6-7b", param_dtype=param_dtype, compute_dtype=param_dtype)
    jstate = _jax_state(jcfg, 1)
    JaxCheckpointManager(tmp_path).save(1, jstate, {"step": 1})
    template = init_train_state(tcfg, device="cpu")
    state, meta = CheckpointManager(tmp_path).restore(template)
    assert meta["step"] == 1 and int(state.opt.step) == 1
    from repro_torch.training.checkpoint import _flatten as port_flatten
    flat = port_flatten(state)
    for key, want in _flatten(jstate).items():
        np.testing.assert_array_equal(flat[key], np.asarray(want, np.float32)
                                      if want.dtype.kind == "V" or want.dtype.name == "bfloat16"
                                      else want, err_msg=key)
    assert state.params["embed"].dtype == getattr(torch, param_dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoint_from_port_restores_into_jax(tmp_path, param_dtype):
    jcfg, tcfg = _configs("rwkv6-7b", param_dtype=param_dtype, compute_dtype=param_dtype)
    state = init_train_state(tcfg, seed=4, device="cpu")
    state, _ = build_train_step(tcfg, AdamWConfig(lr=1e-2, warmup_steps=1))(
        state, _batch(2, 32, 128, seed=0)[1])
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, state, {"step": 1})
    mgr.wait()                          # the manager that started the write joins it
    jstate, meta = JaxCheckpointManager(tmp_path).restore(jax_init_train_state(jcfg))
    assert meta["step"] == 1 and int(jstate.opt.step) == 1
    ref = dict(cm.tree_leaves(state.params))
    for key, want in _flatten(jstate.params).items():
        assert want.dtype.name == str(ref[key].dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(np.asarray(want, np.float32),
                                      ref[key].float().numpy(), err_msg=key)


def test_launcher_trains_on_cpu_when_asked():
    state, records = launcher.main(["--arch", "rwkv6-7b", "--smoke", "--steps", "2",
                                    "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in records)
    assert int(state.opt.step) == 2


def test_launcher_resume_continues_the_run(tmp_path):
    """Three steps straight equal two steps, a checkpoint and a resumed third:
    the state and the data stream pick up where they stopped."""
    cfg = reduced(get_config("rwkv6-7b"))
    run = dict(batch_size=2, seq=32, device="cpu", log=lambda s: None)
    straight, recs = launcher.train_loop(cfg, steps=3, **run)
    launcher.train_loop(cfg, steps=2, ckpt_dir=str(tmp_path), **run)
    resumed, tail = launcher.train_loop(cfg, steps=3, ckpt_dir=str(tmp_path), resume=True,
                                        **run)
    assert [r["step"] for r in tail] == [2]
    assert tail[0]["loss"] == recs[2]["loss"]
    for (key, a), (_, b) in zip(cm.tree_leaves(straight.params), cm.tree_leaves(resumed.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=key)
    assert CheckpointManager(tmp_path).list_steps() == [2, 3]


def test_entry_points_raise_without_a_card(monkeypatch):
    """No silent switch to the CPU, unlike the reference's launcher."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "rwkv6-7b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(reduced(get_config("rwkv6-7b")))


@pytest.mark.parametrize("flags", [["--recipe", "fsdp"], ["--multi-pod"]])
def test_launcher_names_the_distributed_item(flags):
    """``--recipe`` takes the reference's six names (argparse refuses any
    other, as the reference's ``choices`` do); ``--multi-pod`` raises,
    naming ROADMAP A9.2."""
    if flags[0] == "--recipe":
        with pytest.raises(SystemExit):
            launcher.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", *flags])
        return
    with pytest.raises(NotImplementedError, match="A9.2"):
        launcher.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", *flags])


POLICIES = ["nothing", "full", "dots", "dots_no_batch"]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "internlm2-20b"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_nothing_and_jax(arch, policy):
    """Each repeated block wrapped in ``remat_policy`` (``Stack.train``, as
    the reference's ``cm.maybe_remat``): loss and grads equal to
    ``"nothing"``'s bit for bit, and within 5e-3 of the JAX package's under
    the same policy.  ``use_pallas`` routes K1 and K3 through their plain
    versions under the recompute (CPU tensors)."""
    jcfg, tcfg = _configs(arch, vocab_size=64, use_pallas=True, remat_policy=policy)
    jp, tp = _params(jcfg, seed=5)
    jb, tb = _batch(2, 64, 64, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(jcfg, p, jb)[0]))(jp)
    tg = _port_grads(tcfg, tp, tb)
    tl, _ = loss_fn(tcfg, tp, tb)
    base = dataclasses.replace(tcfg, remat_policy="nothing")
    bl, _ = loss_fn(base, tp, tb)
    bg = _port_grads(base, tp, tb)
    assert float(tl) == float(bl)
    for key, g in bg.items():
        torch.testing.assert_close(tg[key], g, rtol=0, atol=0, msg=key)
    assert abs(float(tl) - float(jl)) < 5e-3
    for key, ref in _flatten(jg).items():
        np.testing.assert_allclose(tg[key].numpy(), ref, rtol=0, atol=5e-3, err_msg=key)


def _saved_bytes(fn):
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total


def test_full_remat_saves_fewer_bytes_for_backward():
    """What autograd keeps for backward over ``loss_fn`` (counted as
    ``tests/test_torch_attention.py`` counts it): ``"full"`` keeps each
    block's inputs, not its activations.  (The selective policies keep
    their products' outputs inside the checkpoint's own store, which these
    hooks do not see.)"""
    saved = {}
    for policy in ("nothing", "full"):
        _, tcfg = _configs("internlm2-20b", vocab_size=64, remat_policy=policy)
        tp = init_train_state(tcfg, device="cpu").params
        leaves = {path: t.requires_grad_() for path, t in cm.tree_leaves(tp)}
        _, tb = _batch(2, 64, 64, seed=3)
        _, saved[policy] = _saved_bytes(lambda: loss_fn(tcfg, cm.tree_from_paths(tp, leaves),
                                                        tb)[0])
    assert saved["full"] * 5 < saved["nothing"], saved


@pytest.mark.parametrize("kernel", ["flash_attention", "rwkv6_scan"])
@pytest.mark.parametrize("policy", ["nothing", "full"])
def test_kernel_with_ref_vjp_under_remat(kernel, policy):
    """K1's and K3's autograd wrapper (``kernels/autodiff.py``) inside a
    non-reentrant recompute, with each plain version standing in for its
    kernel: the same grads as autograd through the plain version, and the
    kernel's forward run once per call, twice under ``"full"`` (the
    recompute): what ``chip_smoke.py`` counts on the card."""
    from repro_torch.kernels.autodiff import kernel_with_ref_vjp
    from repro_torch.kernels.flash_attention.ops import mha_ref
    from repro_torch.kernels.rwkv6.ops import time_mix_chunked

    rng = np.random.default_rng(7)
    if kernel == "flash_attention":
        plain = functools.partial(mha_ref, causal=True)
        shapes = [(2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)]
    else:
        plain = functools.partial(time_mix_chunked, chunk=16)
        shapes = [(1, 48, 2, 16)] * 3 + [(1, 48, 2, 16), (2, 16)]
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.5).requires_grad_()
            for s in shapes]
    if kernel == "rwkv6_scan":
        with torch.no_grad():
            args[3].copy_(-torch.exp(args[3]))           # log decays below 0
    calls = []

    def kernel_fn(*a):
        calls.append(1)
        with torch.no_grad():
            return plain(*a)

    op = kernel_with_ref_vjp(kernel_fn, plain)

    def block(*a):
        return torch.tanh(op(*[t * 1.0 for t in a]))

    w = torch.from_numpy(rng.normal(size=shapes[0]).astype(np.float32))
    out = cm.maybe_remat(block, policy)(*args)
    got = torch.autograd.grad((out * w).sum(), args)
    assert len(calls) == (2 if policy == "full" else 1)
    want = torch.autograd.grad((torch.tanh(plain(*args)) * w).sum(), args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
