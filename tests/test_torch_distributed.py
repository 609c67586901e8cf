"""PyTorch port, the dense half of the distributed layer (ROADMAP A9.1): the
sharding recipes against the reference's, and the sharded model on a 2×2
gloo mesh (4 CPU processes) against the JAX package.

The mesh runs are the reference's ``tests/test_sp_numerics.py`` on the
port, under its overrides and limits (d_model 64, 2 layers, vocab 128,
8 heads of 16, B=4, S=32; |dloss| < 2e-4, worst grad < 5e-3 relative to
the leaf's largest): the test draws the parameters and the batch in the
JAX package and computes its loss and grads (``loss_fn``, ``jax.grad``);
each case starts 4 processes on a ``file://`` rendezvous under
``tmp_path``, which carry the parameters over (``params_from_jax``) and
compute the sharded loss and grads, and rank 0 writes them (the grads
gathered whole) for the test to hold against the JAX package's.  The
processes also hold the sharded run against the single-device port on
the same parameters: loss and grads, one AdamW step on the shards (lr
1e-3), a prefill on the stepped shards (the cache and the last token's
logits, against the single-device prefill on the same parameters), and a
checkpoint of the sharded state (written by rank 0 alone, restored into
the placements on every rank).  The cases
reach each decomposition: internlm2-20b with
kv 2 (``sp_gqa_block``, K sharded with the heads), qwen2.5-32b with kv 1
(``sp_gqa_block``, each rank's heads inside the one GQA group, qkv bias)
and qwen2.5-32b with 6 heads over kv 3 (no heads decomposition: the
sequence variant of ``sp_attention``), each under ``baseline`` and under
``no_sp`` (no sequence sharding: the heads variant unfused, or the plain
path).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import ARCH_REGISTRY as JAX_ARCH_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.distributed import sharding as jsh
from repro.models import decode_cache as jax_decode_cache
from repro.models import model_specs as jax_model_specs
from repro.models.common import tree_specs as jax_tree_specs
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as tsh
from repro_torch.models import common as cm
from repro_torch.models import model_specs

ROOT = Path(__file__).resolve().parents[1]


class StubMesh:
    """What both packages' ``resolve`` read of a mesh: axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


MESHES = [StubMesh((2, 2), ("data", "model")), StubMesh((2, 4), ("data", "model")),
          StubMesh((2, 16, 16), ("pod", "data", "model"))]


def test_recipes_are_the_reference_recipes():
    assert sorted(tsh.RECIPES) == sorted(jsh.RECIPES) == [
        "baseline", "expert_data", "fsdp_pod", "no_sp", "seq_data", "tp_only"]
    for name, recipe in tsh.RECIPES.items():
        ref = jsh.RECIPES[name]
        assert (recipe.name, recipe.rules, recipe.description) == (
            ref.name, ref.rules, ref.description)
        decode = tsh.for_decode(recipe)
        assert (decode.name, decode.rules) == (jsh.for_decode(ref).name,
                                              jsh.for_decode(ref).rules)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "2x4", "2x16x16"])
@pytest.mark.parametrize("recipe", sorted(tsh.RECIPES))
def test_resolve_and_specs_match_the_reference(recipe, mesh):
    """``resolve`` of every logical axis at several sizes, ``spec_for_axes``
    of every parameter of every arch (reduced and full size),
    ``batch_sharding`` and ``cache_spec`` of every decode-cache leaf of the
    reduced archs, as the reference resolves them on the same mesh."""
    tr, jr = tsh.RECIPES[recipe], jsh.RECIPES[recipe]
    logical = sorted(set(tr.rules) | {"seq", "unknown"})
    for name in logical:
        for dim in (None, 1, 2, 3, 4, 6, 8, 16, 48, 64, 128, 512):
            used_t, used_j = {"model"} if dim == 3 else set(), {"model"} if dim == 3 else set()
            assert tr.resolve(name, mesh, used_t, dim) == jr.resolve(name, mesh, used_j, dim)
            assert used_t == used_j
    n = 0
    for arch in sorted(JAX_ARCH_REGISTRY):
        for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                           (reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))):
            tspecs = [s for _, s in cm.tree_leaves(model_specs(tcfg))]
            jspecs = list(jax_tree_specs(jax_model_specs(jcfg)))
            assert len(tspecs) == len(jspecs)
            for ts, js in zip(tspecs, jspecs):
                assert ts.axes == js.axes and ts.shape == tuple(js.shape)
                got = tsh.spec_for_axes(ts.axes, tr, mesh, ts.shape)
                assert tuple(got) == tuple(jsh.spec_for_axes(js.axes, jr, mesh, js.shape))
                n += 1
        cache = jax_decode_cache(jax_reduced(jax_get_config(arch)), 4, 32, abstract=True)
        for path, leaf in _leaves_with_names(cache):
            assert tuple(tsh.cache_spec(path, leaf.shape, tr, mesh)) == tuple(
                jsh.cache_spec(path, leaf.shape, jr, mesh))
    assert n > 500
    for shape, seq_axis in (((4, 32), None), ((4, 32), 1), ((64, 4096), 1), ((3, 5), 1)):
        got = tsh.batch_sharding(mesh, tr, 2, seq_axis=seq_axis, shape=shape).spec
        want = jsh.batch_sharding(mesh, jr, 2, seq_axis=seq_axis, shape=shape).spec
        assert tuple(got) == tuple(want)


@pytest.fixture(autouse=True)
def _spec_only_named_sharding(monkeypatch):
    """The reference's ``batch_sharding`` wraps its spec in a JAX
    ``NamedSharding``, which takes only a real mesh: read the spec through
    a stand-in."""
    class Named:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec
    monkeypatch.setattr(jsh, "NamedSharding", Named)


def _leaves_with_names(tree):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(name, leaf) for name, leaf in _leaves_with_names(v)]
        else:
            out.append((k, v))
    return out


def test_placements_follow_the_spec():
    """A spec's mesh axes become DTensor placements, one per mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES[2]
    assert tsh.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(mesh, (("data", "pod"),))


SCRIPT = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, work, arch, heads, kv = (int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
                                          sys.argv[4], int(sys.argv[5]), int(sys.argv[6]))
    dist.init_process_group("gloo", init_method=f"file://{work / 'rdv'}", rank=rank,
                            world_size=world)
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import RECIPES
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed.sp_attention import maybe_sp_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import place_state
    from repro_torch.models import build_prefill_step, loss_fn
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    from repro_torch.training import (AdamWConfig, TrainState, build_train_step,
                                      init_opt_state)
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.weights import params_from_jax

    cfg = reduced(get_config(arch), d_model=64, num_layers=2, vocab_size=128, attn_chunk=16,
                  num_heads=heads, num_kv_heads=kv, head_dim=16)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with np.load(work / "params.npz") as z:
        drawn = {k: z[k] for k in z.files}
    with np.load(work / "batch.npz") as z:
        batch = {k: torch.from_numpy(z[k]).long() for k in z.files}
    B, S = batch["tokens"].shape

    def fresh():
        params = params_from_jax(drawn, device="cpu")
        return TrainState(params, init_opt_state(params, cfg.moment_dtype))

    def grads_of(params):
        leaves = {p: t.detach().requires_grad_() for p, t in cm.tree_leaves(params)}
        loss, _ = loss_fn(cfg, cm.tree_from_paths(params, leaves), batch)
        return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def rel(a, b):
        return float((a - b).abs().max() / max(float(a.abs().max()), 1e-3))

    l_ref, g_ref = grads_of(fresh().params)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    out = {}
    for recipe in ("baseline", "no_sp"):
        with dctx.sharding_ctx(mesh, RECIPES[recipe]):
            sharded = place_state(cfg, fresh(), mesh, RECIPES[recipe])
            l_sp, g_sp = grads_of(sharded.params)
            g_whole = {p: whole(g) for p, g in g_sp.items()}
            if rank == 0:
                np.savez(work / f"sp_{recipe}.npz", loss=l_sp.detach().numpy(),
                         **{f"grad/{p}": g.numpy() for p, g in g_whole.items()})
            res = {"loss_ref": float(l_ref), "loss_sp": float(l_sp),
                   "dloss": abs(float(l_ref) - float(l_sp)),
                   "worst_grad_rel": max(rel(g_ref[p], g_whole[p]) for p in g_ref)}
            # one train step (AdamW on the shards, the global grad norm)
            sharded, m_sp = step(sharded, batch)
            cache_sp, logits_sp = build_prefill_step(cfg)(sharded.params, {"tokens": batch["tokens"]})
            lay = dctx.layout()
            k_sp = dctx.gather(dctx.gather(cache_sp["blocks"]["0"]["k"], lay.s_axes, 2),
                               lay.b_axes, 1)
            logits_sp = dctx.gather(logits_sp, lay.b_axes, 0)
            # the unfused attention (MLA's call) back in the residual layout
            gq = torch.Generator().manual_seed(1)
            q = torch.randn(B, S, heads, 16, generator=gq)
            k, v = (torch.randn(B, S, kv, 16, generator=gq) for _ in range(2))
            loc = lambda t: dctx.local_slice(dctx.local_slice(t, 0, lay.b_axes), 1, lay.s_axes)
            o_sp = maybe_sp_attention(loc(q), loc(k), loc(v), chunk=16)
            o_ref = attn.chunked_attention(q, k, v, chunk=16)
            res["unfused_attention"] = rel(loc(o_ref), o_sp)
            if recipe == "baseline":
                # the sharded state through a checkpoint: rank 0 writes, all restore
                ckpt = CheckpointManager(work / "ckpt", keep=1, async_save=True)
                ckpt.save(1, sharded, {"step": 1})
                ckpt.wait()
                restored, meta = ckpt.restore(sharded)
                pairs = list(zip(cm.tree_leaves(sharded.params) + cm.tree_leaves(sharded.opt.nu),
                                 cm.tree_leaves(restored.params) + cm.tree_leaves(restored.opt.nu)))
                res["ckpt_equal"] = all(
                    type(a) is type(b) and getattr(a, "placements", None) == getattr(
                        b, "placements", None) and torch.equal(whole(a), whole(b))
                    for (_, a), (_, b) in pairs)
                res["ckpt_files"] = sorted(p.name for p in (work / "ckpt").iterdir())
                res["ckpt_step"] = meta["step"]
        if recipe == "baseline":
            ref_state, m_ref = step(fresh(), batch)
        res["grad_norm_rel"] = abs(float(m_sp["grad_norm"]) / float(m_ref["grad_norm"]) - 1)
        new = dict(cm.tree_leaves(sharded.params))
        # the single-device prefill on the stepped shards' parameters, whole
        cache_ref, logits_ref = build_prefill_step(cfg)(
            cm.tree_from_paths(sharded.params, {p: whole(t) for p, t in new.items()}),
            {"tokens": batch["tokens"]})
        diffs = torch.cat([(t - whole(new[p])).abs().flatten()
                           for p, t in cm.tree_leaves(ref_state.params)])
        res["worst_param_abs"] = float(diffs.max())
        res["param_mismatch_share"] = float((diffs > 1e-5).float().mean())
        res["prefill_logits"] = rel(logits_ref, logits_sp)
        res["prefill_cache"] = rel(cache_ref["blocks"]["0"]["k"], k_sp)
        out[recipe] = res
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def _jax_loss_and_grads(arch, heads, kv, work):
    """The reference's draw (``init_params``, seed 3) and batch (numpy
    seed 0) under the reference test's overrides, written to ``work`` for
    the processes; returns the JAX package's loss and grads on them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import loss_fn as jax_loss_fn
    from repro.models.common import init_params as jax_init_params
    from repro.training.checkpoint import _flatten

    jcfg = jax_reduced(jax_get_config(arch), d_model=64, num_layers=2, vocab_size=128,
                       attn_chunk=16, num_heads=heads, num_kv_heads=kv, head_dim=16)
    params = jax_init_params(jax_model_specs(jcfg), seed=3)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    np.savez(work / "params.npz", **_flatten(params))
    np.savez(work / "batch.npz", **batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    return float(loss), _flatten(grads)


@pytest.mark.parametrize("arch,heads,kv", [
    ("internlm2-20b", 8, 2),      # heads: K sharded with the q heads
    ("qwen2.5-32b", 8, 1),        # heads: each rank's heads in the one GQA group
    ("qwen2.5-32b", 6, 3),        # no heads decomposition: the sequence variant
])
def test_sharded_loss_and_grads_match_one_device(tmp_path, arch, heads, kv):
    """The sharded port against the JAX package, and against the
    single-device port on the same parameters."""
    import numpy as np

    jloss, jgrads = _jax_loss_and_grads(arch, heads, kv, tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="src")
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(r), "4", str(tmp_path),
                               arch, str(heads), str(kv)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    for recipe, r in res.items():
        with np.load(tmp_path / f"sp_{recipe}.npz") as z:
            got = {k: z[k] for k in z.files}
        # the sharded port against the JAX package: the reference test's limits
        loss = float(got.pop("loss"))
        assert abs(loss - jloss) < 2e-4, (recipe, loss, jloss)
        assert sorted(got) == sorted(f"grad/{k}" for k in jgrads)
        worst = max(float(np.abs(got[f"grad/{k}"] - ref).max() / max(np.abs(ref).max(), 1e-3))
                    for k, ref in jgrads.items())
        assert worst < 5e-3, (recipe, worst)
        # and against the single-device port on the same parameters
        assert r["dloss"] < 2e-4, (recipe, r)
        assert r["worst_grad_rel"] < 5e-3, (recipe, r)
        assert r["grad_norm_rel"] < 1e-4, (recipe, r)
        # AdamW's first step moves each element by lr * m/sqrt(v), about lr
        # times the grad's sign: a grad near zero may round to either sign
        assert r["worst_param_abs"] <= 2e-3 and r["param_mismatch_share"] < 0.01, (recipe, r)
        assert r["prefill_logits"] < 1e-4 and r["prefill_cache"] < 1e-5, (recipe, r)
        assert r["unfused_attention"] < 1e-5, (recipe, r)
    assert res["baseline"]["ckpt_equal"] and res["baseline"]["ckpt_step"] == 1
    assert res["baseline"]["ckpt_files"] == ["ckpt-00000001.json", "ckpt-00000001.npz"]


@pytest.mark.parametrize("recipe", sorted(tsh.RECIPES))
def test_launcher_trains_under_each_recipe(recipe):
    """One process: the launcher places the state on a 1×1 mesh under the
    recipe's context, and its losses equal the single-device loop's."""
    from repro_torch.launch import train as launcher

    _, records = launcher.main(["--arch", "internlm2-20b", "--smoke", "--steps", "2",
                                "--batch", "2", "--seq", "32", "--device", "cpu",
                                "--recipe", recipe])
    _, plain = launcher.train_loop(reduced(get_config("internlm2-20b")), steps=2,
                                   batch_size=2, seq=32, device="cpu", log=lambda s: None)
    assert [r["loss"] for r in records] == pytest.approx([r["loss"] for r in plain],
                                                         abs=2e-4)


def test_launcher_resumes_a_sharded_run(tmp_path):
    """A checkpoint of a run under a recipe's context restores into it: two
    steps and a resumed third equal three steps.  (The 1×1 mesh keeps the
    state whole; a state placed on a 2×2 mesh goes through a checkpoint in
    ``test_sharded_loss_and_grads_match_one_device``.)"""
    from repro_torch.launch import train as launcher

    args = ["--arch", "internlm2-20b", "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--recipe", "tp_only"]
    _, whole = launcher.main(args + ["--steps", "3"])
    launcher.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    _, resumed = launcher.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                                       "--resume"])
    assert [r["step"] for r in resumed] == [2]
    assert resumed[0]["loss"] == pytest.approx(whole[2]["loss"], abs=1e-6)
