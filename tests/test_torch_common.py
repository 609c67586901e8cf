"""PyTorch port, shared numerics and package rules: each function of
``repro_torch.models.common`` (and the whisper position embedding) against
its JAX original on the same numpy inputs, the parameter tree against the
JAX one, and the port's import and device rules."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import common as jcm
from repro.models import model_specs as jax_model_specs
from repro.models.model import _sinusoid as jax_sinusoid
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import common as cm
from repro_torch.models import model_specs
from repro_torch.models.model import _sinusoid
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6
ARCHS = ["whisper-large-v3", "internlm2-20b"]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_rmsnorm_matches_jax():
    x = _rng(0).normal(size=(2, 5, 64)).astype(np.float32)
    w = _rng(1).normal(size=(64,)).astype(np.float32) * 0.1
    _close(cm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jcm.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_jax(with_bias):
    x = (_rng(2).normal(size=(3, 4, 64)) * 3 + 1).astype(np.float32)
    w = _rng(3).normal(size=(64,)).astype(np.float32) * 0.1
    b = _rng(4).normal(size=(64,)).astype(np.float32) if with_bias else None
    _close(cm.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b)),
           jcm.layernorm(jnp.asarray(x), jnp.asarray(w),
                         None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_norm_matches_jax(arch):
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    x = _rng(5).normal(size=(2, 3, 64)).astype(np.float32)
    p = {"scale": _rng(6).normal(size=(64,)).astype(np.float32) * 0.1,
         "bias": _rng(7).normal(size=(64,)).astype(np.float32)}
    if tcfg.norm != "layernorm":
        del p["bias"]
    _close(cm.apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)),
           jcm.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("shape,pos_shape,rotary_dim", [
    ((2, 7, 4, 16), (7,), None),         # shared timeline
    ((2, 7, 4, 16), (2, 7), None),       # per-row timelines (continuous batching)
    ((2, 7, 4, 16), (7,), 8),            # partial rotary dim
    ((2, 7, 16), (7,), None),            # (B, S, hd) input
])
def test_rope_matches_jax(shape, pos_shape, rotary_dim):
    x = _rng(8).normal(size=shape).astype(np.float32)
    pos = _rng(9).integers(0, 48, size=pos_shape).astype(np.int32)
    _close(cm.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, rotary_dim),
           jcm.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rotary_dim))


@pytest.mark.parametrize("name", sorted(cm.ACTIVATIONS))
def test_activations_match_jax(name):
    assert set(cm.ACTIVATIONS) == set(jcm.ACTIVATIONS)
    x = (_rng(10).normal(size=(4, 33)) * 3).astype(np.float32)
    _close(cm.ACTIVATIONS[name](torch.from_numpy(x)), jcm.ACTIVATIONS[name](jnp.asarray(x)))


@pytest.mark.parametrize("positions", [np.arange(17), np.array([3, 40, 0, 9, 447])])
def test_sinusoid_matches_jax(positions):
    # sin/cos of angles up to a few hundred radians differ by a few ulp
    # between the two libraries: 1e-6 per radian of the largest angle
    _close(_sinusoid(torch.from_numpy(positions), 64),
           jax_sinusoid(jnp.asarray(positions), 64), atol=1e-6 * max(1, positions.max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Same leaf paths, shapes and dtypes as the JAX spec tree, and the JAX
    params load through params_from_jax onto that tree."""
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jspecs = {path: (s.shape, jnp.dtype(s.dtype).name)
              for path, s in _flatten_specs(jax_model_specs(jcfg)).items()}
    tparams = cm.init_params(model_specs(tcfg), seed=0, device="cpu")
    tleaves = dict(cm.tree_leaves(tparams))
    assert set(tleaves) == set(jspecs)
    for path, t in tleaves.items():
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == jspecs[path], path
    jparams = jcm.init_params(jax_model_specs(jcfg), seed=1)
    loaded = dict(cm.tree_leaves(params_from_jax(_flatten(jparams), device="cpu")))
    for path, arr in _flatten(jparams).items():
        np.testing.assert_array_equal(loaded[path].numpy(), arr)
        assert loaded[path].numpy().flags.writeable


def _flatten_specs(specs):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs, is_leaf=jcm.is_spec)[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def test_init_params_distributions():
    specs = {"w": cm.ParamSpec((256, 512), ("embed", "mlp"), torch.float32),
             "e": cm.ParamSpec((512, 64), ("vocab", "embed"), torch.float32, "small"),
             "z": cm.ParamSpec((64,), ("embed",), torch.float32, "zeros")}
    p = cm.init_params(specs, seed=3, device="cpu")
    assert abs(p["w"].std().item() - 1 / 16) < 2e-3          # 1/sqrt(fan_in)
    assert abs(p["e"].std().item() - 0.02) < 1e-3
    assert torch.count_nonzero(p["z"]) == 0
    again = cm.init_params(specs, seed=3, device="cpu")
    assert torch.equal(p["w"], again["w"])                   # seeded


def test_init_params_draws_a_leaf_past_the_limit_in_slices(monkeypatch):
    """A leaf of more than ``_MAX_DRAW`` elements is drawn slice by slice
    along its leading axis, with the same distribution and seeding; a leaf
    within it is drawn whole, as before."""
    specs = {"w": cm.ParamSpec((8, 256, 512), ("layers", "embed", "mlp"), torch.bfloat16),
             "v": cm.ParamSpec((64, 32), ("embed", "mlp"), torch.float32)}
    whole = cm.init_params(specs, seed=4, device="cpu")
    assert abs(whole["w"].float().std().item() - 1 / 16) < 2e-3
    monkeypatch.setattr(cm, "_MAX_DRAW", 256 * 512)
    sliced = cm.init_params(specs, seed=4, device="cpu")
    assert sliced["w"].dtype == torch.bfloat16 and sliced["w"].shape == (8, 256, 512)
    assert abs(sliced["w"].float().std().item() - 1 / 16) < 2e-3
    assert torch.equal(sliced["w"], cm.init_params(specs, seed=4, device="cpu")["w"])
    assert torch.equal(sliced["v"], whole["v"])


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.init_params(model_specs(reduced(get_config("internlm2-20b"))), seed=0)
    assert cm.resolve_device("cpu") == torch.device("cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
