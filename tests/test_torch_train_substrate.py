"""PyTorch port, training substrate: ``repro_torch.substrates.GpuNodeSubstrate``
and ``repro_torch.training.FleetRunner`` on a ``repro`` control plane, against
the reference's ``TpuPodSubstrate`` and ``FleetRunner``.

The reference's fleet and system tests (``tests/test_training.py``,
``tests/test_system.py``) run here with the port's runner and substrates on
a ``repro`` ``Orchestrator``, on the CPU at the reduced fp32 configs; then a
plane that holds one JAX slice and one port slice, where the port slice
resumes the JAX slice's shared checkpoint, and the losses of the two
substrates from the same parameters (JAX ``init_params`` →
``params_from_jax``), within the suite's 5e-3 per invoke."""
import os
import types

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import Orchestrator
from repro.core.tasks import TaskRequest as JaxTaskRequest
from repro.models import model_specs as jax_model_specs
from repro.models.common import init_params as jax_init_params
from repro.substrates.tpu_pod import TpuPodSubstrate
from repro.training.checkpoint import _flatten
from repro_torch.core.tasks import TaskRequest
from repro_torch.core.twin import TwinNotReady
from repro_torch.substrates import GpuNodeSubstrate, load_dryrun_record
from repro_torch.substrates.gpu_node import DRYRUN_DIR, STRAGGLER_FACTOR
from repro_torch.training import FleetRunner
from repro_torch.weights import params_from_jax


def _slice(arch, **kw):
    return GpuNodeSubstrate(arch, batch=2, seq=16, device="cpu", **kw)


def _session(steps, **payload):
    return types.SimpleNamespace(task=TaskRequest(
        function="train_step", input_modality="tensor_shards",
        output_modality="tensor_shards", payload=dict(steps=steps, **payload)))


def test_fleet_straggler_mitigation_and_checkpoint_fallback(tmp_path):
    fr = FleetRunner(Orchestrator())
    a = _slice("internlm2-20b", recipe="baseline", ckpt_dir=os.path.join(tmp_path, "a"))
    b = _slice("internlm2-20b", recipe="tp_only", ckpt_dir=os.path.join(tmp_path, "b"))
    fr.add_slice(a)
    fr.add_slice(b)
    rep = fr.train(quanta=2, steps_per_quantum=2)
    assert sum(rep.placements.values()) == 2
    primary = max(rep.placements, key=rep.placements.get)
    # straggler: slow the primary; placement must move away.  The reference
    # stalls 0.6 s, about a hundred of its jitted CPU steps; the port's eager
    # step is slower, and slower still on a loaded host, so the stall is at
    # least ten of this slice's median steps
    stall_s = max(0.6, 10 * float(np.median(fr.slices[primary]._step_times)) / 1e3)
    fr.slices[primary].inject_straggler(stall_s)
    rep2 = fr.train(quanta=2, steps_per_quantum=2)
    others = {k: v for k, v in rep2.placements.items() if k != primary}
    assert sum(others.values()) >= 1, rep2.placements
    # hard failure: primary cannot prepare; fallback completes the work
    fr.slices[primary].inject_fault("prepare_failure")
    rep3 = fr.train(quanta=1, steps_per_quantum=1, preferred=primary)
    assert rep3.placements, rep3.quanta
    assert all(k != primary for k in rep3.placements)


def test_elastic_scaling_with_shared_checkpoint(tmp_path):
    """A slice added mid-run resumes the shared job from the latest
    checkpoint instead of step 0 (elastic scale-out), and the job survives
    losing its original slice entirely (scale-in/failure)."""
    shared = os.path.join(tmp_path, "shared")
    fr = FleetRunner(Orchestrator())
    a = _slice("rwkv6-7b", recipe="baseline", ckpt_dir=shared)
    fr.add_slice(a)
    fr.train(quanta=2, steps_per_quantum=2, shared_job=True)
    assert a._step == 4
    # scale out: slice B joins, sharing the checkpoint directory
    b = _slice("rwkv6-7b", recipe="tp_only", ckpt_dir=shared)
    fr.add_slice(b)
    # scale in: slice A dies
    a.inject_fault("prepare_failure")
    rep2 = fr.train(quanta=1, steps_per_quantum=1, shared_job=True)
    assert list(rep2.placements) == [b.resource_id], rep2.placements
    # B resumed from the shared step-4 checkpoint, not from scratch
    assert b._step == 5, b._step


def test_gpu_fleet_joins_the_same_control_plane(orchestrator):
    """``tests/test_system.py::test_tpu_fleet_joins_the_same_control_plane``
    with the port's slice, submitted the port's task."""
    sub = _slice("rwkv6-7b")
    orchestrator.register(sub)
    res, _ = orchestrator.submit(TaskRequest(
        function="train_step", input_modality="tensor_shards",
        output_modality="tensor_shards", payload={"steps": 1},
        required_telemetry=("loss", "step_ms")))
    assert res.status == "completed"
    assert res.resource_id == sub.resource_id
    assert np.isfinite(res.telemetry["loss"])
    twin = orchestrator.twins.get(sub.resource_id)
    assert twin.kind == "roofline"


def test_port_slice_resumes_a_jax_slices_shared_checkpoint(tmp_path):
    """One JAX slice and one port slice on one plane and one checkpoint
    directory: the JAX slice trains the job to step 4 and dies; the port
    slice takes over from its checkpoint."""
    shared = os.path.join(tmp_path, "shared")
    fr = FleetRunner(Orchestrator())
    a = TpuPodSubstrate("rwkv6-7b", recipe="baseline", ckpt_dir=shared, batch=2, seq=16)
    fr.add_slice(a)
    fr.train(quanta=2, steps_per_quantum=2, shared_job=True)
    assert a._step == 4
    b = _slice("rwkv6-7b", recipe="tp_only", ckpt_dir=shared)
    fr.add_slice(b)
    a.inject_fault("prepare_failure")
    rep = fr.train(quanta=1, steps_per_quantum=1, shared_job=True)
    assert list(rep.placements) == [b.resource_id], rep.placements
    assert b._step == 5, b._step
    # the JAX optimizer's count (its warm-up update and four steps), plus one
    assert int(b._state.opt.step) == 6
    assert np.isfinite(rep.losses).all()


def test_losses_match_jax_substrate_from_the_same_parameters():
    """Warm-up in ``prepare`` (one update that does not count as a step),
    then three invokes of two steps: each invoke's loss within 5e-3 of the
    reference substrate's, and the same step count."""
    jax_sub = TpuPodSubstrate("rwkv6-7b", batch=2, seq=16)
    jcfg = jax_reduced(jax_get_config("rwkv6-7b"))
    flat = _flatten(jax_init_params(jax_model_specs(jcfg), 0))   # the reference's own draw
    port = _slice("rwkv6-7b", params=params_from_jax(flat, device="cpu"))
    for sub in (jax_sub, port):
        sub.prepare(None)
    assert port._step == jax_sub._step == 0
    assert int(port._state.opt.step) == 1
    for _ in range(3):
        session = types.SimpleNamespace(task=JaxTaskRequest(
            function="train_step", input_modality="tensor_shards",
            output_modality="tensor_shards", payload={"steps": 2}))
        ref, got = jax_sub.invoke(session), port.invoke(session)
        assert got["output"]["step"] == ref["output"]["step"]
        assert abs(got["output"]["loss"] - ref["output"]["loss"]) < 5e-3
        assert abs(got["telemetry"]["grad_norm"] - ref["telemetry"]["grad_norm"]) < 5e-3 * max(
            1.0, ref["telemetry"]["grad_norm"])
    assert port._step == 6


def test_descriptor_matches_reference():
    port = _slice("rwkv6-7b").descriptor().to_dict()
    ref = TpuPodSubstrate("rwkv6-7b", batch=2, seq=16).descriptor().to_dict()
    assert port["resource_id"] == "gpu-rwkv6-7b-h100x1-baseline"
    assert port["substrate_class"] == "gpu_node" and ref["substrate_class"] == "tpu_pod"
    assert port["description"] == "rwkv6-7b on h100x1 mesh, recipe=baseline (fits=n/a)"
    for key in ("resource_id", "twin_binding", "description", "substrate_class"):
        port.pop(key)
        ref.pop(key)
    assert port == ref


def test_no_dryrun_record_so_the_twin_waits_for_a_step():
    assert not DRYRUN_DIR.exists()
    assert load_dryrun_record("rwkv6-7b", mesh="h100x1") is None
    sub = _slice("rwkv6-7b", steps_per_invoke=2)
    twin = sub.make_twin()
    assert twin.kind == "roofline" and twin.model == {}
    with pytest.raises(TwinNotReady):
        twin.surrogate.simulate(_session(2).task)
    sub.prepare(None)
    raw = sub.invoke(_session(2))
    twin.surrogate.observe(_session(2).task, raw)
    sim = twin.surrogate.simulate(_session(2).task)
    assert sim["output"]["step"] == raw["output"]["step"] + 2
    assert sim["telemetry"]["step_ms"] == pytest.approx(raw["telemetry"]["step_ms"], abs=1e-3)
    assert twin.surrogate.divergence(raw["output"], raw["output"]) == 0.0
    assert twin.surrogate.tolerance == 0.5


def test_straggler_degrades_and_restore_clears_it(tmp_path):
    """Telemetry and ``snapshot()`` read DEGRADED past ``STRAGGLER_FACTOR``
    × the median step; ``reset("restore_checkpoint")`` puts the step back
    to the saved one and clears the slowdown."""
    sub = _slice("rwkv6-7b", ckpt_dir=str(tmp_path))
    sub.prepare(None)
    assert sub.snapshot().health_status == "healthy"
    sub.invoke(_session(2))
    for _ in range(2):
        sub.invoke(_session(2, checkpoint=False))
    assert sub._step == 6 and sub._ckpt.list_steps() == [2]
    med = float(np.median(sub._step_times))
    sub.inject_straggler(4 * med / 1e3)
    slow = sub.invoke(_session(2, checkpoint=False))
    assert slow["telemetry"]["health_status"] == "degraded"
    assert slow["telemetry"]["step_ms"] > STRAGGLER_FACTOR * med
    assert sub.snapshot().health_status == "degraded"
    sub.reset("restore_checkpoint")
    assert sub._step == 2 and sub._injected_slowdown == 0.0
    assert sub.snapshot().health_status == "healthy"
    again = sub.invoke(_session(2, checkpoint=False))
    assert again["telemetry"]["health_status"] == "healthy"
    assert again["output"]["step"] == 4
    # a fresh slice resuming the step-2 checkpoint steps to the same loss
    other = _slice("rwkv6-7b", ckpt_dir=str(tmp_path), recipe="tp_only")
    other.prepare(None)
    resumed = other.invoke(_session(2, resume=True, checkpoint=False))
    assert resumed["output"]["step"] == 4
    assert resumed["output"]["loss"] == again["output"]["loss"]


def test_entry_points_raise_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GpuNodeSubstrate("rwkv6-7b")


def test_runner_needs_an_orchestrator():
    with pytest.raises(TypeError):
        FleetRunner()


def test_task_request_matches_reference():
    """The port's copy of ``TaskRequest``: the reference's fields and
    defaults in order, the same wire and summary forms, a wire round trip
    that keeps the id, a clone with its own metadata, and ids that do not
    collide with the reference's."""
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(TaskRequest)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxTaskRequest)])
    kw = dict(function="train_step", input_modality="tensor_shards",
              output_modality="tensor_shards", payload={"steps": 2},
              required_telemetry=("loss",), route=("a",), metadata={"k": 1}, task_id="t-1")
    port, ref = TaskRequest(**kw), JaxTaskRequest(**kw)
    assert port.to_wire() == ref.to_wire()
    assert port.summary() == ref.summary() == port.to_dict()
    assert TaskRequest.from_wire(dict(ref.to_wire(), unknown=1)) == port
    clone = port.clone(backend_preference="x")
    assert clone.task_id == "t-1" and clone.metadata == port.metadata
    assert clone.metadata is not port.metadata
    ids = {TaskRequest("f", "a", "b").task_id, JaxTaskRequest("f", "a", "b").task_id}
    assert len(ids) == 2
