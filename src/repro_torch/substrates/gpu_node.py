"""GPU-node training substrate — the port of ``repro/substrates/tpu_pod.py``.

A registered resource is an (architecture × device geometry × sharding
recipe) tuple training on one card through the port's train step.  Its
capability descriptor is the reference's, with ``substrate_class =
"gpu_node"`` and the resource id ``gpu-{arch}-{mesh_tag}-{recipe}``:

- twin confidence     — decays when measured step telemetry diverges from
                        the twin's prediction (drift),
- lifecycle           — warm-up = the first step, checkpoint-restore = reset,
- timing contract     — the dry-run record's step-time lower bound × slack,
- telemetry contract  — loss / grad-norm / tokens-per-second / step-time.

``invoke`` runs real train steps of the configured model on the device.  A
step is timed after the device has finished it, so ``step_ms``, the drift
and the straggler verdict read device work, not the host's enqueue.
Step-time regression beyond ``STRAGGLER_FACTOR`` × the median marks the
substrate DEGRADED, which the matcher sees: drift-aware placement applied
to a fleet of cards.

``load_dryrun_record`` reads the reference's dry-run records
(``benchmarks/results/dryrun/<arch>__<shape>__<mesh>__<recipe>.json``);
with none there, the twin answers only once it has observed a step
(:class:`RooflineSurrogate` raises ``TwinNotReady`` until then).

Keywords beyond the reference's (each a deliberate difference):

- ``cfg`` — the configuration to train (default ``reduced(get_config(arch))``,
  as in the reference);
- ``params`` — parameters to start from (default: drawn from seed 0, as the
  reference's ``init_train_state``), e.g. a JAX draw carried in by
  ``repro_torch.weights.params_from_jax``; they are copied, since the
  port's step updates its state in place;
- ``device`` — the card unless ``"cpu"`` is asked for.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.descriptors import (CapabilityDescriptor, LifecycleSemantics,
                                          Observability, PolicyConstraints,
                                          ResourceDescriptor, SignalSpec,
                                          TimingSemantics)
from repro_torch.core.telemetry import RuntimeSnapshot
from repro_torch.core.twin import TwinNotReady, TwinState, TwinSurrogate
from repro_torch.models.common import resolve_device, tree_map
from repro_torch.substrates.base import SubstrateAdapter
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenDataset
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainState, build_train_step, init_train_state

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / "dryrun"

STRAGGLER_FACTOR = 2.0       # step slower than 2x median => degraded


def load_dryrun_record(arch: str, shape: str = "train_4k",
                       mesh: str = "pod256", recipe: str = "baseline"
                       ) -> Optional[Dict]:
    p = DRYRUN_DIR / f"{arch}__{shape}__{mesh}__{recipe}.json"
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return rec if rec.get("status") == "ok" else None


class RooflineSurrogate(TwinSurrogate):
    """Executable roofline twin: the dry-run record's cost model plus the
    last observed training metrics.  Step time is predicted from the median
    of observed steps (falling back to the record's lower bound), so the
    twin tightens as real telemetry arrives."""

    kind = "roofline"
    tolerance = 0.5

    def __init__(self, roofline: Optional[Dict], *, steps_per_invoke: int,
                 batch: int, seq: int):
        self.roofline = dict(roofline or {})
        self.steps_per_invoke = steps_per_invoke
        self.batch, self.seq = batch, seq
        self._step_ms: list = []
        self._last: Dict = {}

    def observe(self, task, raw: Dict) -> None:
        tele = raw.get("telemetry") or {}
        out = raw.get("output") or {}
        if "step_ms" in tele:
            self._step_ms.append(float(tele["step_ms"]))
            del self._step_ms[:-32]
        self._last = {"step": out.get("step"), "loss": out.get("loss"),
                      "grad_norm": tele.get("grad_norm")}

    def simulate(self, task) -> Dict:
        payload = task.payload if isinstance(task.payload, dict) else {}
        n_steps = int(payload.get("steps", self.steps_per_invoke))
        if self._step_ms:
            step_ms = float(np.median(self._step_ms))
        elif self.roofline.get("step_time_lb_s"):
            step_ms = float(self.roofline["step_time_lb_s"]) * 1e3
        else:
            raise TwinNotReady("roofline twin has neither a dry-run record "
                               "nor observed step telemetry")
        last_step = int(self._last.get("step") or 0)
        loss = self._last.get("loss")
        loss = float(loss) if loss is not None else float("nan")
        grad_norm = self._last.get("grad_norm")
        grad_norm = float(grad_norm) if grad_norm is not None \
            else float("nan")
        tokens_per_s = self.batch * self.seq / max(step_ms / 1e3, 1e-9)
        return {
            "output": {"step": last_step + n_steps, "loss": loss},
            "telemetry": {
                "loss": loss,
                "grad_norm": grad_norm,
                "tokens_per_s": round(tokens_per_s, 1),
                "step_ms": round(step_ms, 3),
                "drift_score": 0.0,
                "health_status": "healthy",
                "observation_ms": step_ms * n_steps,
            },
            "artifacts": {"roofline_twin": dict(self.roofline) or None},
            "backend_ms": 0.0,
        }

    def divergence(self, real_output, twin_output) -> float:
        r = real_output if isinstance(real_output, dict) else {}
        t = twin_output if isinstance(twin_output, dict) else {}
        s_real, s_twin = r.get("step"), t.get("step")
        if s_real is None or s_twin is None:
            step_err = 1.0
        else:
            step_err = min(1.0, abs(int(s_real) - int(s_twin))
                           / max(abs(int(s_real)), 1))
        l_real, l_twin = r.get("loss"), t.get("loss")
        try:
            l_real, l_twin = float(l_real), float(l_twin)
            if np.isnan(l_real) and np.isnan(l_twin):
                loss_err = 0.0
            elif np.isnan(l_real) or np.isnan(l_twin):
                loss_err = 1.0
            else:
                loss_err = min(1.0, abs(l_real - l_twin)
                               / max(abs(l_real), abs(l_twin), 1e-6))
        except (TypeError, ValueError):
            loss_err = 1.0
        return float(0.5 * step_err + 0.5 * loss_err)


class GpuNodeSubstrate(SubstrateAdapter):
    def __init__(self, arch: str, *, cfg=None, params=None, device=None,
                 shape: str = "train_4k", mesh_tag: str = "h100x1",
                 recipe: str = "baseline", steps_per_invoke: int = 3,
                 batch: int = 4, seq: int = 64,
                 ckpt_dir: Optional[str] = None, seed: int = 0):
        super().__init__()
        self.arch = arch
        self.shape = shape
        self.mesh_tag = mesh_tag
        self.recipe = recipe
        self.resource_id = f"gpu-{arch}-{mesh_tag}-{recipe}"
        self.record = load_dryrun_record(arch, shape, mesh_tag, recipe)
        self.steps_per_invoke = steps_per_invoke
        self.cfg = cfg if cfg is not None else reduced(get_config(arch))
        self.device = resolve_device(device)
        self._params = params
        self.batch, self.seq = batch, seq
        self._state: Optional[TrainState] = None
        self._step_fn = None
        self._data = SyntheticTokenDataset(self.cfg.vocab_size, seq, batch,
                                           seed=seed)
        self._step = 0
        self._step_times: list = []
        self._compiled = False
        self._ckpt = (CheckpointManager(ckpt_dir, keep=2)
                      if ckpt_dir is not None else None)
        self._injected_slowdown = 0.0

    # -- descriptor -----------------------------------------------------------
    def descriptor(self) -> ResourceDescriptor:
        rec = self.record or {}
        roof = rec.get("roofline", {})
        step_lb_ms = roof.get("step_time_lb_s", 0.1) * 1e3
        mem = rec.get("memory", {})
        cap = CapabilityDescriptor(
            functions=("train", "train_step"),
            input_signal=SignalSpec("tensor_shards", "int32_tokens",
                                    (0.0, float(self.cfg.vocab_size))),
            output_signal=SignalSpec("tensor_shards", "metrics", (0.0, 1e9)),
            timing=TimingSemantics(
                "fast_ms", expected_latency_ms=max(step_lb_ms, 1.0),
                observation_window_ms=step_lb_ms * self.steps_per_invoke,
                freshness_ms=600_000.0),
            lifecycle=LifecycleSemantics(
                warmup_ms=float(rec.get("compile_seconds", 10.0)) * 1e3,
                resetable=True,
                reset_modes=("restore_checkpoint", "rescale"),
                reset_cost_ms=2_000.0,
                recovery_modes=("restore_checkpoint",)),
            programmability="configurable",
            observability=Observability(
                output_channels=("metrics",),
                telemetry_fields=("loss", "grad_norm", "tokens_per_s",
                                  "step_ms", "drift_score"),
                drift_indicators=("drift_score", "step_ms"),
                twin_linked_fields=("step_ms", "drift_score")),
            policy=PolicyConstraints(exclusive=True, max_concurrent=1),
            supports_repeated_invocation=True,
        )
        return ResourceDescriptor(
            resource_id=self.resource_id, substrate_class="gpu_node",
            adapter_type="in_process", location="cloud",
            twin_binding=f"twin-{self.resource_id}", capability=cap,
            description=f"{self.arch} on {rec.get('mesh', self.mesh_tag)} "
                        f"mesh, recipe={self.recipe} "
                        f"(fits={mem.get('fits', 'n/a')})")

    # -- data plane -------------------------------------------------------------
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in self._data.batch_at(step).items()}

    def _run_step(self, batch) -> Dict[str, float]:
        """One train step; returns its metrics once the device has finished."""
        self._state, metrics = self._step_fn(self._state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return metrics

    def prepare(self, session) -> None:
        self._check_prepare_fault()
        if not self._compiled:
            t0 = time.perf_counter()
            if self._params is None:
                self._state = init_train_state(self.cfg, device=self.device)
            else:
                params = tree_map(lambda t: t.to(self.device, copy=True), self._params)
                self._state = TrainState(params, init_opt_state(params, self.cfg.moment_dtype))
                self._params = None
            self._step_fn = build_train_step(self.cfg)
            # warm-up = the first step (lifecycle cost, visible in telemetry):
            # it updates the state but not the step count, as the reference's
            self._run_step(self._batch(0))
            self._compile_ms = (time.perf_counter() - t0) * 1e3
            self._compiled = True

    def invoke(self, session) -> Dict:
        payload = session.task.payload or {}
        # elastic/shared-job mode: if the shared checkpoint directory has a
        # newer step than this slice (another slice advanced the job, or
        # this slice just joined), resume from it before training
        if payload.get("resume") and self._ckpt is not None:
            latest = self._ckpt.latest_step()
            if latest is not None and latest > self._step \
                    and self._state is not None:
                self._state, _ = self._ckpt.restore(self._state, latest)
                self._step = latest
        n_steps = int(payload.get("steps", self.steps_per_invoke))
        t0 = time.perf_counter()
        metrics = {}
        for _ in range(n_steps):
            batch = self._batch(self._step)
            ts = time.perf_counter()
            metrics = self._run_step(batch)
            if self._injected_slowdown:
                time.sleep(self._injected_slowdown)  # fault injection: a real stall
            self._step_times.append((time.perf_counter() - ts) * 1e3)
            self._step += 1
        backend_ms = (time.perf_counter() - t0) * 1e3
        step_ms = float(np.mean(self._step_times[-n_steps:]))
        med = float(np.median(self._step_times)) if self._step_times else step_ms
        drift = max(0.0, min(1.0, step_ms / max(med, 1e-9) / STRAGGLER_FACTOR
                             - 0.5))
        tokens_per_s = self.batch * self.seq / max(step_ms / 1e3, 1e-9)
        if self._ckpt is not None and payload.get("checkpoint", True):
            self._ckpt.save(self._step, self._state,
                            {"loss": metrics.get("loss", float("nan"))})
        telemetry = self._apply_telemetry_faults({
            "loss": metrics.get("loss", float("nan")),
            "grad_norm": metrics.get("grad_norm", float("nan")),
            "tokens_per_s": round(tokens_per_s, 1),
            "step_ms": round(step_ms, 3),
            "drift_score": round(drift, 4),
            "health_status": "degraded" if drift > 0.5 else "healthy",
            "observation_ms": backend_ms,
        })
        return {
            "output": {"step": self._step,
                       "loss": metrics.get("loss", float("nan"))},
            "telemetry": telemetry,
            "artifacts": {"roofline_twin": (self.record or {}).get("roofline"),
                          "checkpoint_step": (self._ckpt.latest_step()
                                              if self._ckpt else None)},
            "backend_ms": backend_ms,
            "needs_reset": False,
        }

    def reset(self, mode: str = "restore_checkpoint") -> None:
        if mode == "restore_checkpoint" and self._ckpt is not None \
                and self._state is not None:
            step = self._ckpt.latest_step()
            if step is not None:
                self._state, _ = self._ckpt.restore(self._state, step)
                self._step = step
        self._injected_slowdown = 0.0
        self._step_times.clear()

    # fault hooks used by the fleet tests ------------------------------------
    def inject_straggler(self, seconds: float) -> None:
        self._injected_slowdown = seconds

    def snapshot(self) -> Optional[RuntimeSnapshot]:
        if not self._step_times:
            return RuntimeSnapshot(self.resource_id)
        med = float(np.median(self._step_times))
        last = self._step_times[-1]
        drift = max(0.0, min(1.0, last / max(med, 1e-9) / STRAGGLER_FACTOR - 0.5))
        return RuntimeSnapshot(
            self.resource_id,
            health_status="degraded" if drift > 0.5 else "healthy",
            drift_score=round(drift, 4))

    def make_twin(self) -> Optional[TwinState]:
        roof = (self.record or {}).get("roofline", {})
        return TwinState(f"twin-{self.resource_id}", self.resource_id,
                         kind="roofline", model=dict(roof),
                         surrogate=RooflineSurrogate(
                             roof, steps_per_invoke=self.steps_per_invoke,
                             batch=self.batch, seq=self.seq))
