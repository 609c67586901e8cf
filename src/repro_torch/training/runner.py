"""Fault-tolerant orchestrated training — the port of
``repro/training/runner.py``: a control plane driving a fleet of cards.

The runner expresses a training job as a stream of ``train_step`` tasks
submitted through a control plane over registered
:class:`~repro_torch.substrates.gpu_node.GpuNodeSubstrate` slices:

- the matcher places each work quantum using roofline twins + live telemetry,
- step-time regression (straggler) degrades a slice's snapshot → the matcher
  routes subsequent quanta elsewhere (straggler mitigation),
- invocation/postcondition failures trigger checkpoint-restore fallback on a
  healthy slice (elastic recovery),
- every quantum checkpoints, so the job survives slice loss.

The port imports nothing of the control plane, so the orchestrator is a
required argument (the reference builds its own ``Orchestrator()`` when
given none).  Any plane with ``register(adapter)`` and ``submit(task) ->
(result, trace)`` serves, a ``repro`` ``Orchestrator`` included; the tasks
are the port's copy of ``TaskRequest``, which such a plane takes
duck-typed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.core.tasks import TaskRequest


@dataclasses.dataclass
class FleetReport:
    quanta: List[Dict]
    total_steps: int
    fallbacks: int
    placements: Dict[str, int]
    losses: List[float]
    wall_s: float


class FleetRunner:
    def __init__(self, orchestrator):
        self.orch = orchestrator
        self.slices: Dict[str, object] = {}

    def add_slice(self, substrate) -> None:
        self.orch.register(substrate)
        self.slices[substrate.resource_id] = substrate

    def train(self, *, quanta: int = 6, steps_per_quantum: int = 2,
              preferred: Optional[str] = None,
              shared_job: bool = False) -> FleetReport:
        """``shared_job=True`` makes every quantum resume from the latest
        shared checkpoint, so the logical job survives slice loss AND new
        slices joining mid-run (elastic scaling)."""
        t0 = time.time()
        records: List[Dict] = []
        placements: Dict[str, int] = {}
        losses: List[float] = []
        fallbacks = 0
        for q in range(quanta):
            task = TaskRequest(
                function="train_step",
                input_modality="tensor_shards",
                output_modality="tensor_shards",
                payload={"steps": steps_per_quantum,
                         "resume": shared_job},
                required_telemetry=("loss", "step_ms"),
                backend_preference=preferred,
                repeated=True,
            )
            result, trace = self.orch.submit(task)
            rec = {
                "quantum": q,
                "status": result.status,
                "resource": result.resource_id or None,
                "fallback": trace.fallback_used,
                "loss": result.telemetry.get("loss"),
                "step_ms": result.telemetry.get("step_ms"),
                "drift": result.telemetry.get("drift_score"),
            }
            records.append(rec)
            if result.status == "completed":
                placements[result.resource_id] = placements.get(
                    result.resource_id, 0) + 1
                if rec["loss"] is not None:
                    losses.append(float(rec["loss"]))
                if trace.fallback_used:
                    fallbacks += 1
                    # restore the fallback slice from the latest checkpoint
                    self.slices[result.resource_id].reset("restore_checkpoint")
            else:
                fallbacks += 1
        return FleetReport(records, quanta * steps_per_quantum, fallbacks,
                           placements, losses, time.time() - t0)
