"""Task model — a copy of ``repro/core/tasks.py``: :class:`TaskRequest`
with the reference's fields, defaults and wire forms, and the task-id
minting it needs.

The port's :class:`~repro_torch.training.runner.FleetRunner` builds its
``train_step`` tasks from this copy; a ``repro`` plane takes them
duck-typed (it makes no ``isinstance`` check on a task).  Ids embed a plane
namespace minted per process, so ids minted here and in the reference's
module never collide.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Dict, Optional, Tuple

_ids = itertools.count(1)
#: plane namespace embedded in minted task ids: pid plus a random token,
#: minted lazily and again after a fork
_plane_ns: Optional[str] = None
_ns_pid: Optional[int] = None


def _namespace() -> str:
    global _plane_ns, _ns_pid
    if _plane_ns is None or _ns_pid != os.getpid():
        _plane_ns = f"{os.getpid() % 0xFFFF:04x}{os.urandom(2).hex()}"
        _ns_pid = os.getpid()
    return _plane_ns


def new_task_id() -> str:
    return f"task-{_namespace()}-{next(_ids):05d}"


@dataclasses.dataclass
class TaskRequest:
    function: str                              # e.g. "inference", "train_step"
    input_modality: str
    output_modality: str
    payload: Any = None
    latency_budget_ms: Optional[float] = None
    required_telemetry: Tuple[str, ...] = ()
    max_twin_age_ms: Optional[float] = None
    supervision_available: bool = True
    backend_preference: Optional[str] = None   # directed workflow target
    allow_fallback: bool = True
    tenant: str = "default"
    repeated: bool = False                     # needs repeated low-latency calls
    #: executable-twin opt-in: None | "shadow" | "fallback" | "speculate"
    twin_mode: Optional[str] = None
    #: per-task override of the twin validity confidence floor
    twin_min_confidence: Optional[float] = None
    #: federation budgets: forwards left and the remaining deadline (ms)
    hop_budget: Optional[int] = None
    deadline_budget_ms: Optional[float] = None
    #: plane ids this task was forwarded through, origin first
    route: Tuple[str, ...] = ()
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    task_id: str = dataclasses.field(default_factory=new_task_id)

    def clone(self, **overrides) -> "TaskRequest":
        """Copy with field overrides and an un-aliased metadata dict;
        ``task_id`` is preserved (a clone is the same task)."""
        if "metadata" not in overrides and isinstance(self.metadata, dict):
            overrides["metadata"] = dict(self.metadata)
        return dataclasses.replace(self, **overrides)

    # -- wire forms -----------------------------------------------------------
    def to_wire(self) -> Dict:
        """Faithful serialization (payload included); ``from_wire``
        round-trips it exactly."""
        d = dataclasses.asdict(self)
        d["required_telemetry"] = list(self.required_telemetry)
        d["route"] = list(self.route)
        return d

    @classmethod
    def from_wire(cls, d: Dict) -> "TaskRequest":
        """Rebuild a task from its wire form, keeping its ``task_id``."""
        from repro_torch.core.descriptors import known_fields

        d = known_fields(cls, d)
        d["required_telemetry"] = tuple(d.get("required_telemetry") or ())
        d["route"] = tuple(d.get("route") or ())
        d["metadata"] = dict(d.get("metadata") or {})
        return cls(**d)

    def summary(self) -> Dict:
        """Redacting form for logs and traces: the payload is a placeholder."""
        d = self.to_wire()
        d["payload"] = None if self.payload is None else "<payload>"
        return d

    def to_dict(self) -> Dict:
        """Alias of :meth:`summary`."""
        return self.summary()
