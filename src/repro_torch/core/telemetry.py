"""Runtime snapshots — the part of ``repro/core/telemetry.py`` an adapter
returns: :class:`RuntimeSnapshot`, with the reference's fields, on the
port's own clock.  The bus that stores and ages snapshots belongs to the
control plane."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.clock import SYSTEM_CLOCK


@dataclasses.dataclass
class RuntimeSnapshot:
    resource_id: str
    health_status: str = "healthy"             # healthy | degraded | failed
    drift_score: float = 0.0                   # 0 = calibrated, 1 = unusable
    readiness: str = "ready"                   # ready | preparing | busy | down
    age_of_information_ms: float = 0.0         # staleness of this snapshot
    viability: Optional[float] = None          # wetware-specific
    contamination: Optional[float] = None      # chemical-specific
    queue_depth: int = 0
    # stamped by the clock-owning bus when it stores the snapshot; None =
    # never stored
    last_updated: Optional[float] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    def aged(self, now: Optional[float] = None) -> "RuntimeSnapshot":
        """Copy with age_of_information_ms recomputed (copy-on-read: the
        stored snapshot is never mutated, so concurrent readers are safe).
        ``now`` lets a clock-owning caller (the bus) age against its own
        timebase; an unstamped snapshot has age 0."""
        if self.last_updated is None:
            return dataclasses.replace(self, age_of_information_ms=0.0)
        if now is None:
            now = SYSTEM_CLOCK.now()
        return dataclasses.replace(
            self, age_of_information_ms=(now - self.last_updated) * 1e3)

    def to_dict(self, now: Optional[float] = None) -> Dict:
        return dataclasses.asdict(self.aged(now))
