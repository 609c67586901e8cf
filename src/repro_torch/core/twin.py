"""Digital-twin types an adapter returns — the part of ``repro/core/twin.py``
the port's substrates need: :class:`TwinNotReady`, :func:`output_divergence`,
:class:`TwinSurrogate` and :class:`TwinState`, with the reference's names,
fields and divergence metric.  The sync manager and the twin executor
belong to the control plane, which drives these copies duck-typed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.clock import SYSTEM_CLOCK


class TwinNotReady(RuntimeError):
    """The surrogate has not learned/observed enough to answer yet."""


# ---------------------------------------------------------------------------
# divergence metric


def output_divergence(real, twin) -> float:
    """Normalized divergence between two adapter ``output`` payloads.

    0.0 = exact agreement, 1.0 = unusable.  Handles the shapes adapters
    produce: dicts (mean over the union of keys, missing key = 1), numeric
    scalars (relative error), sequences (relative L2), bools/strings
    (exact match).  NaNs compare equal to NaNs (a twin predicting "no loss
    yet" for a backend reporting the same is agreement, not divergence).
    """
    if real is None and twin is None:
        return 0.0
    if real is None or twin is None:
        return 1.0
    if isinstance(real, bool) or isinstance(twin, bool):
        return 0.0 if bool(real) == bool(twin) else 1.0
    if isinstance(real, dict) and isinstance(twin, dict):
        keys = set(real) | set(twin)
        if not keys:
            return 0.0
        return float(np.mean([
            output_divergence(real.get(k), twin.get(k)) if k in real
            and k in twin else 1.0 for k in sorted(keys)]))
    if isinstance(real, str) or isinstance(twin, str):
        return 0.0 if real == twin else 1.0
    try:
        a = np.asarray(real, dtype=np.float64).ravel()
        b = np.asarray(twin, dtype=np.float64).ravel()
    except (TypeError, ValueError):
        return 0.0 if real == twin else 1.0
    if a.shape != b.shape:
        return 1.0
    if a.size == 0:
        return 0.0
    both_nan = np.isnan(a) & np.isnan(b)
    a = np.where(both_nan, 0.0, a)
    b = np.where(both_nan, 0.0, b)
    if np.isnan(a).any() or np.isnan(b).any():
        return 1.0
    denom = max(float(np.linalg.norm(a)), float(np.linalg.norm(b)), 1e-9)
    return float(min(1.0, np.linalg.norm(a - b) / denom))


class TwinSurrogate:
    """Executable surrogate model behind a :class:`TwinState`.

    Subclasses override :meth:`simulate` (required), :meth:`observe` and
    :meth:`divergence` (optional), and declare ``kind`` / ``tolerance``.
    Surrogates may be called from shadow-pool threads concurrently with
    adapter invocations — keep internal state small and lock it if mutated.
    """

    kind: str = "behavioral"
    #: declared acceptable normalized divergence vs the real output
    tolerance: float = 0.2

    def simulate(self, task) -> Dict:
        """Answer ``task`` digitally; same raw dict shape as
        ``SubstrateAdapter.invoke``.  Raise :class:`TwinNotReady` when the
        twin cannot answer yet."""
        raise NotImplementedError

    def observe(self, task, raw: Dict) -> None:
        """Learning hook: called with every successful real invocation's
        ``{"output": ..., "telemetry": ...}``."""

    def divergence(self, real_output, twin_output) -> float:
        return output_divergence(real_output, twin_output)


@dataclasses.dataclass
class TwinState:
    twin_id: str
    resource_id: str
    kind: str = "behavioral"               # ode | behavioral | roofline | record
    confidence: float = 1.0                # decays with drift & staleness
    drift_estimate: float = 0.0
    # stamped by the owning TwinSyncManager's clock at register(); a raw
    # default_factory=time.time here would stamp wall epochs into
    # virtual-time runs (wall is past the VirtualClock epoch, so such
    # twins would look fresher-than-now and never go stale)
    last_sync: Optional[float] = None
    calibration_ts: Optional[float] = None
    observations: int = 0
    model: Dict = dataclasses.field(default_factory=dict)   # twin parameters
    #: why the twin was last invalidated ("" = not invalidated); pins
    #: ``valid()`` False until an explicit re-sync or a measured
    #: within-tolerance shadow comparison
    invalidation_reason: str = ""
    #: EMA of MEASURED shadow/speculation divergence (None = never measured)
    divergence_ema: Optional[float] = None
    #: 1.0 = twin demonstrably matches reality, 0.0 = demonstrably wrong;
    #: stays 1.0 until a divergence is actually measured
    fidelity_score: float = 1.0
    #: executable surrogate (None = metadata-only twin); excluded from
    #: serialization — it is code, not state
    surrogate: Optional[TwinSurrogate] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: wall-time source for staleness (set by the owning TwinSyncManager
    #: from its injected clock; None = real time).  Code, not state —
    #: excluded from comparison and repr like the surrogate.
    time_fn: Optional[Callable[[], float]] = dataclasses.field(
        default=None, repr=False, compare=False)

    #: default ``valid()`` confidence floor; tasks override it via
    #: ``TaskRequest.twin_min_confidence``
    DEFAULT_MIN_CONFIDENCE = 0.3

    def age_ms(self) -> float:
        if self.last_sync is None:
            return 0.0
        now = self.time_fn() if self.time_fn is not None \
            else SYSTEM_CLOCK.now()
        return (now - self.last_sync) * 1e3

    @property
    def executable(self) -> bool:
        return self.surrogate is not None

    def valid(self, max_age_ms: Optional[float],
              min_confidence: Optional[float] = None) -> Tuple[bool, str]:
        """Is this twin trustworthy right now?  ``min_confidence=None``
        applies :data:`DEFAULT_MIN_CONFIDENCE`; tasks may tighten or relax
        it per request."""
        if min_confidence is None:
            min_confidence = self.DEFAULT_MIN_CONFIDENCE
        if self.invalidation_reason:
            return False, f"twin invalidated: {self.invalidation_reason}"
        if max_age_ms is not None and self.age_ms() > max_age_ms:
            return False, f"twin stale ({self.age_ms():.0f}ms > {max_age_ms}ms)"
        if self.confidence < min_confidence:
            return False, f"twin confidence {self.confidence:.2f} < {min_confidence}"
        return True, "ok"

    def to_dict(self) -> Dict:
        return {
            "twin_id": self.twin_id, "resource_id": self.resource_id,
            "kind": self.kind, "confidence": round(self.confidence, 4),
            "drift_estimate": round(self.drift_estimate, 4),
            "age_ms": round(self.age_ms(), 2),
            "observations": self.observations,
            "invalidation_reason": self.invalidation_reason or None,
            "divergence_ema": (round(self.divergence_ema, 4)
                               if self.divergence_ema is not None else None),
            "fidelity_score": round(self.fidelity_score, 4),
            "executable": self.executable,
        }
