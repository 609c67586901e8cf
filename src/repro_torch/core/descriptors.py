"""Substrate-aware capability model — a copy of ``repro/core/descriptors.py``.

:class:`ResourceDescriptor` identifies a concrete resource and its operating
context; :class:`CapabilityDescriptor` says what it can do and under which
conditions.  The names, fields, defaults and wire form (``to_dict`` /
``from_dict``) are the reference's, so a descriptor the port's adapter
builds matches, registers and crosses the wire exactly as one the
reference builds: a ``repro`` plane consumes it unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


def _tup(v) -> Tuple:
    """Wire lists come back as tuples (descriptor dataclasses are frozen
    and hashable; ``dataclasses.asdict`` serializes tuples as lists)."""
    return tuple(v) if v is not None else ()


def known_fields(cls, d: Dict) -> Dict:
    """Drop unknown keys before dataclass construction: additive fields
    from a newer MINOR protocol version must be ignored, not crash a
    ``from_dict``/``from_wire`` (the wire compatibility policy in
    the reference's ``gateway/protocol.py``).  Shared by every wire constructor."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """Typed multi-physics I/O description (requirement R2)."""

    modality: str
    encoding: str = "float32"
    admissible_range: Tuple[float, float] = (0.0, 1.0)
    sampling_hz: Optional[float] = None
    transduction: Optional[str] = None    # required conversion step, if any

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "SignalSpec":
        d = known_fields(cls, d)
        d["admissible_range"] = tuple(d.get("admissible_range", (0.0, 1.0)))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TimingSemantics:
    """R3: when outputs become meaningful."""

    latency_regime: str                   # slow_seconds | fast_ms | sub_ms
    expected_latency_ms: float
    observation_window_ms: float
    min_stabilization_ms: float = 0.0
    trigger_mode: str = "request"         # request | stream | event
    freshness_ms: float = 60_000.0        # results older than this are stale

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "TimingSemantics":
        return cls(**known_fields(cls, d))


@dataclasses.dataclass(frozen=True)
class LifecycleSemantics:
    """R4: warm-up / reset / calibration affordances."""

    warmup_ms: float = 0.0
    resetable: bool = True
    reset_modes: Tuple[str, ...] = ("soft",)
    reset_cost_ms: float = 0.0
    calibration_interval_s: Optional[float] = None
    recovery_modes: Tuple[str, ...] = ()
    cooldown_ms: float = 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "LifecycleSemantics":
        d = known_fields(cls, d)
        d["reset_modes"] = _tup(d.get("reset_modes", ("soft",)))
        d["recovery_modes"] = _tup(d.get("recovery_modes"))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Observability:
    """R5: which runtime signals exist and which feed the twin."""

    output_channels: Tuple[str, ...]
    telemetry_fields: Tuple[str, ...]
    drift_indicators: Tuple[str, ...] = ()
    twin_linked_fields: Tuple[str, ...] = ()

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Observability":
        return cls(output_channels=_tup(d.get("output_channels")),
                   telemetry_fields=_tup(d.get("telemetry_fields")),
                   drift_indicators=_tup(d.get("drift_indicators")),
                   twin_linked_fields=_tup(d.get("twin_linked_fields")))


@dataclasses.dataclass(frozen=True)
class PolicyConstraints:
    """R7: safety, isolation, tenancy."""

    exclusive: bool = True
    requires_supervision: bool = False
    max_stimulation: Optional[float] = None
    max_concurrent: int = 1
    authorized_tenants: Tuple[str, ...] = ("*",)
    biosafety_level: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PolicyConstraints":
        d = known_fields(cls, d)
        d["authorized_tenants"] = _tup(d.get("authorized_tenants", ("*",)))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CapabilityDescriptor:
    functions: Tuple[str, ...]            # e.g. ("inference", "screening")
    input_signal: SignalSpec
    output_signal: SignalSpec
    timing: TimingSemantics
    lifecycle: LifecycleSemantics
    programmability: str
    observability: Observability
    policy: PolicyConstraints
    supports_repeated_invocation: bool = True
    energy_proxy_mj: Optional[float] = None

    def to_dict(self) -> Dict:
        return {
            "functions": list(self.functions),
            "input_signal": self.input_signal.to_dict(),
            "output_signal": self.output_signal.to_dict(),
            "timing": self.timing.to_dict(),
            "lifecycle": self.lifecycle.to_dict(),
            "programmability": self.programmability,
            "observability": self.observability.to_dict(),
            "policy": self.policy.to_dict(),
            "supports_repeated_invocation": self.supports_repeated_invocation,
            "energy_proxy_mj": self.energy_proxy_mj,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CapabilityDescriptor":
        return cls(
            functions=_tup(d.get("functions")),
            input_signal=SignalSpec.from_dict(d["input_signal"]),
            output_signal=SignalSpec.from_dict(d["output_signal"]),
            timing=TimingSemantics.from_dict(d["timing"]),
            lifecycle=LifecycleSemantics.from_dict(d["lifecycle"]),
            programmability=d["programmability"],
            observability=Observability.from_dict(d["observability"]),
            policy=PolicyConstraints.from_dict(d["policy"]),
            supports_repeated_invocation=d.get("supports_repeated_invocation",
                                               True),
            energy_proxy_mj=d.get("energy_proxy_mj"),
        )


@dataclasses.dataclass(frozen=True)
class ResourceDescriptor:
    resource_id: str
    substrate_class: str                  # chemical | wetware | memristive | ...
    adapter_type: str                     # in_process | http | external_api
    location: str                         # extreme_edge | edge | fog | cloud | lab
    twin_binding: Optional[str]           # twin model id, None = no twin
    capability: CapabilityDescriptor
    description: str = ""

    def to_dict(self) -> Dict:
        return {
            "resource_id": self.resource_id,
            "substrate_class": self.substrate_class,
            "adapter_type": self.adapter_type,
            "location": self.location,
            "twin_binding": self.twin_binding,
            "capability": self.capability.to_dict(),
            "description": self.description,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ResourceDescriptor":
        return cls(
            resource_id=d["resource_id"],
            substrate_class=d["substrate_class"],
            adapter_type=d["adapter_type"],
            location=d["location"],
            twin_binding=d.get("twin_binding"),
            capability=CapabilityDescriptor.from_dict(d["capability"]),
            description=d.get("description", ""),
        )
