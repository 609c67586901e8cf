"""Structured refusal codes the serving engine raises.

A copy of the part of ``repro/core/errors.py`` the engine uses.  The code
values are the reference's, so a refusal from the port reads the same on
the wire as one from the JAX engine.
"""
from __future__ import annotations

import enum
from typing import Dict, Optional


class ErrorCode(str, enum.Enum):
    """Closed taxonomy of structured control-plane failure outcomes."""

    #: no admissible backend for this task shape (modality/function mismatch)
    NO_MATCH = "NO_MATCH"
    #: policy manager refused: supervision, tenancy, safety bounds
    POLICY_DENIED = "POLICY_DENIED"
    #: circuit breaker open / probation refused (resource quarantined)
    BREAKER_OPEN = "BREAKER_OPEN"
    #: concurrency slots exhausted / queue backpressure
    QUEUE_SATURATED = "QUEUE_SATURATED"
    #: deadline lapsed (while queued, or admission blocked past the budget)
    DEADLINE = "DEADLINE"
    #: twin validity constraint failed (invalidated / stale / low confidence)
    TWIN_INVALID = "TWIN_INVALID"
    #: every fallback attempt failed (prepare/invoke/postcondition errors)
    FALLBACK_EXHAUSTED = "FALLBACK_EXHAUSTED"
    #: named resource does not exist on this plane
    NOT_FOUND = "NOT_FOUND"
    #: malformed request / unsupported protocol version
    BAD_REQUEST = "BAD_REQUEST"
    #: remote plane unreachable (federation transport failure)
    PLANE_UNAVAILABLE = "PLANE_UNAVAILABLE"
    #: federating this plane would make it transitively reach itself
    FEDERATION_CYCLE = "FEDERATION_CYCLE"
    #: missing/unknown wire credentials (gateway requires per-plane keys)
    UNAUTHORIZED = "UNAUTHORIZED"
    #: unexpected server-side failure
    INTERNAL = "INTERNAL"


class ControlPlaneError(RuntimeError):
    """A refusal carrying its structured code and any detail."""

    def __init__(self, code: ErrorCode, message: str,
                 detail: Optional[Dict] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.detail = dict(detail or {})


class AdmissionRefused(ControlPlaneError):
    """Raised when the engine (or its admission hook) refuses work it cannot
    serve: a malformed request, or one predicted to miss its budget.  A
    refusal is admission control, not a substrate failure."""
