"""Substrate adapter interface — a copy of ``repro/substrates/base.py``.

Every adapter exposes the same software surface so a control plane can
drive it: ``descriptor()``, ``prepare()``, ``invoke()``, ``reset()``,
``snapshot()``, ``make_twin()``.  ``invoke`` returns a RAW dict (output /
telemetry / artifacts / backend_ms / needs_reset); the plane's invocation
manager normalizes it.  ``make_twin`` returns the adapter's digital-twin
binding, with an executable :class:`~repro_torch.core.twin.TwinSurrogate`
whose ``simulate(task)`` returns the same raw dict shape as ``invoke``.
A ``repro`` plane drives these adapters duck-typed (ROADMAP C4 names the
one seam: the refusal's class).
"""
from __future__ import annotations

import abc
import time
from typing import Dict, Optional

from repro_torch.core.descriptors import ResourceDescriptor
from repro_torch.core.telemetry import RuntimeSnapshot
from repro_torch.core.twin import TwinState


class SubstrateAdapter(abc.ABC):
    """Base class for all data-plane adapters."""

    def __init__(self):
        self._faults: set = set()

    # -- control-plane surface ------------------------------------------------
    @abc.abstractmethod
    def descriptor(self) -> ResourceDescriptor:
        ...

    @abc.abstractmethod
    def prepare(self, session) -> None:
        """Warm-up / priming / calibration for a session."""

    @abc.abstractmethod
    def invoke(self, session) -> Dict:
        """Execute; returns raw dict with keys output/telemetry/artifacts/
        backend_ms/needs_reset."""

    def reset(self, mode: str = "soft") -> None:
        pass

    def snapshot(self) -> Optional[RuntimeSnapshot]:
        return RuntimeSnapshot(self.descriptor().resource_id)

    def make_twin(self) -> Optional[TwinState]:
        """Digital-twin binding for this substrate (None = no twin).
        Adapters should attach an executable surrogate
        (``TwinState.surrogate``) so the twin plane can shadow, serve
        fallback and speculate — see the module docstring."""
        return None

    # -- fault injection (Table IV campaign) ----------------------------------
    def inject_fault(self, fault: str) -> None:
        self._faults.add(fault)

    def clear_faults(self) -> None:
        self._faults.clear()

    def _check_prepare_fault(self) -> None:
        if "prepare_failure" in self._faults:
            raise RuntimeError(
                f"{type(self).__name__}: injected preparation failure")

    def _apply_telemetry_faults(self, telemetry: Dict) -> Dict:
        if "drop_telemetry" in self._faults:
            # drop a drift indicator the contract may require
            telemetry = {k: v for k, v in telemetry.items()
                         if k not in ("drift_score",)}
        return telemetry


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e3
