"""Injectable time source for the serving engine.

A copy of the part of ``repro/core/simclock.py`` the engine uses: the
:class:`Clock` interface and the production :class:`SystemClock`.  Any
object with the same methods (the reference's ``VirtualClock`` included)
can be passed as ``ServingEngine(clock=...)``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["Clock", "SystemClock", "SYSTEM_CLOCK"]


class Clock:
    """Abstract time source: wall/monotonic time plus the waiting primitive
    the engine's driver loop parks on."""

    def now(self) -> float:
        """Wall-clock epoch seconds."""
        raise NotImplementedError

    def monotonic(self) -> float:
        """Scheduling timebase (deadlines, latency stats)."""
        raise NotImplementedError

    def wait_for(self, cond: threading.Condition,
                 predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        """Wait on ``cond`` (caller holds it) until ``predicate`` or
        ``timeout``.  Returns the final predicate value."""
        raise NotImplementedError


class SystemClock(Clock):
    """Production clock: a thin delegate to the ``time`` module."""

    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def wait_for(self, cond: threading.Condition,
                 predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        return cond.wait_for(predicate, timeout=timeout)


#: process-wide default — every ``clock=None`` resolves here
SYSTEM_CLOCK = SystemClock()
