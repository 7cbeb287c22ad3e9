"""Clock abstraction for testable time — the port's copy of
`go_avalanche_tpu/clock.py`.

The reference swaps a package-global `clock clocker` for a stub in tests
(`avalanche.go:93-108`) — and never restores it, a test-pollution hazard the
survey flags (SURVEY.md section 4).  Here the clock is an instance owned by
each Processor, injected at construction, so tests cannot pollute each other.
"""

from __future__ import annotations

import time


class Clock:
    """Real wall clock (`avalanche.go:100-103`)."""

    def now(self) -> float:
        return time.time()


class StubClock(Clock):
    """Settable clock for tests (`avalanche.go:105-108`), plus `advance`."""

    def __init__(self, t: float = 0.0) -> None:
        self._t = t

    def now(self) -> float:
        return self._t

    def set(self, t: float) -> None:
        self._t = t

    def advance(self, dt: float) -> None:
        self._t += dt
