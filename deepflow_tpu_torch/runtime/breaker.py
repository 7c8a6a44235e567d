"""Per-exporter circuit breakers: one failing exporter becomes counted
loss instead of poisoning its siblings and the decode stage.

`Exporters.put` runs on the decoder thread, so each registered exporter's
put path sits behind a three-state machine:

- CLOSED: calls flow; outcomes land in a rolling window. It trips to
  OPEN once the window holds >= `min_calls` outcomes and the failure
  fraction is >= `failure_rate` (a call slower than `latency_budget_s`
  counts as a failure).
- OPEN: calls are shed without touching the exporter, each counted
  (`dropped`). After `open_s` the next `allow()` moves to HALF_OPEN.
- HALF_OPEN: up to `half_open_probes` calls go through. All of them
  succeeding closes the breaker (window reset); any failing re-opens it.

The clock is injectable, so tests replay trip and cool-down schedules.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["BreakerConfig", "CircuitBreaker",
           "STATE_CLOSED", "STATE_OPEN", "STATE_HALF_OPEN"]

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

_STATE_CODE = {STATE_CLOSED: 0, STATE_OPEN: 1, STATE_HALF_OPEN: 2}


@dataclass(frozen=True)
class BreakerConfig:
    """Trip and recovery policy (`IngesterConfig` carries these)."""

    failure_rate: float = 0.5      # window fraction that trips CLOSED->OPEN
    min_calls: int = 4             # window must hold this many outcomes
    window: int = 32               # rolling outcome window size
    open_s: float = 5.0            # quarantine before the half-open probe
    half_open_probes: int = 2      # probes that must all succeed to close
    latency_budget_s: Optional[float] = None   # slow call == failure


class CircuitBreaker:
    """Three-state breaker around one exporter's put path."""

    def __init__(self, name: str, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.cfg = cfg or BreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._outcomes: list = []      # rolling window of True=ok
        self._open_until = 0.0
        self._probes_inflight = 0
        self._probe_successes = 0
        self.calls = 0
        self.failures = 0
        self.slow = 0
        self.dropped = 0               # shed while OPEN
        self.trips = 0
        self.probes = 0
        self.closes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this call proceed? Sheds (and counts) while OPEN."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            now = self._clock()
            if self._state == STATE_OPEN:
                if now < self._open_until:
                    self.dropped += 1
                    return False
                self._state = STATE_HALF_OPEN
                self._probes_inflight = 0
                self._probe_successes = 0
            if self._probes_inflight < self.cfg.half_open_probes:
                self._probes_inflight += 1
                self.probes += 1
                return True
            self.dropped += 1
            return False

    def record_success(self, latency_s: Optional[float] = None) -> None:
        cfg = self.cfg
        slow = (cfg.latency_budget_s is not None
                and latency_s is not None
                and latency_s > cfg.latency_budget_s)
        with self._lock:
            self.calls += 1
            if slow:
                self.slow += 1
            if self._state == STATE_HALF_OPEN:
                if slow:
                    self._reopen_locked()
                else:
                    self._probe_successes += 1
                    if self._probe_successes >= cfg.half_open_probes:
                        self._close_locked()
                return
            self._push_locked(not slow)

    def record_failure(self) -> None:
        with self._lock:
            self.calls += 1
            self.failures += 1
            if self._state == STATE_HALF_OPEN:
                self._reopen_locked()
                return
            if self._state == STATE_CLOSED:
                self._push_locked(False)

    def _push_locked(self, ok: bool) -> None:
        self._outcomes.append(ok)
        del self._outcomes[:-self.cfg.window]
        n = len(self._outcomes)
        if n >= self.cfg.min_calls:
            bad = n - sum(self._outcomes)
            if bad / n >= self.cfg.failure_rate:
                self._reopen_locked()

    def _reopen_locked(self) -> None:
        self._state = STATE_OPEN
        self._open_until = self._clock() + self.cfg.open_s
        self._outcomes = []
        self.trips += 1

    def _close_locked(self) -> None:
        self._state = STATE_CLOSED
        self._outcomes = []
        self.closes += 1

    def counters(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "state_code": _STATE_CODE[self._state],
                "calls": self.calls, "failures": self.failures,
                "slow": self.slow, "dropped": self.dropped,
                "trips": self.trips, "probes": self.probes,
                "closes": self.closes,
            }
