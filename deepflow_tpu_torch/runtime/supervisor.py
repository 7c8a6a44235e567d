"""Supervision for the exporter's worker threads.

Every worker thread of the port (the exporter's queue worker, the device
feed, the window timer, the pack workers) runs under a `Supervisor`
that

- captures crashes (exception repr + full traceback, kept in a bounded
  ring),
- restarts the worker with exponential backoff and deterministic jitter
  (seeded RNG, injectable clock, so tests replay schedules),
- runs a deadman watchdog: each worker beats from its loop, and a
  monitor thread marks workers whose last beat is older than
  `deadman_s` as stale, so a wedged-but-alive thread is visible,
- exposes restart/crash/stale counters.

Restart policy: a worker whose target returns is done (normal shutdown:
exporter workers return when their queue closes). A worker whose target
raises has crashed: the same OS thread re-enters the target after the
backoff, unless the handle was stopped or spawned with restart=False.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["ThreadHandle", "Supervisor", "default_supervisor"]

_CRASH_RING = 32           # retained crash records per supervisor


class ThreadHandle:
    """One supervised worker: liveness, crash history, heartbeat."""

    def __init__(self, name: str, restart: bool,
                 deadman_s: Optional[float], clock) -> None:
        self.name = name
        self.restart = restart
        self.deadman_s = deadman_s
        self.restarts = 0
        self.crashes = 0
        self.last_beat = clock()
        self.done = False
        self.stale = False
        self._clock = clock
        self._stop = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self.last_beat = self._clock()

    def stop(self) -> None:
        """Stop restarting (and cancel a backoff wait in progress). Does
        not interrupt a running target: the target's own stop signal
        (queue close, halt event) does that."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def is_alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)


class Supervisor:
    """Owns worker threads: crash capture, backoff restart, deadman."""

    def __init__(self, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 5.0, jitter: float = 0.25,
                 deadman_s: Optional[float] = 60.0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 monitor_interval_s: float = 1.0) -> None:
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.jitter = jitter
        self.deadman_s = deadman_s     # None disables the default watchdog
        self._rng = random.Random(seed)
        self._clock = clock
        self._monitor_interval_s = monitor_interval_s
        self._handles: List[ThreadHandle] = []
        self._by_ident: Dict[int, ThreadHandle] = {}
        self._crash_log: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.total_crashes = 0
        self.total_restarts = 0
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()

    # -- spawning ----------------------------------------------------------
    def spawn(self, name: str, target: Callable[[], None],
              restart: bool = True,
              deadman_s: Optional[float] = -1.0,
              beat_period_s: Optional[float] = None) -> ThreadHandle:
        """Run `target` (a long-running loop) on a supervised daemon
        thread. deadman_s: -1 inherits the supervisor default; None or 0
        disables the watchdog for this worker (a loop that legitimately
        blocks longer between beats, like the window timer).
        beat_period_s: the worker's own beat cadence (one beat per loop
        iteration); a cadence at or past half the watchdog window
        disables the watchdog for this worker, which would otherwise
        read stale between two healthy beats."""
        dm = self.deadman_s if deadman_s == -1.0 else (deadman_s or None)
        if beat_period_s is not None and dm is not None \
                and beat_period_s >= dm / 2:
            dm = None
        h = ThreadHandle(name, restart, dm, self._clock)
        t = threading.Thread(target=self._run, args=(h, target),
                             name=name, daemon=True)
        h.thread = t
        with self._lock:
            self._handles.append(h)
            # finished workers age out so churn can't grow the list
            if len(self._handles) > 4096:
                self._handles = [x for x in self._handles if not x.done]
        self._ensure_monitor()
        t.start()
        return h

    def _run(self, h: ThreadHandle, target: Callable[[], None]) -> None:
        self._tls.handle = h
        with self._lock:
            self._by_ident[threading.get_ident()] = h
        attempt = 0
        try:
            while True:
                started = self._clock()
                h.beat()
                try:
                    target()
                    return                      # normal completion
                except Exception as e:
                    self._record_crash(h, e)
                    if not h.restart or h.stopped:
                        return
                    # a run that outlived twice the backoff cap was
                    # healthy: start the backoff ladder over
                    if self._clock() - started > 2 * self.backoff_cap_s:
                        attempt = 0
                    delay = min(self.backoff_cap_s,
                                self.backoff_base_s * (2 ** attempt))
                    delay *= 1.0 + self.jitter * self._rng.random()
                    # clamped: past the cap the exponent no longer
                    # matters, and 2**attempt would overflow a float
                    attempt = min(attempt + 1, 64)
                    h.restarts += 1
                    with self._lock:
                        self.total_restarts += 1
                    if h._stop.wait(delay):
                        return
        finally:
            h.done = True
            with self._lock:
                self._by_ident.pop(threading.get_ident(), None)

    def _record_crash(self, h: ThreadHandle, e: Exception) -> None:
        h.crashes += 1
        rec = {"thread": h.name, "ts": time.time(),
               "error": repr(e), "traceback": traceback.format_exc()}
        with self._lock:
            self.total_crashes += 1
            self._crash_log.append(rec)
            del self._crash_log[:-_CRASH_RING]

    # -- heartbeats --------------------------------------------------------
    def beat(self) -> None:
        """Heartbeat for the calling thread; a no-op when the caller is
        not supervised (a test driving a worker loop inline)."""
        h = getattr(self._tls, "handle", None)
        if h is None:
            h = self._by_ident.get(threading.get_ident())
        if h is not None:
            h.last_beat = self._clock()

    def check_deadman(self, now: Optional[float] = None) -> List[str]:
        """Mark workers whose last beat is older than their deadman_s;
        returns the names stale now (monitor thread and tests)."""
        now = self._clock() if now is None else now
        stale: List[str] = []
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            if h.done or h.deadman_s is None or not h.is_alive():
                h.stale = False
                continue
            h.stale = (now - h.last_beat) > h.deadman_s
            if h.stale:
                stale.append(h.name)
        return stale

    def _ensure_monitor(self) -> None:
        with self._lock:
            if self._monitor is not None:
                return

            def loop() -> None:
                while not self._monitor_stop.wait(self._monitor_interval_s):
                    self.check_deadman()

            self._monitor = threading.Thread(target=loop,
                                             name="supervisor-deadman",
                                             daemon=True)
            self._monitor.start()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop restarts and the monitor. Worker targets are stopped by
        their owners (queue close etc.); this only cancels backoffs."""
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            h.stop()
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2)
            self._monitor = None
        self._monitor_stop.clear()

    # -- observability -----------------------------------------------------
    def crash_log(self) -> List[dict]:
        with self._lock:
            return list(self._crash_log)

    def threads(self) -> List[dict]:
        """One row per worker."""
        with self._lock:
            handles = list(self._handles)
        return [{"name": h.name, "alive": h.is_alive(), "done": h.done,
                 "stale": h.stale, "restarts": h.restarts,
                 "crashes": h.crashes, "restart_policy": h.restart}
                for h in handles]

    def counters(self) -> dict:
        with self._lock:
            handles = list(self._handles)
        alive = sum(1 for h in handles if h.is_alive())
        stale = sum(1 for h in handles if h.stale and h.is_alive())
        return {"threads": len(handles), "alive": alive, "stale": stale,
                "crashes": self.total_crashes,
                "restarts": self.total_restarts}


_default: Optional[Supervisor] = None
_default_lock = threading.Lock()


def default_supervisor() -> Supervisor:
    """The process supervision tree, made on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Supervisor()
        return _default
