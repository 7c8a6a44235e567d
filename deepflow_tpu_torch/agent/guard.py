"""Guard: self-imposed resource limits + escape-to-safe behavior.

Reference: agent/src/utils/guard.rs — a watchdog thread enforces the
controller-set cpu/memory limits (graceful self-termination on breach,
:174,:205-312) and the synchronizer's escape timer reverts to a safe
config when the controller goes silent. Here breach and escape invoke
callbacks so the orchestrator decides (stop capture / shrink batches)
instead of killing the process outright.

The port's own copy of the JAX package's `agent/guard.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import resource
import threading
import time
from typing import Callable, List, Optional


class Guard:
    def __init__(self, max_memory_mb: int = 768,
                 max_cpu_fraction: float = 1.0,
                 check_interval: float = 10.0) -> None:
        self.max_memory_mb = max_memory_mb
        self.max_cpu_fraction = max_cpu_fraction
        self.check_interval = check_interval
        self.on_breach: List[Callable[[str], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu = 0.0
        self._last_wall = 0.0
        self.breaches = 0

    def set_limits(self, max_memory_mb: int,
                   max_cpu_fraction: float) -> None:
        """Hot-applied from pushed config (reference: ConfigHandler)."""
        self.max_memory_mb = max_memory_mb
        self.max_cpu_fraction = max_cpu_fraction

    @staticmethod
    def current_rss_mb() -> float:
        """Live RSS (not ru_maxrss, whose high-water mark never drops —
        one transient spike would latch a permanent breach)."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * resource.getpagesize() / (1024 * 1024)
        except (OSError, ValueError, IndexError):
            ru = resource.getrusage(resource.RUSAGE_SELF)
            return ru.ru_maxrss / 1024  # fallback: peak (linux KiB)

    def check_once(self) -> Optional[str]:
        """Returns a breach description or None."""
        ru = resource.getrusage(resource.RUSAGE_SELF)
        rss_mb = self.current_rss_mb()
        if rss_mb > self.max_memory_mb:
            return f"memory {rss_mb:.0f}MiB > limit {self.max_memory_mb}MiB"
        cpu = ru.ru_utime + ru.ru_stime
        wall = time.monotonic()
        if self._last_wall:
            dw = wall - self._last_wall
            if dw > 0:
                frac = (cpu - self._last_cpu) / dw
                if frac > self.max_cpu_fraction:
                    self._last_cpu, self._last_wall = cpu, wall
                    return (f"cpu {frac:.2f} cores > limit "
                            f"{self.max_cpu_fraction:.2f}")
        self._last_cpu, self._last_wall = cpu, wall
        return None

    def start(self) -> None:
        # supervised: a raising breach
        # callback used to kill the guard silently — no RSS ceiling, no
        # CPU cap, forever; now it's crash-captured and restarted
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "guard", self._run, beat_period_s=self.check_interval)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)

    def _run(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._stop.wait(self.check_interval):
            sup.beat()
            breach = self.check_once()
            if breach is not None:
                self.breaches += 1
                for fn in self.on_breach:
                    fn(breach)

    def counters(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"rss_mb": ru.ru_maxrss / 1024, "breaches": self.breaches}


class EscapeTimer:
    """Revert to safe defaults when controller sync goes silent
    (reference: synchronizer.rs escape timer)."""

    def __init__(self, escape_after_s: float,
                 on_escape: Callable[[], None]) -> None:
        self.escape_after_s = escape_after_s
        self.on_escape = on_escape
        self._last_sync = time.monotonic()
        self._escaped = False

    def on_sync_ok(self) -> None:
        self._last_sync = time.monotonic()
        self._escaped = False

    def check(self) -> bool:
        if not self._escaped and \
                time.monotonic() - self._last_sync > self.escape_after_s:
            self._escaped = True
            self.on_escape()
        return self._escaped
