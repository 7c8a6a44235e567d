"""Occupancy profiler: is the card earning its keep?

A bounded ring of feed / fence / dispatch / device / h2d / window spans,
fed from the overlapped feed's fence points (runtime/feed.py), the
exporter's sampled attribution and the sharded suites' dispatch records,
reduced into live gauges:

- `tpu_device_busy_fraction`: the union of device-execution intervals
  over a sliding horizon, over the horizon. On the feed path an interval
  runs from a group's dispatch to its fence's retirement, which brackets
  the real execution; on the inline path only the sampled attribution
  contributes, so the number is authoritative with the feed on.
- `tpu_feed_stall_seconds`: cumulative seconds the feed thread sat with
  nothing in flight before work arrived: the device starved by the host.

The ring exports as a Chrome-trace / Perfetto JSON timeline
(`to_chrome_trace`). Recording is one tuple store per span (group
granularity, never per record), written without a lock like the
tracer's ring; the profiler never waits on the device itself, it only
timestamps waits that already happen (fences, the sampled drains).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["OccupancyProfiler", "default_profiler", "PROFILER_GAUGE_HELP"]

PROFILER_GAUGE_HELP: Dict[str, str] = {
    "tpu_device_busy_fraction":
        "union of device-execution intervals over the sliding horizon "
        "(dispatch->fence on the feed path; sampled drains inline). "
        "ROADMAP item 2's continuously-measured device-busy number",
    "tpu_feed_stall_seconds":
        "cumulative seconds the device sat with an empty in-flight "
        "window immediately before work ARRIVED (host starvation "
        "preceding real work, measured per arriving batch and capped "
        "by the poll quantum; a pipeline with no traffic accrues "
        "nothing)",
}

# track order of the trace export (tid assignment)
_TRACKS = ("feed", "fence", "dispatch", "device", "h2d", "window")


class OccupancyProfiler:
    """Bounded span ring and its occupancy reductions; one per process
    (`default_profiler`), spans of two exporters told apart by name."""

    def __init__(self, ring: int = 8192) -> None:
        self._ring: List[Optional[tuple]] = [None] * ring
        self._cap = ring
        self._n = 0                         # spans recorded, ever
        self._lock = threading.Lock()       # snapshot reads
        self.stall_s = 0.0                  # cumulative feed starvation
        self.busy_horizon_s = 10.0

    # -- recording -----------------------------------------------------------
    def record(self, track: str, name: str, dur_s: float,
               rows: int = 0, t_end: Optional[float] = None) -> None:
        """One completed span: wall-clock end (time.time) and duration."""
        if dur_s < 0:
            dur_s = 0.0
        i = self._n
        self._n = i + 1
        self._ring[i % self._cap] = (
            track, name, time.time() if t_end is None else t_end,
            dur_s, rows)

    def add_stall(self, dur_s: float) -> None:
        """Feed-thread starvation time (queue empty and window empty)."""
        if dur_s > 0:
            self.stall_s += dur_s

    # -- reductions ----------------------------------------------------------
    def _snapshot(self) -> List[tuple]:
        with self._lock:
            total = self._n
            ring = list(self._ring)
        return [s for s in (ring[k % self._cap]
                            for k in range(max(total - self._cap, 0), total))
                if s is not None]

    def busy_fraction(self, track: str = "device",
                      horizon_s: Optional[float] = None,
                      now: Optional[float] = None) -> float:
        """Union length of `track` intervals in the sliding window, over
        the window; the window shrinks to the observed span range, so a
        short run is not diluted by an idle horizon."""
        horizon = horizon_s if horizon_s is not None else self.busy_horizon_s
        now = time.time() if now is None else now
        lo = now - horizon
        ivals = sorted((max(t_end - dur, lo), min(t_end, now))
                       for tr, _name, t_end, dur, _rows in self._snapshot()
                       if tr == track and t_end >= lo)
        if not ivals:
            return 0.0
        window_lo = max(lo, ivals[0][0])
        covered = 0.0
        cur_a, cur_b = ivals[0]
        for a, b in ivals[1:]:
            if a > cur_b:
                covered += cur_b - cur_a
                cur_a, cur_b = a, b
            elif b > cur_b:
                cur_b = b
        covered += cur_b - cur_a
        span = max(now - window_lo, 1e-9)
        return min(1.0, max(0.0, covered / span))

    def gauges(self) -> Dict[str, float]:
        """The occupancy gauges, computed afresh per read."""
        return {
            "tpu_device_busy_fraction": round(self.busy_fraction(), 6),
            "tpu_feed_stall_seconds": round(self.stall_s, 6),
        }

    @property
    def spans_recorded(self) -> int:
        return self._n

    def occupancy(self) -> Dict[str, float]:
        """Busy fraction, the feed's overlap efficiency (the tracer gauge
        the feed keeps) and the cumulative stall."""
        from deepflow_tpu_torch.runtime.tracing import default_tracer
        g = default_tracer().gauges()
        return {
            "device_busy_fraction": round(self.busy_fraction(), 4),
            "feed_overlap_efficiency": round(
                g.get("tpu_feed_overlap_efficiency", 0.0), 4),
            "feed_stall_seconds": round(self.stall_s, 4),
        }

    # -- trace export --------------------------------------------------------
    def to_chrome_trace(self, limit: Optional[int] = None) -> dict:
        """The ring as a Chrome-trace / Perfetto JSON object: complete
        "X" events in microseconds, one tid per track; `limit` keeps the
        newest N events."""
        spans = self._snapshot()
        if limit is not None and len(spans) > limit:
            spans = spans[len(spans) - max(0, limit):]
        tids = {t: i + 1 for i, t in enumerate(_TRACKS)}
        events: List[dict] = []
        for track in sorted({s[0] for s in spans},
                            key=lambda t: tids.get(t, 99)):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1,
                "tid": tids.setdefault(track, len(tids) + 1),
                "args": {"name": track},
            })
        for track, name, t_end, dur, rows in spans:
            events.append({
                "name": name, "cat": track, "ph": "X",
                "ts": (t_end - dur) * 1e6, "dur": dur * 1e6, "pid": 1,
                "tid": tids.setdefault(track, len(tids) + 1),
                "args": {"rows": rows},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def counters(self) -> dict:
        return {"spans": self._n,
                "dropped": max(0, self._n - self._cap),
                "stall_s": round(self.stall_s, 6),
                "busy_fraction": round(self.busy_fraction(), 4)}

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self._cap
            self._n = 0
            self.stall_s = 0.0


_default: Optional[OccupancyProfiler] = None
_default_lock = threading.Lock()


def default_profiler() -> OccupancyProfiler:
    """The process occupancy profiler, made on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = OccupancyProfiler()
        return _default
