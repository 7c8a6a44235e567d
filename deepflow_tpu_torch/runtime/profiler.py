"""Occupancy profiler: is the card earning its keep?

A bounded ring of feed / fence / dispatch / device / h2d / window spans,
fed from the overlapped feed's fence points (runtime/feed.py), the
exporter's sampled attribution and the sharded suites' dispatch records,
reduced into live gauges:

- `tpu_device_busy_fraction`: the union of device-execution intervals
  over a sliding horizon, over the horizon. On a card an interval is the
  program's gated execution time (`BusyEstimator`, `ops/cuda_gate.py`):
  the attributed group's kernels run back to back behind a gate, so two
  events time the card's execution, not the host's launching. On the
  feed path each group's interval is the newest gated sample of its
  program (its key names the plane widths, which fix the work), ending
  at its fence's retirement and never longer than dispatch -> fence; a program not yet gated borrows its
  family's newest sample, else falls back to that interval (counted). On the inline path the sampled attribution
  contributes; on the CPU a program's wall time is its device time.
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

__all__ = ["OccupancyProfiler", "BusyEstimator", "default_profiler",
           "PROFILER_GAUGE_HELP"]

PROFILER_GAUGE_HELP: Dict[str, str] = {
    "tpu_device_busy_fraction":
        "union of device-execution intervals over the sliding horizon: "
        "each group's program timed behind a device gate (its kernels "
        "back to back, not the host's launching), capped at "
        "dispatch->fence on the feed path; a program not yet "
        "gated borrows its family's sample, else counts dispatch->fence",
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


class BusyEstimator:
    """Device time per group from gated samples of its programs.

    The exporter feeds it one sample per gated attribution (`sample`:
    the program key and its gated execution seconds) and counts the
    samples a gate's timeout released (`timed_out`: discarded). The
    feed asks it for a fenced group's device time (`estimate`): the sum
    over the group's programs of the newest sample of the same key,
    capped at the group's dispatch -> fence interval. A key names the
    widths of the planes its program runs over, and its kernels run
    over those padded planes, so a sample is not scaled by the group's
    valid rows (a partial group costs the launches of a full one). A
    program not sampled yet (its first call, which is never gated)
    borrows the newest sample of its family (the key before its first
    ':', e.g. `dict`, `anomaly`, `lanes_x4`), counted in
    `groups_borrowed`; with none in its family the group gets the
    interval itself, counted in `groups_ungated`."""

    def __init__(self) -> None:
        self._newest: Dict[str, float] = {}   # key -> seconds
        self._family: Dict[str, float] = {}   # family -> seconds
        self.samples = 0
        self.samples_timed_out = 0
        self.groups_estimated = 0
        self.groups_borrowed = 0
        self.groups_ungated = 0

    @staticmethod
    def family(key: str) -> str:
        return key.split(":", 1)[0]

    def sample(self, key: str, device_s: float) -> None:
        self._newest[key] = self._family[self.family(key)] = float(device_s)
        self.samples += 1

    def timed_out(self, key: str) -> None:
        self.samples_timed_out += 1

    def has(self, key: str) -> bool:
        return key in self._newest

    def estimate(self, programs, interval_s: float) -> float:
        """Device seconds of a group's program keys."""
        total = 0.0
        borrowed = False
        for key in programs:
            got = self._newest.get(key)
            if got is None:
                got = self._family.get(self.family(key))
                borrowed = True
            if got is None:
                self.groups_ungated += 1
                return interval_s
            total += got
        if borrowed:
            self.groups_borrowed += 1
        else:
            self.groups_estimated += 1
        return min(total, interval_s)

    def counters(self) -> dict:
        return {"busy_samples": self.samples,
                "busy_samples_timed_out": self.samples_timed_out,
                "busy_groups_estimated": self.groups_estimated,
                "busy_groups_borrowed": self.groups_borrowed,
                "busy_groups_ungated": self.groups_ungated}


_default: Optional[OccupancyProfiler] = None
_default_lock = threading.Lock()


def default_profiler() -> OccupancyProfiler:
    """The process occupancy profiler, made on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = OccupancyProfiler()
        return _default
