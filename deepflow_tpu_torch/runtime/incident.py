"""Incident flight recorder: one correlated, durable bundle per trigger.

When a breaker opens, the accuracy alarm latches, an anomaly alert
fires, health turns not ok or an SLO burns fast, the operator's question
is what happened in the seconds before. The answer lives in volatile
process state (the timeline rings, the profiler's span ring, the
Countable registry, the snapshot bus heads); the recorder captures all
of it at the trigger instant as one fsynced directory:

    <incident_dir>/inc-<unixts>-<seq>-<kind>/
        manifest.json   version, id, kind, wall_time, window, file map
        trigger.json    the trigger record (kind + detail)
        timeline.json   timeline window [t - window_s, t]
        trace.json      Chrome-trace span export (runtime/profiler.py)
        counters.json   full Countable dump (stats.peek())
        snapbus.json    snapshot head metadata (sketch + anomaly buses)

Durability follows the snapshot bus: written into a tmp directory, every
file fsynced, `os.replace()` into place, the parent fsynced
(`snapbus._fsync_dir`), so a bundle exists whole or not at all. Capture
is rate-limited (`min_interval_s`, suppressed captures counted) and the
directory bounded by `budget_bytes` (oldest bundles evicted, counted).
The layout is the JAX package's, so either package reads the other's
bundles.

`IncidentWatcher` is the trigger edge detector: it rides the timeline's
sampler tick and calls `IncidentRecorder.capture` on transitions
(closed -> open, ok -> not ok, a rising alert count, an SLO entering
fast burn), never on levels: a breaker open for an hour is one incident.

The recorder is also the querier's SQL datasource (`sql`,
`SELECT * FROM incidents`): one row per readable bundle manifest.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["IncidentRecorder", "IncidentWatcher", "INCIDENTS_TABLE",
           "BUNDLE_VERSION"]

INCIDENTS_TABLE = "incidents"
INCIDENTS_SQL_COLUMNS = ["time", "id", "kind", "bytes", "files", "detail"]
BUNDLE_VERSION = 1


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
    return total


def _snapshot_head(bus) -> Optional[dict]:
    snap = bus.latest() if bus is not None else None
    if snap is None:
        return None
    return {"step": snap.step, "seq": snap.seq,
            "wall_time": snap.wall_time, "path": snap.path,
            "leaves": len(snap.leaves),
            "tags": {k: str(v) for k, v in (snap.tags or {}).items()}}


class IncidentRecorder:
    """Capture, bound, and serve incident bundles under one directory."""

    def __init__(self, directory: str, timeline=None, profiler=None,
                 stats=None, snapbuses: Optional[Dict[str, object]] = None,
                 budget_bytes: int = 64 << 20,
                 min_interval_s: float = 30.0,
                 window_s: float = 120.0,
                 clock=time.time) -> None:
        self.directory = directory
        self.timeline = timeline
        self.profiler = profiler
        self.stats = stats
        self.snapbuses = dict(snapbuses or {})
        self.budget_bytes = int(budget_bytes)
        self.min_interval_s = float(min_interval_s)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_capture = 0.0
        self.captured = 0
        self.suppressed = 0
        self.bundles_evicted = 0
        self.bytes_evicted = 0
        self.capture_errors = 0
        self.manifest_errors = 0   # unreadable/torn manifests on read
        os.makedirs(directory, exist_ok=True)

    # -- capture -----------------------------------------------------------
    def capture(self, kind: str, detail: Optional[dict] = None,
                now: Optional[float] = None) -> Optional[str]:
        """Write one bundle; returns its path, or None when the
        rate-limiter suppressed it (counted). The interval is global,
        not per-kind: one bad moment trips several detectors at once
        (breaker -> healthz -> burn) and should yield ONE bundle."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.captured and now - self._last_capture \
                    < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_capture = now
            self._seq += 1
            seq = self._seq
        name = f"inc-{int(now)}-{seq:04d}-{_slug(kind)}"
        try:
            path = self._write_bundle(name, kind, dict(detail or {}), now)
        except Exception:
            self.capture_errors += 1
            return None
        self.captured += 1
        self._enforce_budget()
        return path

    def _write_bundle(self, name: str, kind: str, detail: dict,
                      now: float) -> str:
        tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=self.directory)
        files: Dict[str, int] = {}

        def emit(fname: str, obj) -> None:
            p = os.path.join(tmp, fname)
            with open(p, "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=1, default=str)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            files[fname] = os.path.getsize(p)

        emit("trigger.json", {"kind": kind, "wall_time": now,
                              "detail": detail})
        if self.timeline is not None:
            emit("timeline.json", {
                "window": [now - self.window_s, now],
                "sample_s": self.timeline.sample_s,
                "series": self.timeline.window(now - self.window_s,
                                               now + 1.0)})
        if self.profiler is not None:
            emit("trace.json", self.profiler.to_chrome_trace())
        if self.stats is not None:
            emit("counters.json", [
                {"ts": s.ts, "module": s.module, "tags": s.tags,
                 "values": {k: v for k, v in s.values.items()}}
                for s in self.stats.peek()])
        heads = {lane: _snapshot_head(bus)
                 for lane, bus in self.snapbuses.items()}
        emit("snapbus.json", heads)
        emit("manifest.json", {
            "version": BUNDLE_VERSION, "id": name, "kind": kind,
            "wall_time": now,
            "window": [now - self.window_s, now],
            "files": files, "detail": detail})
        # tmp -> final is atomic; a crash mid-write leaves only a
        # dot-prefixed tmp dir the lister ignores
        final = os.path.join(self.directory, name)
        os.replace(tmp, final)
        from deepflow_tpu_torch.runtime.snapbus import _fsync_dir
        _fsync_dir(self.directory)
        return final

    def _enforce_budget(self) -> None:
        """Oldest-first eviction past budget_bytes — every evicted
        bundle moves a Countable, never vanishes silently."""
        with self._lock:
            bundles = self._list_dirs()
            sizes = {b: _dir_bytes(os.path.join(self.directory, b))
                     for b in bundles}
            total = sum(sizes.values())
            for b in bundles:            # oldest first (name-sorted)
                if total <= self.budget_bytes:
                    break
                p = os.path.join(self.directory, b)
                try:
                    shutil.rmtree(p)
                except OSError:
                    continue
                total -= sizes[b]
                self.bundles_evicted += 1
                self.bytes_evicted += sizes[b]

    # -- read side ---------------------------------------------------------
    def _list_dirs(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith("inc-") and
                      os.path.isdir(os.path.join(self.directory, n)))

    def list(self) -> List[dict]:
        """Manifest summaries, oldest first (re-read from disk: the
        directory is the source of truth, surviving restarts)."""
        out = []
        for name in self._list_dirs():
            m = self.manifest(name)
            if m is not None:
                out.append(m)
        return out

    def manifest(self, bundle_id: str) -> Optional[dict]:
        p = os.path.join(self.directory, bundle_id, "manifest.json")
        try:
            with open(p, "r", encoding="utf-8") as f:
                m = json.load(f)
        except (OSError, ValueError):
            # a bundle whose manifest cannot be read is invisible to
            # every lister — counted, so the loss shows on /metrics
            self.manifest_errors += 1
            return None
        m["path"] = os.path.join(self.directory, bundle_id)
        m["bytes"] = sum(m.get("files", {}).values())
        return m

    # -- SQL datasource (querier/engine.py routes table == "incidents") ----
    def sql(self, stmt) -> "QueryResult":
        """`SELECT * FROM incidents`: one row per bundle, WHERE time
        bounds applied, sorted by (time, id)."""
        from deepflow_tpu_torch.querier import sql as Q
        from deepflow_tpu_torch.querier.engine import QueryResult
        from deepflow_tpu_torch.serving.tables import SketchTables

        if len(stmt.items) != 1 \
                or not isinstance(stmt.items[0].expr, Q.Column) \
                or stmt.items[0].expr.name != "*":
            raise ValueError("the incidents datasource answers "
                             "SELECT * FROM incidents (one row per "
                             "bundle; WHERE time bounds apply)")
        lo, hi = SketchTables._time_bounds(stmt.where)
        rows = []
        for m in self.list():
            t = int(m.get("wall_time", 0))
            if (lo is not None and t < lo) or \
                    (hi is not None and t >= hi):
                continue
            rows.append([t, m.get("id", ""), m.get("kind", ""),
                         int(m.get("bytes", 0)),
                         len(m.get("files", {})),
                         json.dumps(m.get("detail", {}),
                                    sort_keys=True)])
        rows.sort(key=lambda r: (r[0], r[1]))
        off = getattr(stmt, "offset", 0)
        if off:
            rows = rows[off:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return QueryResult(list(INCIDENTS_SQL_COLUMNS), rows)

    def register_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.register_datasource(INCIDENTS_TABLE, self.datasources)

    def unregister_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.unregister_datasource(INCIDENTS_TABLE)

    def datasources(self) -> List[dict]:
        bundles = self._list_dirs()
        return [{"table": INCIDENTS_TABLE, "kind": "incidents",
                 "directory": self.directory, "bundles": len(bundles),
                 "budget_bytes": self.budget_bytes,
                 "captured": self.captured,
                 "evicted": self.bundles_evicted}]

    # -- observability ------------------------------------------------------
    def counters(self) -> dict:
        return {
            "captured": self.captured,
            "suppressed": self.suppressed,
            "bundles_evicted": self.bundles_evicted,
            "bytes_evicted": self.bytes_evicted,
            "capture_errors": self.capture_errors,
            "manifest_errors": self.manifest_errors,
            "bundles": len(self._list_dirs()),
        }


def _slug(kind: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in kind)[:40] or "trigger"


class IncidentWatcher:
    """Edge-triggered detector riding the timeline sampler tick.

    Every source is polled as a level; a capture fires only on the
    rising edge (closed->open breaker, ok->not-ok health, alarm
    latching, alert counter increasing, SLO entering fast-burn). The
    recorder's global rate limit then collapses the burst of
    correlated edges one bad moment produces into a single bundle.
    """

    def __init__(self, recorder: IncidentRecorder,
                 health_fn: Optional[Callable[[], dict]] = None,
                 breakers_fn: Optional[Callable[[], dict]] = None,
                 alerts_fn: Optional[Callable[[], float]] = None,
                 timeline=None) -> None:
        self.recorder = recorder
        self.health_fn = health_fn
        self.breakers_fn = breakers_fn
        self.alerts_fn = alerts_fn
        self.timeline = timeline
        self._prev_open: set = set()
        self._prev_ok = True
        self._prev_alarm = False
        self._prev_alerts: Optional[float] = None
        self._prev_burning: set = set()
        self.triggers = 0

    def tick(self, now: float) -> None:
        if self.breakers_fn is not None:
            try:
                brk = self.breakers_fn()
            except Exception:
                brk = {}
            is_open = set()
            for name, b in brk.items():
                state = b.get("state") if isinstance(b, dict) \
                    else getattr(b, "state", "")
                if str(state).lower().endswith("open") and \
                        "half" not in str(state).lower():
                    is_open.add(name)
            for name in sorted(is_open - self._prev_open):
                self._fire("breaker_open", {"breaker": name}, now)
            self._prev_open = is_open
        health = None
        if self.health_fn is not None:
            try:
                health = self.health_fn()
            except Exception:
                health = None
        if health is not None:
            ok = bool(health.get("ok", True))
            if self._prev_ok and not ok:
                self._fire("healthz", health, now)
            self._prev_ok = ok
            alarm = bool(health.get("accuracy_alarm", False))
            if alarm and not self._prev_alarm:
                self._fire("accuracy_alarm", health, now)
            self._prev_alarm = alarm
        if self.alerts_fn is not None:
            try:
                alerts = float(self.alerts_fn())
            except Exception:
                alerts = None
            if alerts is not None:
                if self._prev_alerts is not None \
                        and alerts > self._prev_alerts:
                    self._fire("anomaly_alert",
                               {"alerts_total": alerts}, now)
                self._prev_alerts = alerts
        if self.timeline is not None:
            burning = set(self.timeline.fast_burning(now))
            for slo in sorted(burning - self._prev_burning):
                self._fire("slo_fast_burn", {"slo": slo}, now)
            self._prev_burning = burning

    def _fire(self, kind: str, detail: dict, now: float) -> None:
        self.triggers += 1
        self.recorder.capture(kind, detail, now=now)

    def counters(self) -> dict:
        return {"triggers": self.triggers,
                "open_breakers": len(self._prev_open),
                "burning": len(self._prev_burning)}
