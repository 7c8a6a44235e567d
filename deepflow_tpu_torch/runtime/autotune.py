"""Self-tuning device feed: the occupancy gauges close the loop.

The feed's shape (`coalesce_batches`, `prefetch_depth`, `pack_workers`)
is right at one duty cycle only: a bursty stream wants deep prefetch and
wide coalescing at peak and shallow everything at the trough, where queue
dwell is added latency. `FeedAutotuner` is the feedback controller, a
supervised thread that once per `interval_s` reads the occupancy deltas
and hill-climbs one knob at a time, within bounds:

- **objective** = busy_fraction - stall_rate - dwell_rate: device
  utilization (`runtime/profiler.py`), minus the share of wall time the
  device starved, minus queue-sitting time per wall second (the feed's
  `queue_dwell_s`). All three are rates, so the sum compares across
  phases.
- **one knob per trial, round robin**: a trial steps one knob by +-1,
  waits an interval for the effect to reach the gauges, then commits
  (objective improved past the deadband) or reverts. Idle intervals (no
  rows moved) judge nothing.
- **hysteresis and cooldown**: a revert flips the knob's direction and
  doubles its cooldown (capped), so an oscillating knob is tried
  geometrically less often.
- **safe fallback**: a device error, a crash recovery or a degraded
  transition restores every knob to its static value and stops the
  controller.

The control law is the JAX package's (runtime/autotune.py), unchanged.
Its busy fraction is the profiler's union of device spans. Eager torch
runs a program's kernels as the host launches them, so a tuner reading
would steer on launch time; the tuner therefore marks the exporter a
busy reader (`busy_reader`), which times its programs behind a device
gate with the tracer off too (runtime/tpu_sketch.py).

Knobs and what each resizes:

- `coalesce_batches`: the stager's `set_group_batches`, applied when the
  next group opens (never mid-group, which keeps the controller
  invisible to the sketch state). Buffers of the new size are allocated
  by the stager on the exporter's worker thread, never on the decoder
  thread that calls `put()`.
- `prefetch_depth`: `DeviceFeed.depth` (read per group), and the
  stagers' free-list cap follows it (`depth + 2` buffers per size), so
  a deeper window recycles its pinned buffers instead of allocating one
  per group; a refused recycle is counted, never waited on.
- `pack_workers`: `PackPool.resize` (routing width; destinations are
  pre-assigned, so any routing lands the same bytes).

Decisions, reverts, fallbacks and the live knob values are `tpu_autotune_*`
gauges and a Countable (the ingester registers `exporter.tpu_autotune`).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["FeedAutotuner", "AUTOTUNE_GAUGE_HELP", "autotune_gauges"]

# HELP text of the gauges this module exposes
AUTOTUNE_GAUGE_HELP: Dict[str, str] = {
    "tpu_autotune_enabled":
        "1 while the feed autotuner is live-tuning; 0 after close or "
        "safe fallback to the static config",
    "tpu_autotune_coalesce_batches":
        "current coalesce width the controller holds (batches per "
        "staged group / feed window item)",
    "tpu_autotune_prefetch_depth":
        "current prefetch window depth the controller holds "
        "(dispatched-but-unfenced updates)",
    "tpu_autotune_pack_workers":
        "current pack-pool routing width the controller holds (0 = no "
        "pool in this pipeline)",
    "tpu_autotune_decisions":
        "knob trials committed (the objective improved past the "
        "hysteresis band and the new value stuck)",
    "tpu_autotune_reverts":
        "knob trials rolled back (no improvement; the knob's cooldown "
        "doubles, damping oscillation)",
    "tpu_autotune_fallbacks":
        "safe fallbacks to the static config (device error, crash "
        "recovery or degraded transition while tuning)",
    "tpu_autotune_objective":
        "last scored objective: device_busy_fraction - stall_rate - "
        "queue_dwell_rate (higher is better; NaN-free, 0 when idle)",
}

# live controllers, for `autotune_gauges` (the exposition needs no
# handle to the ingester)
_REGISTRY: List["FeedAutotuner"] = []
_REGISTRY_LOCK = threading.Lock()


def autotune_gauges() -> Dict[str, float]:
    """Merged gauges of every live controller. One controller per process
    is the expected shape; with several the last registration wins per
    name, as for the tracer's gauges."""
    out: Dict[str, float] = {}
    with _REGISTRY_LOCK:
        controllers = list(_REGISTRY)
    for c in controllers:
        out.update(c.gauges())
    return out


class _Knob:
    """One tunable: live getter/setter + bounds + per-knob trial
    memory (preferred direction, cooldown ticks remaining)."""

    __slots__ = ("name", "get", "set", "lo", "hi", "static",
                 "direction", "cooldown", "cooldown_base")

    def __init__(self, name: str, get: Callable[[], int],
                 set_: Callable[[int], None], lo: int, hi: int) -> None:
        self.name = name
        self.get = get
        self.set = set_
        self.lo = int(lo)
        self.hi = int(hi)
        self.static = int(get())     # the config value fallback restores
        self.direction = 1           # try growing first: stalls hurt more
        self.cooldown = 0            # ticks until this knob may trial
        self.cooldown_base = 1


class FeedAutotuner:
    """Bounded hill-climbing feedback controller over the device-feed
    knobs of one TpuSketchExporter. See the module docstring for the
    control law; the public surface is start()/close(), tick() (the
    same step the thread runs, callable synchronously in tests), and
    gauges()/counters()."""

    def __init__(self, exporter, interval_s: float = 2.0,
                 max_coalesce: int = 8, max_depth: int = 8,
                 max_pack_workers: int = 8,
                 deadband: float = 0.02,
                 metrics: Optional[Callable[[], Dict[str, float]]] = None,
                 profiler=None,
                 name: str = "feed-autotune") -> None:
        self.exporter = exporter
        self.interval_s = max(0.05, float(interval_s))
        self.deadband = float(deadband)
        self.name = name
        if profiler is None:
            from deepflow_tpu_torch.runtime.profiler import default_profiler
            profiler = default_profiler()
        self._prof = profiler
        self._metrics = metrics if metrics is not None else self._read
        if metrics is None and hasattr(exporter, "busy_reader"):
            # the objective reads the busy gauge: the exporter keeps it
            # timed on the device (gated samples) with the tracer off too
            exporter.busy_reader = True
        self._lock = threading.Lock()      # tick() vs close()/gauges()
        self._handle = None
        self._stop = threading.Event()
        self.enabled = True
        self.decisions = 0
        self.reverts = 0
        self.fallbacks = 0
        self.ticks = 0
        self.objective = 0.0
        # deltas baseline
        self._last_stall = None
        self._last_dwell = None
        self._last_dwell_batches = None
        self._last_rows = None
        self._err_baseline = None
        # trial state: (knob, previous value) while one is in flight
        self._trial = None
        self._baseline_obj = None
        self._rr = 0                       # round-robin cursor
        self.knobs = self._build_knobs(max_coalesce, max_depth,
                                       max_pack_workers)
        with _REGISTRY_LOCK:
            _REGISTRY.append(self)

    # -- knob surface ------------------------------------------------------
    def _build_knobs(self, max_coalesce: int, max_depth: int,
                     max_pack_workers: int) -> List[_Knob]:
        e = self.exporter
        knobs: List[_Knob] = []
        stager = getattr(e, "_stager", None)
        feed = getattr(e, "_feed", None)

        if stager is not None:
            def get_co() -> int:
                return int(stager.group_batches)

            def set_co(n: int) -> None:
                # applied at the next group boundary -- mid-group the
                # old width finishes, so the batch partition (and the
                # sketch state) never sees a half-retuned group
                stager.set_group_batches(n)
        elif feed is not None:
            def get_co() -> int:
                return int(feed.coalesce)

            def set_co(n: int) -> None:
                feed.coalesce = int(n)
        else:
            get_co = None
        if get_co is not None:
            knobs.append(_Knob("coalesce_batches", get_co, set_co,
                               1, max_coalesce))

        if feed is not None:
            pool_cap = getattr(stager, "set_pool_cap", None)

            def set_depth(n: int) -> None:
                feed.depth = int(n)
                if pool_cap is not None:
                    # enough free buffers per size for the deeper window
                    pool_cap(int(n) + 2)

            knobs.append(_Knob("prefetch_depth",
                               lambda: int(feed.depth), set_depth,
                               1, max_depth))

        pool = getattr(e, "_pack_pool", None)
        if pool is not None:
            knobs.append(_Knob("pack_workers",
                               lambda: int(pool.active),
                               lambda n: pool.resize(n),
                               1, max_pack_workers))
        return knobs

    # -- metric plumbing ---------------------------------------------------
    def _read(self) -> Dict[str, float]:
        e = self.exporter
        feed = getattr(e, "_feed", None)
        return {
            "busy": self._prof.busy_fraction(),
            "stall_s": self._prof.stall_s,
            "dwell_s": getattr(feed, "queue_dwell_s", 0.0),
            "dwell_batches": getattr(feed, "dwell_batches", 0),
            "rows_in": getattr(e, "rows_in", 0),
            "device_errors": getattr(e, "device_errors", 0),
            "crash_recoveries": getattr(feed, "crash_recoveries", 0),
            "degraded": 1.0 if getattr(e, "degraded", False) else 0.0,
        }

    def _score(self, m: Dict[str, float], dt: float) -> float:
        """busy − stall_rate − dwell_rate over the elapsed interval.
        Rates, not totals: stall_s and queue_dwell_s are cumulative, so
        the controller differences them against its last tick."""
        stall_d = max(0.0, m["stall_s"] - self._last_stall)
        dwell_d = max(0.0, m["dwell_s"] - self._last_dwell)
        return (float(m["busy"])
                - stall_d / dt
                - dwell_d / dt)

    # -- control law -------------------------------------------------------
    def tick(self, dt: Optional[float] = None) -> None:
        """One control step (the thread calls this once per interval;
        tests call it directly). `dt` overrides the elapsed seconds the
        rate terms normalize by."""
        with self._lock:
            self._tick_locked(self.interval_s if dt is None else dt)

    def _tick_locked(self, dt: float) -> None:
        if not self.enabled:
            return
        m = self._metrics()
        self.ticks += 1
        if self._last_stall is None:
            # first observation: baselines only, no judgement
            self._seed_baselines(m)
            return
        if (m["device_errors"] > self._err_baseline["device_errors"]
                or m["crash_recoveries"]
                > self._err_baseline["crash_recoveries"]
                or (m["degraded"]
                    and not self._err_baseline["degraded"])):
            self._fallback_locked()
            return
        rows = m["rows_in"] - self._last_rows
        obj = self._score(m, max(dt, 1e-3))
        self.objective = obj
        self._seed_baselines(m)
        if rows <= 0:
            # idle interval: neither judge a pending trial nor start
            # one — the gauges carry no information about the knob
            return
        if self._trial is not None:
            knob, prev = self._trial
            self._trial = None
            if obj > self._baseline_obj + self.deadband:
                # committed: the step stuck, same direction next time
                self.decisions += 1
                knob.cooldown_base = 1
                knob.cooldown = 1
            else:
                # no improvement: roll back, flip, and damp — each
                # revert doubles this knob's cooldown (capped) so an
                # oscillating knob is trialed geometrically less often
                knob.set(prev)
                self.reverts += 1
                knob.direction = -knob.direction
                knob.cooldown_base = min(knob.cooldown_base * 2, 64)
                knob.cooldown = knob.cooldown_base
            return
        self._start_trial_locked(obj)

    def _start_trial_locked(self, obj: float) -> None:
        n = len(self.knobs)
        for _ in range(n):
            knob = self.knobs[self._rr % n]
            self._rr += 1
            if knob.cooldown > 0:
                knob.cooldown -= 1
                continue
            cur = knob.get()
            nxt = cur + knob.direction
            if not (knob.lo <= nxt <= knob.hi):
                knob.direction = -knob.direction
                nxt = cur + knob.direction
                if not (knob.lo <= nxt <= knob.hi):
                    continue           # lo == hi: nothing to tune
            knob.set(nxt)
            self._trial = (knob, cur)
            self._baseline_obj = obj
            return

    def _seed_baselines(self, m: Dict[str, float]) -> None:
        self._last_stall = m["stall_s"]
        self._last_dwell = m["dwell_s"]
        self._last_dwell_batches = m["dwell_batches"]
        self._last_rows = m["rows_in"]
        self._err_baseline = {
            "device_errors": m["device_errors"],
            "crash_recoveries": m["crash_recoveries"],
            "degraded": bool(m["degraded"]),
        }

    def _fallback_locked(self) -> None:
        """The safety posture: restore every knob to its static config
        value and stop tuning. A device incident must meet the exact
        pipeline the operator configured, not a half-explored one."""
        for knob in self.knobs:
            try:
                knob.set(knob.static)
            except Exception:            # a dying pipeline: best effort
                pass
        self._trial = None
        self.fallbacks += 1
        self.enabled = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._handle is not None:
            return
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._handle = default_supervisor().spawn(self.name, self._run)

    def _run(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        last = time.perf_counter()
        while not self._stop.is_set():
            # beat at sub-second cadence whatever interval_s is: the
            # deadman watches the thread, not the control loop
            self._stop.wait(min(0.2, self.interval_s))
            sup.beat()
            now = time.perf_counter()
            if now - last < self.interval_s:
                continue
            try:
                self.tick(dt=now - last)
            except Exception:
                # one bad read must not kill the controller; the
                # supervisor would restart it into the same state anyway
                pass
            last = now

    def close(self) -> None:
        self._stop.set()
        if self._handle is not None:
            self._handle.stop()
            self._handle.join(timeout=2.0)
            self._handle = None
        with self._lock:
            self.enabled = False
        with _REGISTRY_LOCK:
            try:
                _REGISTRY.remove(self)
            except ValueError:
                pass

    # -- exposition --------------------------------------------------------
    def _knob_value(self, name: str) -> float:
        for k in self.knobs:
            if k.name == name:
                try:
                    return float(k.get())
                except Exception:
                    return 0.0
        return 0.0

    def gauges(self) -> Dict[str, float]:
        return {
            "tpu_autotune_enabled": 1.0 if self.enabled else 0.0,
            "tpu_autotune_coalesce_batches":
                self._knob_value("coalesce_batches"),
            "tpu_autotune_prefetch_depth":
                self._knob_value("prefetch_depth"),
            "tpu_autotune_pack_workers":
                self._knob_value("pack_workers"),
            "tpu_autotune_decisions": float(self.decisions),
            "tpu_autotune_reverts": float(self.reverts),
            "tpu_autotune_fallbacks": float(self.fallbacks),
            "tpu_autotune_objective": round(float(self.objective), 6),
        }

    def counters(self) -> dict:
        """The Countable the ingester registers as
        ``exporter.tpu_autotune`` — same names the gauges carry (minus
        the prefix), so the timeline series and the /metrics gauges
        read as one family."""
        g = self.gauges()
        return {k[len("tpu_autotune_"):]: v for k, v in g.items()}
