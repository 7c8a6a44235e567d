"""Deterministic, seeded fault injection for the exporter's data path.

Named sites ask `should_fire(site)` at the spot where a real fault would
land; tests and `chip_smoke.py` arm them with a fixed seed so every run
replays the same schedule. The sites this package fires:

- ``receiver.truncate`` -- truncate a TCP read mid-frame (framing loss);
- ``queue.stall``      -- sleep inside `OverwriteQueue.gets` (a slow
  consumer);
- ``exporter.raise``   -- raise out of an exporter's `put` in the
  `Exporters` fan-out;
- ``tpu.device_error`` -- raise a device-classified `RuntimeError` where
  the exporter dispatches to the device (the name is the reference's);
- ``checkpoint.torn``  -- tear a snapshot file mid-write;
- ``spill.write``      -- fail a disk-spill segment write (disk full,
  EIO; runtime/spill.py counts the records lost);
- ``sender.disconnect`` -- drop `agent/sender.UniformSender`'s TCP
  connection at a frame boundary (an ingester restart);
- ``exporter.process`` -- raise inside `QueueWorkerExporter.process`;
- ``anomaly.score``    -- raise where the anomaly plane scores a window
  (the window closes unscored, counted);
- ``shard.device_error`` -- raise where a pod shard dispatches (keys
  ``shardN:update``, ``shardN:probe``);
- ``merge.stall``      -- stall a pod shard between its epoch copy and
  its post (``maybe_stall``, ``delay_s``);
- ``shard.lost``       -- kill a pod shard's worker mid-epoch;
- ``host.lost``        -- kill a cross-host pod's host holding a marker;
- ``dcn.partition``    -- sever one host's simulated DCN link;
- ``dcn.marker_loss``  -- lose one epoch marker in transit.

The registry is off by default and every call site guards on
`default_faults().enabled` (one attribute load on the hot path). Arming
a site sets the flag; disarming the last one clears it.

Arming is programmatic (`arm()`) or by a spec string::

    tpu.device_error:count=1,after=2;checkpoint.torn:count=1;seed=7

Each clause is ``site:key=value,...``; a bare ``seed=N`` clause seeds
the registry. Keys: ``count`` (fire the first N hits), ``p`` (fire with
probability p per hit, seeded), ``for_s`` (fire only within S seconds of
arming), ``after`` (skip the first N hits), ``delay_s`` (how long
``maybe_stall`` sleeps when it fires), ``match`` (only hits whose key
contains this substring).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FaultSite", "FaultRegistry", "InjectedFault", "default_faults",
           "ALL_FAULT_SITES",
           "FAULT_RECEIVER_TRUNCATE", "FAULT_QUEUE_STALL",
           "FAULT_EXPORTER_RAISE", "FAULT_DEVICE_ERROR", "FAULT_CHECKPOINT_TORN",
           "FAULT_SPILL_WRITE", "FAULT_SENDER_DISCONNECT",
           "FAULT_EXPORTER_PROCESS", "FAULT_ANOMALY_SCORE",
           "FAULT_SHARD_DEVICE_ERROR", "FAULT_MERGE_STALL",
           "FAULT_SHARD_LOST", "FAULT_HOST_LOST", "FAULT_DCN_PARTITION",
           "FAULT_DCN_MARKER_LOSS"]

FAULT_RECEIVER_TRUNCATE = "receiver.truncate"
FAULT_QUEUE_STALL = "queue.stall"
FAULT_EXPORTER_RAISE = "exporter.raise"
FAULT_DEVICE_ERROR = "tpu.device_error"
FAULT_CHECKPOINT_TORN = "checkpoint.torn"
FAULT_SPILL_WRITE = "spill.write"
FAULT_SENDER_DISCONNECT = "sender.disconnect"
FAULT_EXPORTER_PROCESS = "exporter.process"
FAULT_ANOMALY_SCORE = "anomaly.score"
FAULT_SHARD_DEVICE_ERROR = "shard.device_error"
FAULT_MERGE_STALL = "merge.stall"
FAULT_SHARD_LOST = "shard.lost"
FAULT_HOST_LOST = "host.lost"
FAULT_DCN_PARTITION = "dcn.partition"
FAULT_DCN_MARKER_LOSS = "dcn.marker_loss"

# every registered site string in one tuple, derived (never hand-listed)
# from the FAULT_* constants above
ALL_FAULT_SITES = tuple(sorted(
    v for k, v in list(globals().items())
    if k.startswith("FAULT_") and isinstance(v, str)))


class InjectedFault(RuntimeError):
    """The raised error: a RuntimeError, as CUDA errors and failed
    kernel launches are, so handlers classify it like a real one."""


class FaultSite:
    """One armed site's schedule; every decision is local and seeded."""

    __slots__ = ("name", "count", "p", "until", "after", "delay_s",
                 "match", "hits", "fired", "_rng")

    def __init__(self, name: str, count: Optional[int] = None,
                 p: Optional[float] = None, for_s: Optional[float] = None,
                 after: int = 0, delay_s: float = 0.05,
                 match: Optional[str] = None,
                 rng: Optional[random.Random] = None,
                 clock=time.monotonic) -> None:
        self.name = name
        self.count = count
        self.p = p
        self.until = None if for_s is None else clock() + float(for_s)
        self.after = int(after)
        self.delay_s = float(delay_s)
        self.match = match
        self.hits = 0
        self.fired = 0
        self._rng = rng or random.Random(0)

    def decide(self, key: str, now: float) -> bool:
        # match filters before hit accounting: `after`/`count` count
        # matched hits only
        if self.match is not None and self.match not in key:
            return False
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.until is not None and now > self.until:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True


class FaultRegistry:
    """Named sites -> armed schedules; `enabled` is the hot-path gate."""

    def __init__(self, seed: int = 0, clock=time.monotonic,
                 sleep=time.sleep) -> None:
        self.enabled = False
        self._sites: Dict[str, FaultSite] = {}
        self._lock = threading.Lock()
        self._seed = seed
        self._clock = clock
        self._sleep = sleep

    def arm(self, site: str, **kw) -> FaultSite:
        """Arm one site (kw: count / p / for_s / after / delay_s /
        match). Its RNG derives from (registry seed, site name), so a
        seed replays the same schedule whatever order sites were armed
        in."""
        rng = random.Random(f"{self._seed}:{site}")
        fs = FaultSite(site, rng=rng, clock=self._clock, **kw)
        with self._lock:
            self._sites[site] = fs
            self.enabled = True
        return fs

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site (or all); clears `enabled` when none remain."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)
            self.enabled = bool(self._sites)

    def arm_spec(self, spec: str) -> List[str]:
        """Arm from a spec string (module docstring); returns the armed
        site names. A malformed clause raises ValueError."""
        armed: List[str] = []
        clauses = [c.strip() for c in spec.split(";") if c.strip()]
        for c in clauses:              # the seed applies registry-wide
            if c.startswith("seed="):
                self._seed = int(c[len("seed="):])
        for c in clauses:
            if c.startswith("seed="):
                continue
            if ":" not in c:
                raise ValueError(f"fault clause {c!r}: expected site:k=v,...")
            site, _, body = c.partition(":")
            kw: dict = {}
            for pair in filter(None, (p.strip() for p in body.split(","))):
                if "=" not in pair:
                    raise ValueError(f"fault clause {c!r}: bad pair {pair!r}")
                k, _, v = pair.partition("=")
                if k in ("count", "after"):
                    kw[k] = int(v)
                elif k in ("p", "for_s", "delay_s"):
                    kw[k] = float(v)
                elif k == "match":
                    kw[k] = v
                else:
                    raise ValueError(f"fault clause {c!r}: unknown key {k!r}")
            self.arm(site.strip(), **kw)
            armed.append(site.strip())
        return armed

    # -- fire decisions (hot path: callers check `.enabled` first) ---------
    def should_fire(self, site: str, key: str = "") -> bool:
        with self._lock:
            fs = self._sites.get(site)
            if fs is None:
                return False
            return fs.decide(key, self._clock())

    def maybe_raise(self, site: str, key: str = "") -> None:
        if self.should_fire(site, key):
            raise InjectedFault(f"injected fault at {site} ({key})")

    def maybe_stall(self, site: str, key: str = "") -> None:
        """Sleep the site's `delay_s` when it fires."""
        if self.should_fire(site, key):
            with self._lock:
                fs = self._sites.get(site)
                delay = fs.delay_s if fs is not None else 0.05
            self._sleep(delay)

    def maybe_truncate(self, site: str, data: bytes, key: str = "") -> bytes:
        """A prefix of `data` when the site fires (at least one byte
        short, so the framing downstream sees a tear)."""
        if data and self.should_fire(site, key):
            with self._lock:
                fs = self._sites.get(site)
                rng = fs._rng if fs is not None else random.Random(0)
            return data[:rng.randrange(0, len(data))]
        return data

    def counters(self) -> dict:
        """Per-site hit and fired totals."""
        out: dict = {"armed": 0}
        with self._lock:
            for name, fs in self._sites.items():
                out["armed"] += 1
                key = name.replace(".", "_")
                out[f"{key}_hits"] = fs.hits
                out[f"{key}_fired"] = fs.fired
        return out


_default: Optional[FaultRegistry] = None
_default_lock = threading.Lock()


def default_faults() -> FaultRegistry:
    """The process fault switchboard, made on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FaultRegistry()
        return _default
