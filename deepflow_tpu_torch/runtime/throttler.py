"""Reservoir-sampling write throttler.

Caps downstream record rate the way the reference caps ClickHouse writes
(server/ingester/flow_log/throttler/throttling_queue.go SendWithThrottling:
a throttle*bucket-second reservoir; records past the cap replace a random
reservoir slot, so the surviving sample is uniform over the bucket). Rate
defaults mirror flow_log/config/config.go:33-34 (50 000/s, 8 s buckets).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class ThrottlingQueue:
    """Uniform reservoir over fixed time buckets; flushes on bucket roll."""

    def __init__(self, emit: Callable[[List[Any]], None],
                 throttle_per_s: int = 50_000, bucket_s: int = 8,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.time) -> None:
        if throttle_per_s <= 0 or bucket_s <= 0:
            raise ValueError("throttle and bucket must be positive")
        self._emit = emit
        self.capacity = throttle_per_s * bucket_s
        self.bucket_s = bucket_s
        self._clock = clock
        self._rng = random.Random(seed)
        self._reservoir: List[Any] = []
        self._seen = 0           # records offered this bucket
        self._bucket = self._bucket_of(clock())
        # same lock discipline as ColumnarThrottler: tick() runs on a
        # janitor thread while send() runs on a decoder thread
        self._lock = threading.Lock()
        # Countable counters
        self.in_count = 0
        self.sampled_out = 0     # records dropped by sampling
        self.emitted = 0

    def _bucket_of(self, ts: float) -> int:
        return int(ts) // self.bucket_s

    def send(self, item: Any) -> bool:
        """Offer one record. Returns False iff it was sampled away."""
        with self._lock:
            now = self._clock()
            batch = None
            if self._bucket_of(now) != self._bucket:
                batch = self._swap_locked()
                self._bucket = self._bucket_of(now)
            self.in_count += 1
            self._seen += 1
            if len(self._reservoir) < self.capacity:
                self._reservoir.append(item)
                kept = True
            else:
                # classic Algorithm R: keep with prob capacity/seen
                j = self._rng.randrange(self._seen)
                if j < self.capacity:
                    self._reservoir[j] = item
                    kept = True
                else:
                    kept = False
                self.sampled_out += 1   # either way one record displaced
        # emit OUTSIDE the lock: the downstream emit (a store writer, a
        # throttled sink) can be arbitrarily slow, and holding _lock
        # across it would block every decoder thread in send()
        if batch is not None:
            self._emit(batch)
        return kept

    def flush(self) -> None:
        """Emit the current bucket's survivors downstream."""
        with self._lock:
            batch = self._swap_locked()
        if batch is not None:
            self._emit(batch)

    def _swap_locked(self) -> Optional[List[Any]]:
        """Detach the reservoir under the lock; the CALLER emits it
        after release (a slow emit must not serialize send())."""
        batch = None
        if self._reservoir:
            batch = self._reservoir
            self._reservoir = []
            self.emitted += len(batch)
        self._seen = 0
        return batch

    def tick(self, now: Optional[float] = None) -> None:
        """Wall-clock bucket roll: a quiet stream's last bucket must
        not strand in the reservoir (see ColumnarThrottler.tick)."""
        now = self._clock() if now is None else now
        batch = None
        with self._lock:
            if self._bucket_of(now) != self._bucket:
                batch = self._swap_locked()
                self._bucket = self._bucket_of(now)
        if batch is not None:
            self._emit(batch)

    def counters(self) -> dict:
        return {
            "in": self.in_count,
            "sampled_out": self.sampled_out,
            "emitted": self.emitted,
            "pending": len(self._reservoir),
        }


class ColumnarThrottler:
    """Reservoir rate cap for structure-of-arrays pipelines.

    The exact ThrottlingQueue contract — a uniform survivor sample per time
    bucket, emitted downstream on bucket roll, observable drops — but run
    vectorized: the reservoir is a set of preallocated column arrays, and
    each chunk's rows are admitted with Algorithm R's keep probability
    capacity/seen in one vectorized draw, displacing random slots.
    """

    def __init__(self, emit: Callable[[Dict[str, np.ndarray]], None],
                 throttle_per_s: int = 50_000, bucket_s: int = 8,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.capacity = throttle_per_s * bucket_s
        self.bucket_s = bucket_s
        self._emit = emit
        self._clock = clock
        self._rng = np.random.default_rng(seed)
        self._bucket = int(clock()) // bucket_s
        self._res: Optional[Dict[str, np.ndarray]] = None
        self._fill = 0
        self._seen = 0
        # offer() runs on the decoder thread; flush() is also called from
        # pipeline flush/stop on other threads — serialize reservoir state
        self._lock = threading.Lock()
        self.in_count = 0
        self.sampled_out = 0
        self.emitted = 0

    def offer(self, cols: Dict[str, np.ndarray]) -> None:
        """Feed one chunk; survivors are emitted on the next bucket roll."""
        with self._lock:
            batch = self._offer_locked(cols)
        # emit OUTSIDE the lock (same discipline as ThrottlingQueue.send):
        # a slow downstream emit must not block every decoder in offer()
        if batch is not None:
            self._emit(batch)

    def _offer_locked(self, cols: Dict[str, np.ndarray]
                      ) -> Optional[Dict[str, np.ndarray]]:
        n = len(next(iter(cols.values()))) if cols else 0
        if n == 0:
            return None
        batch = None
        now = self._clock()
        bucket = int(now) // self.bucket_s
        if bucket != self._bucket:
            batch = self._swap_locked()
            self._bucket = bucket
        self.in_count += n
        if self._res is None:
            self._res = {k: np.empty((self.capacity,) + np.asarray(v).shape[1:],
                                     dtype=np.asarray(v).dtype)
                         for k, v in cols.items()}
        take = min(n, self.capacity - self._fill)
        if take:
            for k, v in cols.items():
                self._res[k][self._fill:self._fill + take] = \
                    np.asarray(v)[:take]
            self._fill += take
            self._seen += take
        if take == n:
            return batch
        # reservoir full: row at global index g survives w.p. capacity/(g+1)
        rest = n - take
        g = self._seen + np.arange(rest)
        keep = self._rng.random(rest) < self.capacity / (g + 1)
        self._seen += rest
        kept = int(keep.sum())
        self.sampled_out += rest - kept
        if kept:
            slots = self._rng.integers(0, self.capacity, size=kept)
            for k, v in cols.items():
                self._res[k][slots] = np.asarray(v)[take:][keep]
            self.sampled_out += 0  # displaced rows counted at flush
        return batch

    def flush(self) -> None:
        """Emit the current bucket's survivors downstream."""
        with self._lock:
            batch = self._swap_locked()
        if batch is not None:
            self._emit(batch)

    def tick(self, now: Optional[float] = None) -> None:
        """Roll the bucket on WALL CLOCK: without this, a quiet stream
        strands its last bucket in the reservoir forever (rolls
        otherwise only happen when the NEXT record arrives). Called
        periodically by the ingester's janitor; mid-bucket it's a
        no-op, so reservoir uniformity is untouched."""
        now = self._clock() if now is None else now
        batch = None
        with self._lock:
            if int(now) // self.bucket_s != self._bucket:
                batch = self._swap_locked()
                self._bucket = int(now) // self.bucket_s
        if batch is not None:
            self._emit(batch)

    def _swap_locked(self) -> Optional[Dict[str, np.ndarray]]:
        """Detach the bucket's survivors under the lock; caller emits."""
        if self._res is not None and self._fill:
            out = {k: v[:self._fill].copy() for k, v in self._res.items()}
            self.emitted += self._fill
            # rows offered but not in the final reservoir were sampled away
            self.sampled_out = self.in_count - self.emitted
            self._fill = 0
            self._seen = 0
            return out
        self._seen = 0
        return None

    def counters(self) -> dict:
        return {"in": self.in_count, "sampled_out": self.sampled_out,
                "emitted": self.emitted}
