"""SnapshotBus: the versioned sketch-snapshot store, pub/sub and disk.

Every `publish` copies the state's leaves to host numpy ONCE
(`convert.state_to_numpy`: the reference's leaf order and dtypes) and
fans the immutable `SketchSnapshot` out to in-process subscribers and,
when asked, to an fsynced npz file under `directory`. Restart replay and
the exporter's device-error rollback read the same files back through
`restore`, which builds fresh device tensors (`convert.state_from_numpy`)
and refuses a snapshot whose leaves do not match the current config.

The files are the JAX package's format: keys `leaf_i` (FlowSuiteState
leaves in order, uint32 leaves as uint32), `__step`, `__wall` and
`__tags` (JSON), named `<name>-<step:012d>.npz`. A directory written by
either package restores into the other, and the JAX serving stack reads
the port's snapshots as its own.

Durability: the temporary file is fsynced before the rename and the
directory after it, so a rename that returned persists.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models.flow_suite import FlowSuiteState
from deepflow_tpu_torch.runtime.faults import (FAULT_CHECKPOINT_TORN,
                                               default_faults)

__all__ = ["SketchSnapshot", "SnapshotBus"]


@dataclass(frozen=True)
class SketchSnapshot:
    """One immutable published sketch state (host numpy leaves).

    `step` is the producer's window counter, `seq` the bus's own
    increasing version, `wall_time` the publish wall clock, `tags` the
    window's verdicts (`lossy`, `final`)."""

    step: int
    seq: int
    wall_time: float
    leaves: Tuple[np.ndarray, ...]
    tags: Dict[str, Any] = field(default_factory=dict)
    path: Optional[str] = None

    @property
    def age_s(self) -> float:
        return max(0.0, time.time() - self.wall_time)


def _fsync_dir(directory: str) -> None:
    """Persist a rename: fsync the directory entry."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SnapshotBus:
    """Versioned snapshot store: one publish feeds readers, the
    device-error rollback and restart replay from one format.
    `directory=None` runs it in-process only (pub/sub, no files)."""

    def __init__(self, directory: Optional[str], name: str = "sketch",
                 keep: int = 3) -> None:
        self.directory = directory
        self.name = name
        self.keep = keep
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
        self.saves = 0            # disk-bound publishes
        self.restores = 0
        self.published = 0        # every publish, in-memory ones too
        self.subscriber_errors = 0
        self.last_restored_step: int = -1   # -1 = never restored
        self._seq = 0
        self._latest: Optional[SketchSnapshot] = None
        self._subs: List[Callable[[SketchSnapshot], None]] = []
        # (path, mtime, snapshot): read_latest's one-deep disk cache, so
        # a reader polling a quiet directory gets the same snapshot back
        # (same seq) instead of a fresh npz load per query
        self._read_cache: Optional[Tuple[str, float, SketchSnapshot]] = None
        self._lock = threading.Lock()

    # -- pub/sub -------------------------------------------------------------
    def subscribe(self, fn: Callable[[SketchSnapshot], None]
                  ) -> Callable[[], None]:
        """Register an in-process subscriber; returns its unsubscribe
        callable. The latest snapshot, if any, is delivered at once."""
        with self._lock:
            self._subs.append(fn)
            latest = self._latest
        if latest is not None:
            self._notify_one(fn, latest)

        def _unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.remove(fn)
                except ValueError:
                    pass
        return _unsubscribe

    def has_subscribers(self) -> bool:
        return bool(self._subs)

    def _notify_one(self, fn, snap: SketchSnapshot) -> None:
        try:
            fn(snap)
        except Exception:
            # a broken reader must never kill the window flush
            self.subscriber_errors += 1
            logging.getLogger(__name__).exception(
                "snapshot subscriber raised; snapshot seq=%d dropped for "
                "this subscriber", snap.seq)

    def publish(self, state: Any, step: int,
                wall_time: Optional[float] = None,
                tags: Optional[Dict[str, Any]] = None,
                to_disk: bool = True) -> SketchSnapshot:
        """Copy `state` to host numpy and fan the snapshot out: a port
        FlowSuiteState goes through `convert.state_to_numpy`, any other
        state is taken as its list of host leaves (the anomaly plane's
        AlertSnapshot). `to_disk=False` skips the file."""
        return self.publish_host(self.host_leaves(state), step, wall_time,
                                 tags, to_disk)

    @staticmethod
    def host_leaves(state: Any) -> tuple:
        """`publish`'s copy of `state` to host numpy."""
        if isinstance(state, FlowSuiteState):
            return tuple(convert.state_to_numpy(state))
        return tuple(np.array(a) for a in state)

    def publish_host(self, leaves: tuple, step: int,
                     wall_time: Optional[float] = None,
                     tags: Optional[Dict[str, Any]] = None,
                     to_disk: bool = True) -> SketchSnapshot:
        """`publish` of leaves already copied by `host_leaves`, as they
        are (the exporter's close times the copy and the rest apart)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        snap = SketchSnapshot(
            step=int(step), seq=seq,
            wall_time=time.time() if wall_time is None else float(wall_time),
            leaves=leaves, tags=dict(tags or {}))
        if to_disk and self.directory is not None:
            snap = self._write(snap)
            self.saves += 1
        self.published += 1
        with self._lock:
            self._latest = snap
            subs = list(self._subs)
        for fn in subs:
            self._notify_one(fn, snap)
        return snap

    def save(self, state: Any, step: int) -> str:
        """The checkpointer surface: publish to disk, return the path
        ("" when the bus has no directory)."""
        return self.publish(state, step).path or ""

    def _write(self, snap: SketchSnapshot) -> SketchSnapshot:
        path = os.path.join(self.directory,
                            f"{self.name}-{snap.step:012d}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(snap.leaves)},
                     __step=np.asarray(snap.step, np.int64),
                     __wall=np.asarray(snap.wall_time, np.float64),
                     __tags=np.asarray(json.dumps(snap.tags)))
            f.flush()
            os.fsync(f.fileno())
        faults = default_faults()
        if faults.enabled and faults.should_fire(FAULT_CHECKPOINT_TORN,
                                                 key=self.name):
            # chaos: a truncated file that still reaches its final name;
            # restore must skip it
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(1, size // 2))
        os.replace(tmp, path)
        _fsync_dir(self.directory)
        self._gc()
        return dataclasses.replace(snap, path=path)

    def _snapshots(self) -> list:
        if self.directory is None or not os.path.isdir(self.directory):
            return []
        out = []
        for f in sorted(os.listdir(self.directory)):
            if not (f.startswith(self.name + "-") and f.endswith(".npz")):
                continue
            if not f[len(self.name) + 1:-4].isdigit():
                continue                # a foreign or malformed name
            out.append(f)
        return out

    def _gc(self) -> None:
        for f in self._snapshots()[:-self.keep]:
            try:
                os.unlink(os.path.join(self.directory, f))
            except OSError:
                pass

    # -- reads ---------------------------------------------------------------
    def latest(self) -> Optional[SketchSnapshot]:
        """Newest snapshot published here, else the newest on disk."""
        with self._lock:
            latest = self._latest
        if latest is not None:
            return latest
        return self.read_latest()

    def read_latest(self) -> Optional[SketchSnapshot]:
        """The newest parseable snapshot on disk (torn files skipped),
        without shape validation. An unchanged file returns the snapshot
        read before."""
        for fname in reversed(self._snapshots()):
            path = os.path.join(self.directory, fname)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            cached = self._read_cache
            if cached is not None and cached[0] == path \
                    and cached[1] == mtime:
                return cached[2]
            try:
                with np.load(path) as z:
                    n = sum(1 for k in z.files if k.startswith("leaf_"))
                    leaves = tuple(z[f"leaf_{i}"] for i in range(n))
                    step = int(z["__step"]) if "__step" in z.files else \
                        int(fname[len(self.name) + 1:-4])
                    wall = float(z["__wall"]) if "__wall" in z.files \
                        else mtime
                    tags = json.loads(str(z["__tags"])) \
                        if "__tags" in z.files else {}
            except Exception:
                continue
            with self._lock:
                self._seq += 1
                seq = self._seq
            snap = SketchSnapshot(step=step, seq=seq, wall_time=wall,
                                  leaves=leaves, tags=tags, path=path)
            self._read_cache = (path, mtime, snap)
            return snap
        return None

    # -- restore -------------------------------------------------------------
    def restore(self, like: Any) -> Optional[Any]:
        """The newest compatible snapshot as a fresh port FlowSuiteState
        on `like`'s device (`like`: a freshly initialized state). None
        when there is no snapshot or none matches the current config's
        leaf count, shapes and dtypes. The step restored lands in
        `last_restored_step`."""
        specs = convert.leaf_specs(like)
        device = like.rows_seen.device
        for fname in reversed(self._snapshots()):
            path = os.path.join(self.directory, fname)
            try:
                with np.load(path) as z:
                    # the stored leaf COUNT must match exactly: a snapshot
                    # of another config must be refused, not half-loaded
                    stored = sum(1 for k in z.files if k.startswith("leaf_"))
                    if stored != len(specs):
                        continue
                    loaded = [z[f"leaf_{i}"] for i in range(len(specs))]
            except Exception:
                # torn or foreign file (np.load raises OSError,
                # BadZipFile, EOFError, ...): try the previous snapshot
                continue
            if not all(a.shape == shape and a.dtype == dtype
                       for a, (shape, dtype) in zip(loaded, specs)):
                continue
            self.restores += 1
            self.last_restored_step = int(fname[len(self.name) + 1:-4])
            state, _ = convert.state_from_numpy(loaded, device=device)
            return state
        return None

    def latest_step(self) -> Optional[int]:
        snaps = self._snapshots()
        if not snaps:
            return None
        return int(snaps[-1][len(self.name) + 1:-4])

    def counters(self) -> dict:
        return {"saves": self.saves, "restores": self.restores,
                "snapshots": len(self._snapshots()),
                "published": self.published,
                "subscribers": len(self._subs),
                "subscriber_errors": self.subscriber_errors,
                "last_restored_step": self.last_restored_step}
