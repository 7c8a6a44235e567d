"""Store root and Table: the time-partitioned columnar store, in the JAX
package's on-disk layout (one directory per partition, one .npz per
flushed segment):

    <root>/<db>/<table>/manifest.json
    <root>/<db>/<table>/p<partition_start>/seg-<seq>.npz
    <root>/<db>/<table>/p<partition_start>/merged.json   (compaction)

A segment is written once (to `.tmp`, then renamed into place) and never
changed, so either package scans what the other writes, compacted
partitions and quarantined segments included. The read half: `scan`
prunes partitions and then rows, fills migration defaults for columns
newer than a segment and serves around a torn segment (counted in
`segments_skipped_corrupt`); `compact` merges a partition's small
segments (quarantining a corrupt one as `.bad`); TTL expiry and
watermark GC drop whole partition directories.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deepflow_tpu_torch.store.table import TableSchema

MANIFEST = "manifest.json"

# what a torn/corrupt .npz raises: BadZipFile on open or CRC check,
# ValueError/EOFError from a truncated member. Distinct from OSError
# (transient IO / GC race), which must be retried, never quarantined.
CORRUPT_SEGMENT_ERRORS = (zipfile.BadZipFile, ValueError, EOFError)


def _partition_dir(start: int) -> str:
    return f"p{start:012d}"


def _partition_start_of(name: str) -> int:
    return int(name[1:])


class Table:
    """One columnar table: append segments, scan partitions, expire TTL."""

    def __init__(self, root: str, schema: TableSchema) -> None:
        self.root = root
        self.schema = schema
        self._lock = threading.Lock()
        # held across a whole compaction sweep: two overlapping sweeps
        # could merge overlapping source sets and the last-writer-wins
        # merged.json would leave one merged segment untracked (rows
        # double-counted forever). Non-blocking acquire: a second caller
        # skips the sweep instead of queueing behind it.
        self._compact_lock = threading.Lock()
        self._seq = 0
        os.makedirs(root, exist_ok=True)
        self._save_manifest()
        # resume the segment sequence after a restart; clear half-written
        # .tmp segments left by a crash mid-append
        for p in self.partitions():
            pdir = os.path.join(self.root, _partition_dir(p))
            for f in os.listdir(pdir):
                if f.endswith(".tmp"):
                    os.unlink(os.path.join(pdir, f))
                elif f.startswith("seg-") and f.endswith(".npz"):
                    self._seq = max(self._seq, int(f[4:-4]) + 1)
        self.rows_written = 0
        self.segments_written = 0
        self.segments_compacted = 0
        self.segments_quarantined = 0
        self.segments_skipped_corrupt = 0

    # -- manifest ----------------------------------------------------------
    def _save_manifest(self) -> None:
        tmp = os.path.join(self.root, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.schema.to_json(), f, indent=1)
        os.replace(tmp, os.path.join(self.root, MANIFEST))

    # -- write path --------------------------------------------------------
    def append(self, cols: Dict[str, np.ndarray]) -> int:
        """Write one columnar chunk as >= 1 segments, split by partition.
        Returns rows written. Thread-safe."""
        n = self.schema.validate_chunk(cols)
        if n == 0:
            return 0
        ts = np.asarray(cols[self.schema.time_column], dtype=np.int64)
        psec = self.schema.partition_seconds
        part = (ts // psec) * psec
        with self._lock:
            for p in np.unique(part):
                sel = part == p
                seg = {c.name: np.ascontiguousarray(
                           np.asarray(cols[c.name])[sel].astype(c.dtype,
                                                                copy=False))
                       for c in self.schema.columns}
                pdir = os.path.join(self.root, _partition_dir(int(p)))
                os.makedirs(pdir, exist_ok=True)
                path = os.path.join(pdir, f"seg-{self._seq:08d}.npz")
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, **seg)
                os.replace(tmp, path)
                self._seq += 1
                self.segments_written += 1
            self.rows_written += n
        return n

    # -- read path ---------------------------------------------------------
    def _read_segment(self, path: str,
                      names: Sequence[str]) -> Dict[str, np.ndarray]:
        """Load logical columns `names` from one segment, filling
        migration defaults for columns newer than the segment. The
        chunk is fully staged before return, so a mid-read failure
        never leaks a partial result. Raises what np.load raises —
        callers classify via CORRUPT_SEGMENT_ERRORS vs OSError."""
        chunk: Dict[str, np.ndarray] = {}
        with np.load(path) as z:
            length = None     # lazily: NpzFile reads decompress every
            for nm in names:  # time — don't pay one just for a shape
                stored = next((s for s in self.schema.stored_names(nm)
                               if s in z.files), None)
                if stored is not None:
                    chunk[nm] = z[stored]
                else:
                    if length is None:
                        length = (next(iter(chunk.values())).shape[0]
                                  if chunk else z[z.files[0]].shape[0])
                    spec = self.schema.spec(nm)
                    chunk[nm] = np.full(length, spec.default,
                                        dtype=spec.dtype)
        return chunk

    def partitions(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        return sorted(_partition_start_of(d) for d in os.listdir(self.root)
                      if d.startswith("p") and d[1:].isdigit())

    def _segment_files(self, partitions: Iterable[int]) -> List[str]:
        files: List[str] = []
        for p in partitions:
            pdir = os.path.join(self.root, _partition_dir(p))
            if not os.path.isdir(pdir):
                continue
            listing = sorted(f for f in os.listdir(pdir)
                             if f.startswith("seg-") and f.endswith(".npz"))
            # compaction superseded-set: skip sources whose merged
            # segment is present in THIS listing (sources linger one
            # sweep for in-flight readers; counting both would double)
            manifest = self._merged_manifest(pdir)
            have = set(listing)
            superseded = {s for merged, srcs in manifest.items()
                          if merged in have for s in srcs}
            files.extend(os.path.join(pdir, f) for f in listing
                         if f not in superseded)
        return files

    def scan(self, columns: Optional[Sequence[str]] = None,
             time_range: Optional[Tuple[int, int]] = None
             ) -> Dict[str, np.ndarray]:
        """Concatenate requested columns across partitions.

        `time_range` is [lo, hi) on the time column; partition pruning first,
        then row filtering — the two-level pruning ClickHouse does with
        partition keys + primary index.
        """
        names = list(columns) if columns is not None else \
            list(self.schema.column_names)
        for nm in names:
            self.schema.spec(nm)  # raises on unknown column
        parts = self.partitions()
        if time_range is not None:
            lo, hi = time_range
            psec = self.schema.partition_seconds
            parts = [p for p in parts if p + psec > lo and p < hi]
        need_time = (time_range is not None and
                     self.schema.time_column not in names)
        load_names = names + [self.schema.time_column] if need_time else names
        out: Dict[str, List[np.ndarray]] = {nm: [] for nm in names}
        for path in self._segment_files(parts):
            # OSError: partition force-dropped by GC mid-scan or
            # transient IO — skip. CORRUPT_SEGMENT_ERRORS: a torn
            # segment — served around (the way ClickHouse serves around
            # a broken part; compact() quarantines it next sweep) and
            # counted so empty results are diagnosable. Anything else
            # (a schema/code bug) propagates loudly.
            try:
                chunk = self._read_segment(path, load_names)
            except OSError:
                continue
            except CORRUPT_SEGMENT_ERRORS:
                self.segments_skipped_corrupt += 1
                continue
            if time_range is not None:
                t = chunk[self.schema.time_column].astype(np.int64)
                sel = (t >= time_range[0]) & (t < time_range[1])
                for nm in names:
                    out[nm].append(chunk[nm][sel])
            else:
                for nm in names:
                    out[nm].append(chunk[nm])
        return {nm: (np.concatenate(v) if v else
                     np.empty(0, dtype=self.schema.spec(nm).dtype))
                for nm, v in out.items()}

    # -- compaction --------------------------------------------------------
    # The reference leans on ClickHouse background merges to keep part
    # counts bounded; this store's analogue merges a partition's small
    # segments into one. Swap protocol (scan() stays lockless): the
    # merged segment lands atomically, merged.json records which source
    # segments it supersedes, and the sources are DELETED ONE SWEEP
    # LATER — a reader that listed before the manifest update still
    # loads the sources (no merged file in its listing: correct), one
    # that listed after skips them via the manifest (correct), and by
    # the deferred delete every in-flight scan is long done.
    def _merged_manifest(self, pdir: str) -> Dict[str, List[str]]:
        path = os.path.join(pdir, "merged.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return {}

    def compact(self, max_segment_bytes: int = 64 << 20,
                min_segments: int = 8, max_sources: int = 64) -> int:
        """Merge each partition's small segments (one pass); returns
        segments removed from circulation. Call periodically (the disk
        monitor does). At most max_sources (and max_segment_bytes of
        input) merge per partition per sweep — an unbounded concat of a
        large backlog would balloon the monitor thread's memory the way
        ClickHouse bounds merge input sizes to avoid."""
        if not self._compact_lock.acquire(blocking=False):
            return 0    # another sweep in flight; overlap would corrupt
        try:
            return self._compact_locked(max_segment_bytes, min_segments,
                                        max_sources)
        finally:
            self._compact_lock.release()

    def _compact_locked(self, max_segment_bytes: int, min_segments: int,
                        max_sources: int) -> int:
        removed = 0
        for p in self.partitions():
            pdir = os.path.join(self.root, _partition_dir(p))
            manifest = self._merged_manifest(pdir)
            # phase 1: delete sources superseded by a PREVIOUS sweep
            done = []
            for merged, sources in manifest.items():
                if os.path.exists(os.path.join(pdir, merged)):
                    for s in sources:
                        try:
                            os.unlink(os.path.join(pdir, s))
                        except FileNotFoundError:
                            pass
                done.append(merged)
            if done:
                manifest = {}
                self._write_merged_manifest(pdir, manifest)
            # phase 2: merge this sweep's small segments (bounded input)
            small = []
            small_bytes = 0
            for f in sorted(os.listdir(pdir)):
                if not (f.startswith("seg-") and f.endswith(".npz")):
                    continue
                fp = os.path.join(pdir, f)
                try:
                    sz = os.path.getsize(fp)
                except OSError:
                    continue
                if sz < max_segment_bytes:
                    if (len(small) >= max_sources
                            or small_bytes + sz > max_segment_bytes):
                        break       # rest merges on later sweeps
                    small.append(f)
                    small_bytes += sz
            if len(small) < min_segments:
                continue
            cols: Dict[str, List[np.ndarray]] = {
                c.name: [] for c in self.schema.columns}
            ok: List[str] = []
            for f in small:
                fp = os.path.join(pdir, f)
                try:
                    chunk = self._read_segment(
                        fp, [c.name for c in self.schema.columns])
                except OSError:
                    # gone (GC race) or transient IO (EIO/ESTALE on a
                    # flaky mount): skip and retry next sweep — a
                    # healthy segment must never be quarantined for a
                    # one-off read error
                    continue
                except CORRUPT_SEGMENT_ERRORS:
                    # quarantine (ClickHouse detaches broken parts): a
                    # corrupt segment left in place would occupy this
                    # sweep's bounded merge budget on EVERY sweep and
                    # could block the partition's compaction forever
                    try:
                        os.replace(fp, fp + ".bad")
                        self.segments_quarantined += 1
                    except OSError:
                        pass
                    continue
                for nm, arr in chunk.items():
                    cols[nm].append(arr)
                ok.append(f)
            if len(ok) < min_segments:
                continue
            seg = {nm: np.ascontiguousarray(
                       np.concatenate(v).astype(
                           self.schema.spec(nm).dtype, copy=False))
                   for nm, v in cols.items()}
            with self._lock:
                name = f"seg-{self._seq:08d}.npz"
                self._seq += 1
            path = os.path.join(pdir, name)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **seg)
            # ORDER IS THE PROTOCOL: manifest first, merged segment
            # second. A reader between the two steps sees the manifest
            # entry but no merged file in its listing ('merged in have'
            # fails) and correctly loads the sources; the reverse order
            # would double-count — and a crash between the steps would
            # double-count PERMANENTLY. A crash after the manifest but
            # before the replace leaves a dangling entry phase 1 later
            # discards harmlessly.
            manifest[name] = ok
            self._write_merged_manifest(pdir, manifest)
            os.replace(tmp, path)
            removed += len(ok)
            self.segments_compacted += len(ok)
        return removed

    def _write_merged_manifest(self, pdir: str,
                               manifest: Dict[str, List[str]]) -> None:
        path = os.path.join(pdir, "merged.json")
        if not manifest:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def row_count(self) -> int:
        total = 0
        for path in self._segment_files(self.partitions()):
            try:
                with np.load(path) as z:
                    total += z[z.files[0]].shape[0]
            except OSError:
                continue
            except CORRUPT_SEGMENT_ERRORS:
                # same contract as scan(): serve around a torn segment
                # until compact() quarantines it
                self.segments_skipped_corrupt += 1
                continue
        return total

    # -- retention ---------------------------------------------------------
    def set_ttl(self, ttl_seconds: Optional[int]) -> None:
        """Change this table's retention and persist it (the reference's
        datasource retention-time update, datasource/handle.go TTL
        ALTERs). Takes effect at the next expire() sweep."""
        import dataclasses
        with self._lock:
            self.schema = dataclasses.replace(self.schema,
                                              ttl_seconds=ttl_seconds)
            self._save_manifest()

    def expire(self, now: Optional[float] = None) -> int:
        """Drop partitions past TTL; returns partitions dropped."""
        if self.schema.ttl_seconds is None:
            return 0
        now = time.time() if now is None else now
        cutoff = now - self.schema.ttl_seconds
        dropped = 0
        for p in self.partitions():
            if p + self.schema.partition_seconds <= cutoff:
                self.drop_partition(p)
                dropped += 1
        return dropped

    def drop_partition(self, start: int) -> None:
        shutil.rmtree(os.path.join(self.root, _partition_dir(start)),
                      ignore_errors=True)

    def _physical_bytes(self, partitions: Iterable[int]) -> int:
        """PHYSICAL on-disk bytes — includes superseded compaction
        sources that linger one sweep. Watermark GC must see real disk
        usage or a tightly sized volume hits ENOSPC while GC reports
        headroom."""
        total = 0
        for p in partitions:
            pdir = os.path.join(self.root, _partition_dir(p))
            if not os.path.isdir(pdir):
                continue
            for f in os.listdir(pdir):
                # .bad = quarantined corrupt segments — still on disk,
                # still counted, or watermark GC under-reports usage
                if f.endswith(".npz") or f.endswith(".bad"):
                    try:
                        total += os.path.getsize(os.path.join(pdir, f))
                    except OSError:
                        continue
        return total

    def disk_bytes(self) -> int:
        return self._physical_bytes(self.partitions())

    def partition_bytes(self, start: int) -> int:
        return self._physical_bytes([start])

    def counters(self) -> dict:
        return {"rows_written": self.rows_written,
                "segments_written": self.segments_written,
                "segments_compacted": self.segments_compacted,
                "segments_quarantined": self.segments_quarantined,
                "segments_skipped_corrupt": self.segments_skipped_corrupt,
                "partitions": len(self.partitions())}


class Store:
    """Root handle: databases of tables under one directory tree. Tables
    already on disk are opened from their manifests."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._tables: Dict[Tuple[str, str], Table] = {}
        self._lock = threading.Lock()
        self._load_existing()

    def _load_existing(self) -> None:
        for db in sorted(os.listdir(self.root)):
            dbdir = os.path.join(self.root, db)
            if not os.path.isdir(dbdir):
                continue
            for tname in sorted(os.listdir(dbdir)):
                man = os.path.join(dbdir, tname, MANIFEST)
                if os.path.isfile(man):
                    with open(man) as f:
                        schema = TableSchema.from_json(json.load(f))
                    self._tables[(db, tname)] = Table(
                        os.path.join(dbdir, tname), schema)

    def create_table(self, db: str, schema: TableSchema) -> Table:
        """The table `db.schema.name`, created if it is not open yet."""
        with self._lock:
            key = (db, schema.name)
            if key not in self._tables:
                self._tables[key] = Table(
                    os.path.join(self.root, db, schema.name), schema)
            return self._tables[key]

    def table(self, db: str, name: str) -> Table:
        with self._lock:
            return self._tables[(db, name)]

    def has_table(self, db: str, name: str) -> bool:
        with self._lock:
            return (db, name) in self._tables

    def tables(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._tables.keys())

    def _snapshot(self) -> List[Table]:
        # runtime datasource CRUD mutates _tables from the debug-socket
        # thread; sweepers iterate a snapshot, never the live dict
        with self._lock:
            return list(self._tables.values())

    def drop_table(self, db: str, name: str) -> bool:
        """Delete a table and its data (the reference's datasource del
        DROP TABLE). Only callers that own the table's write path should
        drop it — a concurrent writer would recreate stray segment files."""
        with self._lock:
            t = self._tables.pop((db, name), None)
        if t is None:
            return False
        shutil.rmtree(t.root, ignore_errors=True)
        return True

    def expire_all(self, now: Optional[float] = None) -> int:
        return sum(t.expire(now) for t in self._snapshot())

    def disk_bytes(self) -> int:
        return sum(t.disk_bytes() for t in self._snapshot())
