"""Store root and Table: the write half of the time-partitioned columnar
store, in the JAX package's on-disk layout (one directory per partition,
one .npz per flushed segment):

    <root>/<db>/<table>/manifest.json
    <root>/<db>/<table>/p<partition_start>/seg-<seq>.npz

A segment is written once (to `.tmp`, then renamed into place) and never
changed, so the JAX package's querier and Store scan what this one
writes. Scans, compaction, TTL expiry and quarantine are the reader's
side and live there.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Tuple

import numpy as np

from deepflow_tpu_torch.store.table import TableSchema

MANIFEST = "manifest.json"


def _partition_dir(start: int) -> str:
    return f"p{start:012d}"


class Table:
    """One columnar table: append segments split by partition."""

    def __init__(self, root: str, schema: TableSchema) -> None:
        self.root = root
        self.schema = schema
        self._lock = threading.Lock()
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

    def _save_manifest(self) -> None:
        tmp = os.path.join(self.root, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.schema.to_json(), f, indent=1)
        os.replace(tmp, os.path.join(self.root, MANIFEST))

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

    def partitions(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        return sorted(int(d[1:]) for d in os.listdir(self.root)
                      if d.startswith("p") and d[1:].isdigit())

    def counters(self) -> dict:
        return {"rows_written": self.rows_written,
                "segments_written": self.segments_written,
                "partitions": len(self.partitions())}


class Store:
    """Root handle: databases of tables under one directory tree. Tables
    already on disk are opened from their manifests."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._tables: Dict[Tuple[str, str], Table] = {}
        self._lock = threading.Lock()
        for db in sorted(os.listdir(root)):
            dbdir = os.path.join(root, db)
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
