"""Record -> tensor batching with static shapes (host numpy).

Accumulates decoded column chunks into fixed-capacity host buffers and
emits `TensorBatch`es of exactly `capacity` rows -- full ones as the
stream runs, padded ones (valid < capacity) at a window flush -- so the
device step always sees one shape. Emitted buffers may come back through
`recycle()` and are reused instead of allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class Schema:
    name: str
    columns: Tuple[Tuple[str, np.dtype], ...]

    def alloc(self, capacity: int) -> Dict[str, np.ndarray]:
        return {n: np.zeros(capacity, dtype=d) for n, d in self.columns}

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.columns)

    def row_bytes(self) -> int:
        return sum(np.dtype(d).itemsize for _, d in self.columns)

    def coerce(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Project a decoded chunk onto the schema: contiguous casts for
        present columns, zeros for absent ones."""
        n = len(next(iter(cols.values()))) if cols else 0
        return {name: np.ascontiguousarray(cols[name]).astype(dt, copy=False)
                if name in cols else np.zeros(n, dt)
                for name, dt in self.columns}


_U32, _I32 = np.uint32, np.int32

# The columns the l4 sketch step reads, plus the batcher's bookkeeping
# keys: the core block of the l4_flow_log schema.
SKETCH_L4_SCHEMA = Schema(name="l4_sketch", columns=(
    ("ip_src", _U32), ("ip_dst", _U32), ("port_src", _U32),
    ("port_dst", _U32), ("proto", _U32), ("vtap_id", _U32),
    ("tap_side", _U32), ("l3_epc_id", _I32), ("byte_tx", _U32),
    ("byte_rx", _U32), ("packet_tx", _U32), ("packet_rx", _U32),
    ("rtt", _U32), ("retrans", _U32), ("close_type", _U32),
    ("timestamp", _U32), ("duration_us", _U32),
))


@dataclass
class TensorBatch:
    """A fixed-shape columnar batch; rows >= valid are padding."""

    columns: Dict[str, np.ndarray]
    valid: int

    @property
    def capacity(self) -> int:
        return 0 if not self.columns else len(next(iter(self.columns.values())))

    def mask(self) -> np.ndarray:
        return np.arange(self.capacity) < self.valid


class Batcher:
    """Accumulates column chunks; yields full static-shape batches."""

    _POOL_CAP = 8        # returned buffers retained

    def __init__(self, schema: Schema, capacity: int) -> None:
        self.schema = schema
        self.capacity = capacity
        self._buf = schema.alloc(capacity)
        self._fill = 0
        self._pool: list = []
        self.total_rows = 0
        self.emitted_batches = 0
        self.recycled = 0
        self.pool_hits = 0

    def put(self, cols: Dict[str, np.ndarray]) -> Iterator[TensorBatch]:
        """Append a chunk; yield zero or more exactly-full batches."""
        n = len(cols[self.schema.names[0]])
        self.total_rows += n
        off = 0
        while n - off > 0:
            take = min(self.capacity - self._fill, n - off)
            for name in self.schema.names:
                self._buf[name][self._fill:self._fill + take] = \
                    cols[name][off:off + take]
            self._fill += take
            off += take
            if self._fill == self.capacity:
                yield self._emit(self.capacity)

    def flush(self) -> Iterator[TensorBatch]:
        """Emit the partial remainder (padded), e.g. at a window boundary."""
        if self._fill > 0:
            yield self._emit(self._fill)

    def recycle(self, batch: TensorBatch) -> None:
        """Return an emitted batch's buffers for reuse once fully read."""
        cols = batch.columns
        if (len(self._pool) >= self._POOL_CAP
                or batch.capacity != self.capacity
                or set(cols) != set(self.schema.names)):
            return
        self.recycled += 1
        self._pool.append(cols)

    def _emit(self, valid: int) -> TensorBatch:
        out = self._buf
        if valid < self.capacity:
            for n in self.schema.names:
                out[n][valid:] = 0
        try:
            self._buf = self._pool.pop()
            self.pool_hits += 1
        except IndexError:
            self._buf = self.schema.alloc(self.capacity)
        self._fill = 0
        self.emitted_batches += 1
        return TensorBatch(columns=out, valid=valid)
