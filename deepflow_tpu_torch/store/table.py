"""Schema-as-code table definitions (reference: server/libs/ckdb/ckdb.go).

A TableSchema declares columns with dtypes, the time column used for
partitioning/TTL, and per-column aggregation kinds used when the rollup
manager materializes coarser intervals (reference: datasource/handle.go
builds SumMax/Min materialized views; here the agg kind lives on the column
so rollups are derivable for any table).

A copy of the JAX package's store/table.py (this package imports none of
it): a store directory holds `manifest.json` from `TableSchema.to_json`,
and either package's Store rewrites it from its own `from_json`, so the
JSON of a schema must be the same from both.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


class AggKind(enum.Enum):
    """How a column folds when rows collapse into a coarser time bucket."""

    KEY = "key"       # part of the group-by identity
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    LAST = "last"     # arbitrary representative (tags constant per key)
    COUNT = "count"   # becomes the collapsed row count


@dataclass(frozen=True)
class ColumnSpec:
    name: str
    dtype: np.dtype
    agg: AggKind = AggKind.LAST
    default: int = 0

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": np.dtype(self.dtype).str,
                "agg": self.agg.value, "default": self.default}

    @staticmethod
    def from_json(d: dict) -> "ColumnSpec":
        return ColumnSpec(d["name"], np.dtype(d["dtype"]),
                          AggKind(d["agg"]), d.get("default", 0))


@dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnSpec, ...]
    time_column: str = "timestamp"       # uint32 epoch seconds
    partition_seconds: int = 3600        # one partition dir per hour
    ttl_seconds: Optional[int] = 7 * 24 * 3600
    version: int = 1
    # rename history (old, new): lets readers resolve current names in
    # segments written before a migration (reference: ckissu RunRenameTable
    # renames in-place; immutable segments make it metadata-only here)
    aliases: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column in {self.name}")
        if self.time_column not in names:
            raise ValueError(f"{self.name}: time column {self.time_column!r} "
                             "not among columns")

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def spec(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def dtypes(self) -> Dict[str, np.dtype]:
        return {c.name: np.dtype(c.dtype) for c in self.columns}

    def alloc(self, n: int) -> Dict[str, np.ndarray]:
        return {c.name: np.full(n, c.default, dtype=c.dtype)
                for c in self.columns}

    def validate_chunk(self, cols: Dict[str, np.ndarray]) -> int:
        """Check a columnar chunk matches the schema; returns row count.
        Missing columns are an error; extra columns are ignored by writers."""
        n = -1
        for c in self.columns:
            if c.name not in cols:
                raise KeyError(f"{self.name}: chunk missing column {c.name}")
            a = cols[c.name]
            if n < 0:
                n = len(a)
            elif len(a) != n:
                raise ValueError(f"{self.name}: ragged chunk at {c.name}")
        return max(n, 0)

    def stored_names(self, name: str) -> Tuple[str, ...]:
        """Current name first, then older names a segment may carry."""
        names = [name]
        for old, new in reversed(self.aliases):
            if new in names:
                names.append(old)
        return tuple(names)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "columns": [c.to_json() for c in self.columns],
            "time_column": self.time_column,
            "partition_seconds": self.partition_seconds,
            "ttl_seconds": self.ttl_seconds,
            "version": self.version,
            "aliases": [list(a) for a in self.aliases],
        }

    @staticmethod
    def from_json(d: dict) -> "TableSchema":
        return TableSchema(
            name=d["name"],
            columns=tuple(ColumnSpec.from_json(c) for c in d["columns"]),
            time_column=d["time_column"],
            partition_seconds=d["partition_seconds"],
            ttl_seconds=d["ttl_seconds"],
            version=d.get("version", 1),
            aliases=tuple(tuple(a) for a in d.get("aliases", ())),
        )


def schema_from_batch_schema(batch_schema, aggs: Dict[str, AggKind],
                             **kw) -> TableSchema:
    """Lift a batch.schema.Schema (decode-stage layout) into a store table."""
    cols = tuple(
        ColumnSpec(name, np.dtype(dt), aggs.get(name, AggKind.LAST))
        for name, dt in batch_schema.columns)
    return TableSchema(name=batch_schema.name, columns=cols, **kw)
