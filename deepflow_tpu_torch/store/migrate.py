"""In-service schema upgrade (reference: server/ingester/ckissu/ckissu.go).

The reference replays versioned ALTER batches (column adds/renames, table
renames) against live ClickHouse at startup. Segments here are immutable,
so every migration is metadata-only and O(1): adds register a default the
reader synthesizes for pre-migration segments, renames append to the alias
history the reader resolves through, drops remove the column from the
schema (bytes on disk become unreferenced).

Migrations are (version, op) records; `Issu.run()` applies every op newer
than the table's manifest version, exactly once, in order. The manifest
it rewrites is the JAX package's format, so either package's Store
reads an upgraded table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.table import ColumnSpec, TableSchema


@dataclass(frozen=True)
class AddColumn:
    table: str
    spec: ColumnSpec

    def apply(self, schema: TableSchema) -> TableSchema:
        if any(c.name == self.spec.name for c in schema.columns):
            return schema  # idempotent re-run
        return dataclasses.replace(schema,
                                   columns=schema.columns + (self.spec,))


@dataclass(frozen=True)
class RenameColumn:
    table: str
    old: str
    new: str

    def apply(self, schema: TableSchema) -> TableSchema:
        if not any(c.name == self.old for c in schema.columns):
            return schema
        cols = tuple(dataclasses.replace(c, name=self.new)
                     if c.name == self.old else c for c in schema.columns)
        time_col = self.new if schema.time_column == self.old \
            else schema.time_column
        return dataclasses.replace(
            schema, columns=cols, time_column=time_col,
            aliases=schema.aliases + ((self.old, self.new),))


@dataclass(frozen=True)
class DropColumn:
    table: str
    name: str

    def apply(self, schema: TableSchema) -> TableSchema:
        if schema.time_column == self.name:
            raise ValueError(f"cannot drop time column {self.name}")
        return dataclasses.replace(
            schema,
            columns=tuple(c for c in schema.columns if c.name != self.name))


class Issu:
    """Ordered migration registry for one database."""

    def __init__(self, store: Store, db: str) -> None:
        self.store = store
        self.db = db
        self._migrations: List[Tuple[int, object]] = []

    def register(self, version: int, op) -> None:
        self._migrations.append((version, op))

    def run(self) -> Dict[str, int]:
        """Apply pending migrations; returns {table: new_version}."""
        self._migrations.sort(key=lambda vo: vo[0])
        touched: Dict[str, int] = {}
        for version, op in self._migrations:
            if not self.store.has_table(self.db, op.table):
                continue
            t = self.store.table(self.db, op.table)
            if t.schema.version >= version:
                continue
            new_schema = dataclasses.replace(op.apply(t.schema),
                                             version=version)
            t.schema = new_schema
            t._save_manifest()
            touched[op.table] = version
        return touched
