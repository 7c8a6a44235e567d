"""Columnar storage engine: the framework's ClickHouse-role subsystem.

Time-partitioned columnar segments (one numpy array per column) with
schema-as-code tables, batched writers, in-place schema migration, rollup
tiers whose GROUP BY runs as torch segment reductions, and disk-watermark
GC (reference: server/ingester/pkg/ckwriter, server/libs/ckdb,
server/ingester/ckissu, server/ingester/datasource,
server/ingester/ckmonitor).

The public names resolve on first use: the rollup imports torch, and the
host-only roles (the controller's dictionary hashing) import
`store.dict_store` without it.
"""

from deepflow_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "AggKind": "table",
    "ColumnSpec": "table",
    "TableSchema": "table",
    "Store": "db",
    "Table": "db",
    "StoreWriter": "writer",
    "RollupManager": "rollup",
    "DiskMonitor": "monitor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
