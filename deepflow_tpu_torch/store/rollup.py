"""Rollup manager: coarser-interval tables, with the GROUP BY on the card.

Reference: server/ingester/datasource/handle.go builds ClickHouse
materialized views that collapse 1s tables into 1m/1h rows with
Sum/Max/Min aggregate functions. Here, as in the JAX package, rows are
bucketed by (key columns, floor(time/interval)) and collapsed by an
exact GROUP BY, `group_reduce`, in one of two ways:

- the host path: group ids from a host lexsort over the int64-cast keys
  (`_unique_rows`, exact and in lexicographic key order), then every
  value column copied at its own width (32-bit words for the u32
  meters), widened to int64 and reduced on the card (`_segment_reduce`:
  one `index_add_` for the sums, one for the counts, one
  `scatter_reduce_` each for the mins and for the maxes), and the
  reduced block copied back once;
- the device path (`group_reduce_device`): keys ride u32 lanes (signed
  keys sign-bit-flipped, so they order as int64), packed two to an int64
  whose high half is offset by 2^31 so that signed order is lane order;
  stable argsorts from the least significant packed key to the most give
  the lexicographic order, boundaries between sorted rows give cumsum
  group ids, and the same segment reduce runs over the unsorted values.
  One read of the group count, one copy of the reduced groups back.

Both return the groups in the host path's order, and equal the JAX
package's `group_reduce` column for column. XLA's static-shape padding
is not needed in eager torch and is gone; masked rows still reduce into
the trash segment `num_segments - 1` with neutral values.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.store.db import Store, Table
from deepflow_tpu_torch.store.table import AggKind, TableSchema

_I64_MIN = int(np.iinfo(np.int64).min)
_I64_MAX = int(np.iinfo(np.int64).max)

# `auto` takes the device path from this many rows on (the reference's
# threshold, kept as it is)
AUTO_DEVICE_ROWS = 1 << 18

# rollup_schema ttl sentinel (identity object: no integer the debug
# socket could pass collides with it): derive 30x the base retention
TTL_DERIVE = object()

# -- external datasources ---------------------------------------------------
# Virtual datasources that live beside the rollup tiers in the
# `datasource list` surface but are not derived tables (serving's sketch
# tables register a provider callable returning their listing rows).
# Process-scoped; providers must be cheap (called per debug command).
_EXTERNAL_DATASOURCES: Dict[str, "Callable[[], List[dict]]"] = {}
_EXTERNAL_LOCK = threading.Lock()


def register_datasource(name: str, provider) -> None:
    """Register a virtual datasource provider (rows for list)."""
    with _EXTERNAL_LOCK:
        _EXTERNAL_DATASOURCES[name] = provider


def unregister_datasource(name: str) -> None:
    with _EXTERNAL_LOCK:
        _EXTERNAL_DATASOURCES.pop(name, None)


def external_datasources() -> List[dict]:
    """Rows from every registered virtual datasource; a broken provider
    contributes an error row instead of killing the listing."""
    with _EXTERNAL_LOCK:
        providers = dict(_EXTERNAL_DATASOURCES)
    rows: List[dict] = []
    for name, provider in sorted(providers.items()):
        try:
            rows.extend(provider())
        except Exception as e:   # the debug socket must still answer
            rows.append({"table": name, "kind": "external",
                         "error": str(e)[:200]})
    return rows


# one shared table for both naming directions; inverse derived
_NAMED_SUFFIXES = {60: "1m", 3600: "1h", 86400: "1d"}
_SUFFIX_INTERVALS = {v: k for k, v in _NAMED_SUFFIXES.items()}


def _interval_suffix(interval: int) -> str:
    return _NAMED_SUFFIXES.get(interval, f"{interval}s")


def interval_from_table_name(base_name: str, table_name: str
                             ) -> Optional[int]:
    """Inverse of rollup_schema's naming: `vtap_flow_port.1h` -> 3600
    for base `vtap_flow_port`; None if not a rollup of this base."""
    if not table_name.startswith(base_name + "."):
        return None
    suffix = table_name[len(base_name) + 1:]
    named = _SUFFIX_INTERVALS.get(suffix)
    if named is not None:
        return named
    if suffix.endswith("s") and suffix[:-1].isdigit():
        return int(suffix[:-1])
    return None


def rollup_schema(base: TableSchema, interval: int,
                  ttl_seconds=TTL_DERIVE) -> TableSchema:
    """Derive the coarser table's schema (name suffixed `.1m`-style).
    ttl_seconds: TTL_DERIVE = 30x base retention, None = keep forever,
    >=0 = explicit seconds."""
    if ttl_seconds is TTL_DERIVE:
        ttl_seconds = None if base.ttl_seconds is None \
            else base.ttl_seconds * 30
    return TableSchema(
        name=f"{base.name}.{_interval_suffix(interval)}",
        columns=base.columns,
        time_column=base.time_column,
        partition_seconds=max(base.partition_seconds, interval * 60),
        ttl_seconds=ttl_seconds,
        version=base.version,
    )


def _reduce_kind(agg: str) -> str:
    # "max", "last", "key": max is a valid representative
    return agg if agg in ("sum", "count", "min") else "max"


def _segment_reduce(seg: torch.Tensor, mask: Optional[torch.Tensor],
                    data: torch.Tensor, aggs: Sequence[str],
                    num_segments: int) -> torch.Tensor:
    """Reduce data [rows, m] int64 into [num_segments, m] by agg kind.

    seg [rows] int64 group ids. Rows where `mask` is False (None: every
    row is valid) go to the trash segment num_segments-1 with neutral
    values. Empty segments hold the identity: 0 for sum and count,
    int64 max for min, int64 min for max. Each run of adjacent columns
    of one reduce kind is one op (order the columns by kind and a call
    is four ops at most); sums wrap in int64 as XLA's do."""
    if mask is not None:
        seg = torch.where(mask, seg, num_segments - 1)
    dev = data.device
    parts: List[torch.Tensor] = []
    counts = None
    i, m = 0, len(aggs)
    while i < m:
        kind = _reduce_kind(aggs[i])
        j = i + 1
        while j < m and _reduce_kind(aggs[j]) == kind:
            j += 1
        k = j - i
        if kind == "count":
            if counts is None:
                ones = torch.ones_like(seg) if mask is None \
                    else mask.to(torch.int64)
                counts = torch.zeros(num_segments, dtype=torch.int64,
                                     device=dev).index_add_(0, seg, ones)
            parts.append(counts[:, None].expand(num_segments, k))
        elif kind == "sum":
            v = data[:, i:j]
            if mask is not None:
                v = torch.where(mask[:, None], v, 0)
            parts.append(torch.zeros((num_segments, k), dtype=torch.int64,
                                     device=dev).index_add_(0, seg, v))
        else:
            ident, how = (_I64_MAX, "amin") if kind == "min" \
                else (_I64_MIN, "amax")
            v = data[:, i:j]
            if mask is not None:
                v = torch.where(mask[:, None], v, ident)
            parts.append(torch.full((num_segments, k), ident,
                                    dtype=torch.int64, device=dev)
                         .scatter_reduce_(0, seg[:, None].expand(-1, k), v,
                                          how, include_self=True))
        i = j
    if not parts:
        return torch.empty((num_segments, 0), dtype=torch.int64, device=dev)
    return parts[0].contiguous() if len(parts) == 1 \
        else torch.cat(parts, dim=1)


def _unique_rows(packed: np.ndarray):
    """np.unique(axis=0) built from per-column argsorts: numpy's axis=0
    unique argsorts a void view (memcmp per compare), which profiles 5-10x
    slower than k stable i64 sorts at flow-map batch sizes. Returns
    (unique_rows, inverse) with rows in lexicographic order, matching
    np.unique's contract."""
    n, k = packed.shape
    if k == 1:
        u, inv = np.unique(packed[:, 0], return_inverse=True)
        return u[:, None], inv
    order = np.lexsort(tuple(packed[:, j] for j in reversed(range(k))))
    skeys = packed[order]
    boundary = np.empty(n, np.bool_)
    boundary[0] = True
    np.any(skeys[1:] != skeys[:-1], axis=1, out=boundary[1:])
    group_of_sorted = np.cumsum(boundary) - 1
    inverse = np.empty(n, np.int64)
    inverse[order] = group_of_sorted
    return skeys[boundary], inverse


def _kind_order(value_names: List[str], aggs: Dict[str, str]) -> List[str]:
    """Value columns grouped by reduce kind (stable within a kind), so
    `_segment_reduce` runs one op per kind."""
    rank = {"sum": 0, "count": 1, "min": 2, "max": 3}
    return sorted(value_names, key=lambda nm: rank[_reduce_kind(aggs[nm])])


def _value_runs(cols, order: List[str]) -> List[Tuple[str, np.ndarray]]:
    """The value columns, in `order`, as host blocks for the copy to the
    device: each maximal run of adjacent columns of one width class
    stacked [k, n] (contiguous rows), columns of <= 32 bits as 32-bit
    words ("u32" or "i32"), wider ones as int64 ("i64")."""
    runs: List[Tuple[str, list]] = []
    for nm in order:
        a = np.asarray(cols[nm])
        narrow = a.dtype.kind in "uib" and a.dtype.itemsize <= 4
        cls = "i64" if not narrow else ("i32" if a.dtype.kind == "i"
                                        else "u32")
        if runs and runs[-1][0] == cls:
            runs[-1][1].append(a)
        else:
            runs.append((cls, [a]))
    n = len(cols[order[0]])
    out = []
    for cls, arrs in runs:
        block = np.empty((len(arrs), n), {"u32": np.uint32, "i32": np.int32,
                                          "i64": np.int64}[cls])
        for r, a in enumerate(arrs):
            block[r] = a        # casts as astype does
        out.append((cls, block))
    return out


def _value_block(runs: List[Tuple[str, np.ndarray]], n: int,
                 device: torch.device) -> torch.Tensor:
    """[n, m] int64 on `device` from `_value_runs`: 32-bit words cross
    as they are and widen on the device (unsigned ones masked), so the
    copy moves 4 bytes a u32 value instead of 8."""
    parts = []
    for cls, block in runs:
        t = _to_device(block.view(np.int32) if cls == "u32" else block,
                       device).to(torch.int64)
        if cls == "u32":
            t &= 0xFFFFFFFF
        parts.append(t)
    if not parts:
        return torch.empty((n, 0), dtype=torch.int64, device=device)
    cm = parts[0] if len(parts) == 1 else torch.cat(parts)
    return cm.T.contiguous()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # a pageable host array: the copy returns once the source is staged,
    # with no stream synchronize of its own
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True)


def _pack_lanes(lanes: torch.Tensor) -> List[torch.Tensor]:
    """u32 lanes [n_keys, n] (int64 values in [0, 2^32)) -> int64 sort
    keys, most significant first, two lanes each: (a - 2^31) * 2^32 + b
    orders as signed int64 exactly as (a, b) orders lexicographically."""
    out = []
    for j in range(0, lanes.shape[0] - 1, 2):
        out.append((lanes[j] - (1 << 31)) * (1 << 32) + lanes[j + 1])
    if lanes.shape[0] % 2:
        out.append(lanes[-1])
    return out


def _device_group_reduce(lanes: torch.Tensor, data: torch.Tensor,
                         mask: Optional[torch.Tensor], aggs: Sequence[str]):
    """GROUP BY on the device: a lexicographic sort of the key lanes,
    arithmetic boundaries, cumsum group ids, segment reductions.

    lanes [n_keys, n] int64 holding u32 values; data [n, m] int64; mask
    [n] bool or None (every row valid). Invalid rows sort to the end,
    open no group and reduce into the trash segment. Returns (keys_out
    [n_keys, g] int64, vals [g, m] int64, g) with the groups in
    lexicographic lane order. Reading g back is the one sync."""
    n = lanes.shape[1]
    keys = _pack_lanes(lanes)
    perm = None
    for key in reversed(keys):       # least significant first, stable
        o = torch.argsort(key if perm is None else key[perm], stable=True)
        perm = o if perm is None else perm[o]
    if mask is not None:             # invalid rows last
        invalid = torch.logical_not(mask).to(torch.uint8)
        perm = perm[torch.argsort(invalid[perm], stable=True)]
    boundary = torch.ones(n, dtype=torch.bool, device=lanes.device)
    if n > 1:
        diff = torch.zeros(n - 1, dtype=torch.bool, device=lanes.device)
        for key in keys:
            sk = key[perm]
            diff |= sk[1:] != sk[:-1]
        boundary[1:] = diff
    svalid = None if mask is None else mask[perm]
    if svalid is not None:
        boundary &= svalid
    gid = torch.cumsum(boundary, 0) - 1
    g = int(boundary.sum())          # the one read back before the copy
    seg_sorted = gid if svalid is None else torch.where(svalid, gid, g)
    seg = torch.empty_like(perm).scatter_(0, perm, seg_sorted)
    num_segments = g + 1 if mask is not None else g
    vals = _segment_reduce(seg, mask, data, aggs, num_segments)[:g]
    # a group's keys from its first sorted row (non-first rows write the
    # scratch slot; g < n whenever any row is not first)
    first = torch.zeros(g + 1, dtype=torch.int64, device=lanes.device)
    first.scatter_(0, torch.where(boundary, gid, g),
                   torch.arange(n, device=lanes.device))
    keys_out = lanes[:, perm[first[:g]]]
    return keys_out, vals, g


def _lanes_u32(a: np.ndarray) -> np.ndarray:
    """A <=32-bit integer key as its u32 lane: signed keys sign-bit
    flipped (x + 2^31), so lane order is int64 order."""
    if a.dtype.kind == "i":
        return a.astype(np.int64).astype(np.uint32) ^ np.uint32(0x80000000)
    return a.astype(np.uint32)


def group_reduce_device(cols: Dict[str, np.ndarray], key_names: List[str],
                        aggs: Dict[str, str],
                        device="cuda") -> Dict[str, np.ndarray]:
    """`group_reduce` with the group-id stage on the device too. Key
    columns must fit uint32 (every schema key column does; the rollup
    time bucket is epoch seconds). Exactly equal to the host path,
    including group order. One read of the group count and one copy of
    the reduced groups back: materializing them is this function's
    contract (the rollup lane hands host arrays to the store)."""
    device = check_device(device)
    for nm in key_names:
        dt = np.asarray(cols[nm]).dtype
        if dt.kind not in "uib" or dt.itemsize > 4:
            raise ValueError(
                f"device GROUP BY key {nm!r} is {dt} — keys must be "
                "<=32-bit integers to ride the u32 sort lanes (floats "
                "would truncate-merge, 64-bit ints would collide); use "
                "the host path")
    n = len(next(iter(cols.values())))
    if n == 0:
        return {nm: cols[nm][:0] for nm in list(key_names) + list(aggs)}
    value_names = list(aggs.keys())
    order = _kind_order(value_names, aggs)
    lanes_np = np.empty((len(key_names), n), np.uint32)
    for j, nm in enumerate(key_names):
        lanes_np[j] = _lanes_u32(np.asarray(cols[nm]))
    lanes = _to_device(lanes_np.view(np.int32), device).to(torch.int64) \
        & 0xFFFFFFFF
    data = _value_block(_value_runs(cols, order) if order else [], n, device)
    keys_out, vals, g = _device_group_reduce(
        lanes, data, None, [aggs[nm] for nm in order])
    block = torch.cat([keys_out.T, vals], dim=1).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for j, nm in enumerate(key_names):
        k = block[:, j].astype(np.uint32)
        if np.asarray(cols[nm]).dtype.kind == "i":
            k = k ^ np.uint32(0x80000000)   # undo the sign-bit flip
        out[nm] = k.astype(cols[nm].dtype)
    col_of = {nm: len(key_names) + i for i, nm in enumerate(order)}
    for nm in value_names:
        out[nm] = block[:, col_of[nm]]
    return out


def group_reduce(cols: Dict[str, np.ndarray], key_names: List[str],
                 aggs: Dict[str, str],
                 return_inverse: bool = False, method: str = "auto",
                 device="cuda"):
    """Exact GROUP BY: group ids + segment reduction.

    `aggs` maps value column -> sum|max|min|count (last and key reduce as
    max). Key columns come back deduplicated in their dtypes, in
    lexicographic order; value columns reduced, as int64. With
    return_inverse, also returns the [n] row->group index.

    method: "host" computes group ids with a host lexsort and reduces on
    `device`; "device" runs the whole GROUP BY on `device`
    (group_reduce_device); "auto" takes the device path when `device` is
    CUDA, n >= AUTO_DEVICE_ROWS, every key fits u32 and no inverse is
    asked for. return_inverse always takes the host path.
    """
    device = check_device(device)
    n = len(next(iter(cols.values())))
    if method == "device" and return_inverse:
        raise ValueError("the device GROUP BY never materializes the "
                         "row->group map; use method='host' with "
                         "return_inverse")
    if not aggs:
        method = "host"   # pure dedup: the host path short-circuits it
    # device keys ride u32 lanes: a 64-bit key (tag_code, mac_src,
    # flow_id) would collide and a float key would truncate-merge
    keys_fit_u32 = all(np.asarray(cols[k]).dtype.kind in "uib"
                       and np.asarray(cols[k]).dtype.itemsize <= 4
                       for k in key_names)
    if method == "device" or (
            method == "auto" and not return_inverse
            and n >= AUTO_DEVICE_ROWS and keys_fit_u32
            and device.type == "cuda"):
        return group_reduce_device(cols, key_names, aggs, device=device)
    if n == 0:
        empty = {nm: cols[nm][:0] for nm in list(key_names) + list(aggs)}
        return (empty, np.empty(0, np.int64)) if return_inverse else empty
    packed = np.stack([np.ascontiguousarray(cols[nm]).astype(np.int64)
                       for nm in key_names], axis=1)
    uniq, inverse = _unique_rows(packed)
    n_groups = uniq.shape[0]
    value_names = list(aggs.keys())
    out: Dict[str, np.ndarray] = {}
    for j, nm in enumerate(key_names):
        out[nm] = uniq[:, j].astype(cols[nm].dtype)
    if not value_names:   # pure dedup: SELECT k FROM t GROUP BY k
        return (out, inverse) if return_inverse else out
    order = _kind_order(value_names, aggs)
    # window sums of u32 counters need 64-bit accumulators (ClickHouse
    # sums into UInt64): the reduce is int64 on the device
    reduced = _segment_reduce(
        _to_device(inverse, device), None,
        _value_block(_value_runs(cols, order), n, device),
        [aggs[nm] for nm in order], n_groups).cpu().numpy()
    col_of = {nm: i for i, nm in enumerate(order)}
    for nm in value_names:
        out[nm] = reduced[:, col_of[nm]]
    return (out, inverse) if return_inverse else out


class RollupManager:
    """Maintains derived tables `<base>.<1m|1h|...>`; advance() builds only
    buckets strictly older than now-allowance, once — late data within the
    allowance still lands (build-once-behind-watermark). Each build's
    GROUP BY reduces on `device`."""

    def __init__(self, store: Store, db: str, base: TableSchema,
                 intervals: Tuple[int, ...] = (60,),
                 allowance_seconds: int = 10, device="cuda") -> None:
        self.device = check_device(device)
        self.store = store
        self.db = db
        self.base = store.create_table(db, base)
        self.allowance = allowance_seconds
        self.targets: List[Tuple[int, Table]] = []
        # configured tiers UNION tiers found on disk: a runtime
        # `datasource add` persists as its table (the manifest IS the
        # registration), so a restart keeps building tiers an operator
        # added
        want = set(intervals)
        for tdb, tname in store.tables():
            if tdb != db:
                continue
            iv = interval_from_table_name(base.name, tname)
            if iv is not None:
                want.add(iv)
        for iv in sorted(want):
            # a tier removed with keep-data left a DETACHED marker: its
            # rows stay queryable but it must not resume building, and
            # the operator's detach outranks the static config list too
            # (only a datasource add clears the marker)
            name = f"{base.name}.{_interval_suffix(iv)}"
            try:
                root = store.table(db, name).root
                if os.path.exists(os.path.join(root, "DETACHED")):
                    continue
            except KeyError:
                pass   # table doesn't exist yet: nothing to detach
            self.targets.append(
                (iv, store.create_table(db, rollup_schema(base, iv))))
        # per-interval high-water mark: everything < mark already built,
        # recovered from the target table on restart (segments are
        # append-only, so re-building a built bucket would double-count)
        self._built_until: Dict[int, int] = {
            iv: self._recover_watermark(iv, t) for iv, t in self.targets}
        # guards targets/_built_until against runtime datasource CRUD
        # racing advance(). Builds run OUTSIDE the lock (a backfill can
        # scan days of base data); _building marks in-flight tiers,
        # _drop_pending records a del that arrived mid-build so its
        # table is re-dropped afterwards.
        self._lock = threading.Lock()
        self._building: set = set()
        self._drop_pending: Dict[int, str] = {}   # interval -> table root

    # -- runtime datasource CRUD (reference: datasource/handle.go) -------
    def list_datasources(self) -> List[dict]:
        with self._lock:
            rows = [{"interval": iv, "table": t.schema.name,
                     "ttl_seconds": t.schema.ttl_seconds,
                     "built_until": self._built_until[iv]}
                    for iv, t in self.targets]
        return rows + external_datasources()

    def add_interval(self, interval: int,
                     ttl_seconds: Optional[int] = TTL_DERIVE) -> dict:
        """Create a new rollup tier at runtime; the next advance()
        backfills every complete bucket still in the base table's
        retention. ttl_seconds: TTL_DERIVE = 30x base retention, None/0
        = keep forever, >0 = explicit seconds."""
        if interval <= 0 or interval % 60:
            # the reference constrains custom tiers to whole minutes
            raise ValueError("interval must be a positive multiple of 60")
        if ttl_seconds is not TTL_DERIVE and ttl_seconds is not None:
            if int(ttl_seconds) < 0:
                raise ValueError("ttl_seconds must be >= 0")
            if int(ttl_seconds) == 0:
                ttl_seconds = None                   # keep forever
        with self._lock:
            if any(iv == interval for iv, _ in self.targets):
                raise ValueError(f"datasource {interval}s already exists")
            if interval in self._building or interval in self._drop_pending:
                # a del'd tier's backfill is still draining: attaching a
                # fresh table now would let the old build overwrite the
                # new tier's watermark when it lands
                raise ValueError(
                    f"datasource {interval}s busy (build draining); retry")
            t = self.store.create_table(
                self.db, rollup_schema(self.base.schema, interval,
                                       ttl_seconds))
            marker = os.path.join(t.root, "DETACHED")
            if os.path.exists(marker):   # re-attach of a kept-data tier
                os.remove(marker)
            if ttl_seconds is not TTL_DERIVE and \
                    t.schema.ttl_seconds != ttl_seconds:
                # create_table returned an EXISTING table: the requested
                # retention must still win
                t.set_ttl(ttl_seconds)
            self.targets.append((interval, t))
            self.targets.sort()
            self._built_until[interval] = self._recover_watermark(interval, t)
            return {"interval": interval, "table": t.schema.name,
                    "ttl_seconds": t.schema.ttl_seconds}

    def remove_interval(self, interval: int, drop_data: bool = True) -> bool:
        with self._lock:
            for i, (iv, t) in enumerate(self.targets):
                if iv == interval:
                    del self.targets[i]
                    del self._built_until[iv]
                    if drop_data:
                        self.store.drop_table(self.db, t.schema.name)
                        if iv in self._building:
                            # an in-flight build may recreate the table
                            # dir with its append; advance() re-drops it
                            # when the build drains
                            self._drop_pending[iv] = t.root
                    else:
                        # kept data must not resurrect the tier on
                        # restart: mark it detached on disk
                        try:
                            with open(os.path.join(t.root, "DETACHED"),
                                      "w"):
                                pass
                        except OSError:
                            pass
                    return True
        return False

    def set_retention(self, interval: int, ttl_seconds: Optional[int]) -> bool:
        if ttl_seconds is not None and int(ttl_seconds) < 0:
            raise ValueError("ttl_seconds must be >= 0")
        with self._lock:
            for iv, t in self.targets:
                if iv == interval:
                    t.set_ttl(ttl_seconds)
                    return True
        return False

    @staticmethod
    def _recover_watermark(interval: int, target: Table) -> int:
        parts = target.partitions()
        if not parts:
            return 0
        tcol = target.schema.time_column
        psec = target.schema.partition_seconds
        last = target.scan(columns=[tcol],
                           time_range=(parts[-1], parts[-1] + psec))[tcol]
        if len(last) == 0:
            return 0
        return int(last.max()) + interval

    def advance(self, now: float) -> Dict[int, int]:
        """Build all complete buckets older than now-allowance.
        Returns {interval: rows_emitted}."""
        emitted: Dict[int, int] = {}
        with self._lock:
            targets = list(self.targets)
        for iv, target in targets:
            # bookkeeping under the lock, the build itself outside it;
            # the _building marker keeps a concurrent del honest: its
            # table drop is re-applied after the build drains
            with self._lock:
                if iv not in self._built_until or iv in self._building:
                    continue   # removed by datasource del / double run
                safe = int(now - self.allowance) // iv * iv
                lo = self._built_until[iv]
                if lo == 0:
                    parts = self.base.partitions()
                    if not parts:
                        emitted[iv] = 0
                        continue
                    lo = parts[0] // iv * iv
                if safe <= lo:
                    emitted[iv] = 0
                    continue
                self._building.add(iv)
            rows = None
            try:
                rows = self._build_range(iv, target, lo, safe)
            finally:
                with self._lock:
                    self._building.discard(iv)
                    if iv in self._built_until:
                        if rows is not None:   # failed build: retry later
                            self._built_until[iv] = safe
                            emitted[iv] = rows
                    else:
                        pend = self._drop_pending.pop(iv, None)
                        if pend is not None:
                            shutil.rmtree(pend, ignore_errors=True)
        return emitted

    def rollup_plan(self) -> Tuple[List[str], Dict[str, str]]:
        """(key names, value aggs) of a build's GROUP BY: the KEY
        columns plus the time bucket, every other column by its kind."""
        schema = self.base.schema
        tcol = schema.time_column
        key_names = [c.name for c in schema.columns if c.agg is AggKind.KEY]
        if tcol not in key_names:
            key_names.append(tcol)
        aggs = {c.name: c.agg.value for c in schema.columns
                if c.name not in key_names}
        return key_names, aggs

    def bucketed(self, cols: Dict[str, np.ndarray],
                 interval: int) -> Dict[str, np.ndarray]:
        """The scanned rows with the time column floored to its bucket,
        kept in the schema's (u32) dtype: an int64 bucket would
        disqualify every rollup from the device GROUP BY path."""
        tcol = self.base.schema.time_column
        bucket = cols[tcol] // np.uint32(interval) * np.uint32(interval)
        work = dict(cols)
        work[tcol] = bucket.astype(cols[tcol].dtype)
        return work

    def clipped(self, reduced: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        """A reduced block in the schema's dtypes, unsigned columns
        clipped to their range (a 60 s sum of u32 counters saturates)."""
        out = {}
        for c in self.base.schema.columns:
            v = reduced[c.name]
            if np.dtype(c.dtype).kind == "u":
                v = np.clip(v, 0, np.iinfo(c.dtype).max)
            out[c.name] = v.astype(c.dtype)
        return out

    def _build_range(self, interval: int, target: Table,
                     lo: int, hi: int) -> int:
        tcol = self.base.schema.time_column
        cols = self.base.scan(time_range=(lo, hi))
        if len(cols[tcol]) == 0:
            return 0
        key_names, aggs = self.rollup_plan()
        reduced = group_reduce(self.bucketed(cols, interval), key_names,
                               aggs, device=self.device)
        out = self.clipped(reduced)
        target.append(out)
        return len(out[tcol])
