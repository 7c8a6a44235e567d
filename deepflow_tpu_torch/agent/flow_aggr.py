"""FlowAggr: 1m aggregation of per-tick flow rows before the wire.

Reference: `agent/src/collector/flow_aggr.rs` — the flow-log fork of
the hot path aggregates the FlowMap's 1s TaggedFlows per flow over a
minute and ships ONE l4_flow_log row per flow per minute (the 1s
stream keeps feeding the metrics fork untouched). 60x fewer rows hit
the ingester for long-lived flows; short flows still emit promptly on
close.

Columnar redesign: the stash is a slot-indexed column table (exactly
the FlowMap discipline — flow_id -> slot dict is the only per-flow
Python), and each tick's output batch merges in one vectorized pass
per column class:

  sum:   byte/packet/retrans counters, perf *_sum/*_count,
         zero-window + handshake counters
  max:   perf *_max, one-shot rtt estimates, close_type, is_new_flow
  min:   start_time
  first: identity columns (5-tuple, ids, tap_side, ...)

`add(cols, now_ns)` returns the columns to EMIT NOW: rows that closed
this tick (merged with their stashed history) plus every stashed flow
whose aggregation bucket just ended (forced report, close_type 0 —
the same semantics tick_columns itself uses). `duration` is
recomputed as max(start+duration) - min(start) across merged rows.

The port's own copy of the JAX package's `agent/flow_aggr.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

_SUM_KEYS = ("byte_tx", "byte_rx", "packet_tx", "packet_rx", "retrans",
             "retrans_tx", "retrans_rx", "rtt_client_sum",
             "rtt_client_count", "rtt_server_sum", "rtt_server_count",
             "srt_sum", "srt_count", "art_sum", "art_count", "cit_sum",
             "cit_count", "zero_win_tx", "zero_win_rx", "syn_count",
             "synack_count", "retrans_syn", "retrans_synack")
_MAX_KEYS = ("rtt", "rtt_client", "rtt_server", "srt_max", "art_max",
             "cit_max", "close_type", "is_new_flow", "status")
_MIN_KEYS = ("start_time",)
# everything else: first value wins (identity columns)


class FlowAggr:
    """Per-flow interval aggregation with columnar stash."""

    def __init__(self, interval_s: int = 60, capacity: int = 1024) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.interval_s = interval_s
        self._capacity = max(capacity, 16)
        self._slot: Dict[int, int] = {}
        self._free: List[int] = []
        self._cols: Dict[str, np.ndarray] = {}
        self._end: Optional[np.ndarray] = None    # max(start+duration)
        self._live = np.zeros(0, np.bool_)
        self._bucket = -1
        self.rows_in = 0
        self.rows_out = 0

    # -- internals ---------------------------------------------------------
    def _ensure_layout(self, cols: Dict[str, np.ndarray]) -> None:
        if self._cols:
            return
        n = self._capacity
        for k, v in cols.items():
            self._cols[k] = np.zeros(n, v.dtype)
        self._end = np.zeros(n, np.uint64)
        self._live = np.zeros(n, np.bool_)

    def _grow(self) -> None:
        n = len(self._live)
        for k, v in self._cols.items():
            nv = np.zeros(n * 2, v.dtype)
            nv[:n] = v
            self._cols[k] = nv
        ne = np.zeros(n * 2, np.uint64)
        ne[:n] = self._end
        self._end = ne
        nl = np.zeros(n * 2, np.bool_)
        nl[:n] = self._live
        self._live = nl

    def _allocate(self, fid: int) -> int:
        if self._free:
            s = self._free.pop()
        else:
            s = len(self._slot)
            while s < len(self._live) and self._live[s]:
                s += 1
            while s >= len(self._live):
                self._grow()
        self._slot[fid] = s
        self._live[s] = True
        return s

    def _emit(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        out = {k: v[slots].copy() for k, v in self._cols.items()}
        out["duration"] = (self._end[slots]
                           - out["start_time"]).astype(np.uint64)
        self.rows_out += len(slots)
        for s in slots.tolist():
            self._live[s] = False
            self._free.append(s)
        fids = out["flow_id"].tolist()
        for f in fids:
            self._slot.pop(int(f), None)
        return out

    # -- API ---------------------------------------------------------------
    def add(self, cols: Dict[str, np.ndarray],
            now_ns: Optional[int] = None) -> Optional[Dict[str, np.ndarray]]:
        """Fold one tick's flow columns in; returns columns to emit now
        (None when nothing is due). The input batch has at most one row
        per flow_id (tick_columns emits each flow once)."""
        now_ns = int(time.time() * 1e9) if now_ns is None else now_ns
        emit_parts: List[Dict[str, np.ndarray]] = []

        # bucket boundary FIRST: stashed flows from the previous bucket
        # flush as forced reports before this tick's rows merge in
        bucket = now_ns // (self.interval_s * 1_000_000_000)
        if bucket != self._bucket:
            if self._bucket >= 0 and self._live.any():
                emit_parts.append(self._emit(np.nonzero(self._live)[0]))
            self._bucket = bucket

        n = len(cols.get("flow_id", ()))
        if n:
            self.rows_in += n
            self._ensure_layout(cols)
            fids = cols["flow_id"].astype(np.uint64)
            get = self._slot.get
            known = np.fromiter((get(int(f), -1) for f in fids),
                                dtype=np.int64, count=n)
            fresh = known < 0
            # fresh flows: allocate + assign every column verbatim
            fresh_idx = np.nonzero(fresh)[0]
            if len(fresh_idx):
                slots = np.fromiter(
                    (self._allocate(int(f)) for f in fids[fresh_idx]),
                    dtype=np.int64, count=len(fresh_idx))
                for k, v in cols.items():
                    self._cols[k][slots] = v[fresh_idx]
                self._end[slots] = (
                    cols["start_time"][fresh_idx].astype(np.uint64)
                    + cols["duration"][fresh_idx].astype(np.uint64))
                known[fresh_idx] = slots
            # known flows: merge per column class
            old_idx = np.nonzero(~fresh)[0]
            if len(old_idx):
                slots = known[old_idx]
                for k, v in cols.items():
                    dst = self._cols.get(k)
                    if dst is None:
                        continue
                    nv = v[old_idx]
                    if k in _SUM_KEYS:
                        dst[slots] += nv.astype(dst.dtype)
                    elif k in _MAX_KEYS:
                        dst[slots] = np.maximum(dst[slots],
                                                nv.astype(dst.dtype))
                    elif k in _MIN_KEYS:
                        dst[slots] = np.minimum(dst[slots],
                                                nv.astype(dst.dtype))
                    # else: identity — first value stands
                self._end[slots] = np.maximum(
                    self._end[slots],
                    cols["start_time"][old_idx].astype(np.uint64)
                    + cols["duration"][old_idx].astype(np.uint64))
            # rows that closed THIS tick leave immediately, merged
            closed = cols["close_type"].astype(np.int64) > 0
            if closed.any():
                emit_parts.append(self._emit(known[np.nonzero(closed)[0]]))

        if not emit_parts:
            return None
        if len(emit_parts) == 1:
            return emit_parts[0]
        return {k: np.concatenate([p[k] for p in emit_parts])
                for k in emit_parts[0]}

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        """Force-emit everything (shutdown: the final tick must not
        strand stashed flows)."""
        if not self._live.any():
            return None
        return self._emit(np.nonzero(self._live)[0])

    def counters(self) -> dict:
        # same key set as the agent's disabled-state fallback, so the
        # DFSTATS column shape is stable across hot-switches
        return {"rows_in": self.rows_in, "rows_out": self.rows_out,
                "stashed": int(self._live.sum()), "enabled": 1}
