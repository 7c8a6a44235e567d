"""Dictionary wire: a flow's 5-tuple crosses to the device once.

- A flow's first record crosses as a NEWS row of a (6, C) plane:
  dictionary index, ip_src, ip_dst, ports, raw proto byte, packets.
- Every later record rides a pairs-packed (3, H) HITS plane, two records
  per three u32 words {idx_a, idx_b, pkts_a | pkts_b << 16}.

The device keeps the key table, (4, capacity) u32 bits, scatters news
rows into it and gathers hit rows back into the lane words, so the CMS,
HLL, entropy and row counts equal the packed-lane path's. Packets
saturate at PKTS_CAP = 0xFFFF on this wire. Planes apply strictly in
emission order (the argument is in `FlowDictPacker`'s docstring).

`FlowDictPacker` and `stage_wire` are host numpy, kept here as the
port's own copies.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.models.flow_suite import (FlowSuiteConfig,
                                                  FlowSuiteState)
from deepflow_tpu_torch.ops import cuda_sketch
from deepflow_tpu_torch.utils.twinmark import host_twin_of
from deepflow_tpu_torch.utils.u32 import as_u32, to_bits

PKTS_CAP = 0xFFFF

# plane rows per wire kind
_KIND_ROWS = {"news": 6, "hits": 3}


class FlowDictState(NamedTuple):
    """Row i of `table` holds the four lane key words (ip_src, ip_dst,
    ports, proto<<24) of the flow the host assigned index i."""

    table: torch.Tensor      # (4, capacity) int32 u32 bits


def init_dict(capacity: int = 1 << 20, device="cuda") -> FlowDictState:
    device = flow_suite.check_device(device)
    return FlowDictState(table=torch.zeros(4, capacity, dtype=torch.int32,
                                           device=device))


def update_news(state: FlowSuiteState, dstate: FlowDictState,
                plane: torch.Tensor, n, cfg: FlowSuiteConfig,
                count_mask: Optional[torch.Tensor] = None
                ) -> Tuple[FlowSuiteState, FlowDictState]:
    """Apply one (6, C) int32 news plane: write its valid rows' keys into
    the table (IN PLACE) and count the records themselves (a news row is
    the flow's first record). Rows >= n are padding and change nothing.

    The index word is read as int32, as the reference reads it: a
    negative index counts from the end of the table (-1 is the last
    column), and a valid row whose index lies outside [-capacity,
    capacity) writes nothing (the reference's scatter drops it) but is
    still counted in the sketches. Torch raises on such an index, and
    selecting the writing rows on the host would sync. So every row that
    writes nothing writes the same value to the same column as the last
    writing row does (or, when no row writes, a column's own value back),
    which leaves the table as the writing rows alone would.

    `count_mask` (the sharded path) narrows which rows this caller counts
    while every valid row is still written: news planes go to every
    replica of the table, but each record is counted by one shard. The
    fused news kernel counts exactly the valid rows, so it runs only
    without a `count_mask`."""
    C = plane.shape[1]
    dev = plane.device
    table = dstate.table
    cap = table.shape[1]
    mask = flow_suite._valid(n, C, dev)
    idx = plane[0].to(torch.int64)
    idx = torch.where(idx < 0, idx + cap, idx)
    writes = mask & (idx >= 0) & (idx < cap)
    idx = torch.clamp(idx, 0, cap - 1)
    proto_word = to_bits(as_u32(plane[4]) << 24)
    key_rows = torch.cat([plane[1:4], proto_word[None]], dim=0)
    pos = torch.arange(C, device=dev)
    last = torch.where(writes, pos, 0).max().reshape(1)   # [1], on device
    tgt = idx.index_select(0, last)
    pad_val = torch.where(writes.any(), key_rows.index_select(1, last),
                          table.index_select(1, tgt))  # (4, 1)
    safe = torch.where(writes, idx, tgt)
    vals = torch.where(writes[None, :], key_rows, pad_val)
    table[:, safe] = vals
    lanes = {"ip_src": plane[1], "ip_dst": plane[2], "ports": plane[3],
             "proto_pkts": as_u32(proto_word) | as_u32(plane[5])}
    fused = count_mask is None and flow_suite.use_fused_hists(cfg, dev)
    if fused:
        cuda_sketch.fused_news_hists(
            plane, n, state.sketch.counts, state.ent.hist,
            state.sketch.seeds, state.ent.seeds)
    if count_mask is None:
        count_mask = mask
    state = flow_suite.update(state, flow_suite.unpack_lanes(lanes),
                              count_mask, cfg, hists_done=fused)
    return state, FlowDictState(table=table)


def unpack_hits(plane: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, H) pairs plane -> (idx, pkts) of its 2H records in the
    packer's order: a-lanes then the b-lane spill, valid records
    contiguous at [0, n)."""
    idx = torch.cat([as_u32(plane[0]), as_u32(plane[1])])
    w = as_u32(plane[2])
    pkts = torch.cat([w & 0xFFFF, w >> 16])
    return idx, pkts


def update_hits(state: FlowSuiteState, dstate: FlowDictState,
                plane: torch.Tensor, n, cfg: FlowSuiteConfig,
                mask: Optional[torch.Tensor] = None) -> FlowSuiteState:
    """Apply one (3, H) hits plane (2H records): gather each record's key
    words from the table (indices clamped, as XLA's gather does) and
    advance the sketches as the packed-lane path would. `mask` (the
    sharded path, where the plane is a shard of a larger one and n counts
    the whole) replaces the arange < n validity and turns the fused lane
    kernel off."""
    idx, pkts = unpack_hits(plane)
    dev = plane.device
    fused = mask is None and flow_suite.use_fused_hists(cfg, dev)
    if mask is None:
        mask = flow_suite._valid(n, 2 * plane.shape[1], dev)
    idx = torch.clamp(idx, max=dstate.table.shape[1] - 1)
    rows = dstate.table[:, idx]                       # (4, 2H) gather
    lane_plane = torch.stack([rows[0], rows[1], rows[2],
                              to_bits(as_u32(rows[3]) | pkts)])
    if fused:
        return flow_suite.update_lanes_fused(state, lane_plane, n, cfg)
    return flow_suite.update_packed(state, flow_suite._lanes_of(lane_plane),
                                    mask, cfg)


def wire_signature(wire) -> Tuple[Tuple[str, int], ...]:
    """(kind, plane_width) per plane of one emitted wire sequence."""
    return tuple((kind, plane.shape[1]) for kind, plane, _ in wire)


def wire_words(sig: Tuple[Tuple[str, int], ...]) -> int:
    """u32 words of one staged buffer for `sig`: one n word per plane,
    then the planes raveled in order."""
    return len(sig) + sum(_KIND_ROWS[kind] * w for kind, w in sig)


def stage_wire(wire, flat: np.ndarray) -> None:
    """Host-pack one wire sequence into a flat uint32 buffer laid out
    [n_0..n_{P-1} | plane_0.ravel() | ...], emission order kept."""
    P = len(wire)
    off = P
    for i, (_, plane, n) in enumerate(wire):
        flat[i] = n
        flat[off:off + plane.size] = plane.ravel()
        off += plane.size


def mirror_news_np(wire, table: np.ndarray) -> None:
    """Scatter one wire emission's NEWS keys into a host mirror of the
    device table ((4, capacity) uint32, the table's lane-word layout:
    proto<<24 in row 3). The dict stager feeds it at stage time, so
    degraded mode can gather the keys of staged hits (`unpack_wire_np`).
    An index evicted and reused by a later staged group shows its new
    tenant to an older hit absorbed after degradation: a bounded
    approximation confined to the host fallback, itself a sample."""
    u = np.uint32
    for kind, plane, n in wire:
        if kind != "news":
            continue
        idx = plane[0, :n].astype(np.int64)
        table[0, idx] = plane[1, :n]
        table[1, idx] = plane[2, :n]
        table[2, idx] = plane[3, :n]
        table[3, idx] = plane[4, :n] << u(24)


@host_twin_of("deepflow_tpu_torch/models/flow_dict.py:make_wire_update")
def unpack_wire_np(flat: np.ndarray, sig: Tuple[Tuple[str, int], ...],
                   table: np.ndarray):
    """Host twin of `make_wire_update`: one staged flat buffer back into
    per-plane column dicts trimmed to each plane's n valid records, the
    hits' keys gathered from the host mirror `table` as `update_hits`
    gathers them from the device table. Returns [(cols, n)] in emission
    order."""
    u = np.uint32
    out = []
    off = len(sig)
    for i, (kind, w) in enumerate(sig):
        n = int(flat[i])
        r = _KIND_ROWS[kind]
        plane = flat[off:off + r * w].reshape(r, w)
        off += r * w
        if kind == "news":
            cols = {
                "ip_src": plane[1, :n],
                "ip_dst": plane[2, :n],
                "port_src": plane[3, :n] >> u(16),
                "port_dst": plane[3, :n] & u(0xFFFF),
                "proto": plane[4, :n] & u(0xFF),
                "packet_tx": plane[5, :n],
                "packet_rx": np.zeros(n, u),
            }
        else:
            # a-lanes then the b-lane spill: valid records at [0, n)
            idx = np.concatenate([plane[0], plane[1]])[:n].astype(np.int64)
            pkts = np.concatenate([plane[2] & u(0xFFFF),
                                   plane[2] >> u(16)])[:n]
            rows = table[:, idx]
            cols = {
                "ip_src": rows[0],
                "ip_dst": rows[1],
                "port_src": rows[2] >> u(16),
                "port_dst": rows[2] & u(0xFFFF),
                "proto": rows[3] >> u(24),
                "packet_tx": pkts,
                "packet_rx": np.zeros(n, u),
            }
        out.append((cols, n))
    return out


def make_wire_update(cfg: FlowSuiteConfig, sig: Tuple[Tuple[str, int], ...]):
    """fn(state, dstate, flat) -> (state, dstate, rows) applying every
    plane of one staged int32 buffer in emission order. Each plane's n
    is read on the device from the buffer's header (no host sync);
    `rows` is the sum of the n words."""
    sig = tuple(sig)
    words = wire_words(sig)

    def prog(state: FlowSuiteState, dstate: FlowDictState,
             flat: torch.Tensor):
        if flat.dtype != torch.int32 or flat.numel() != words:
            raise ValueError(f"flat must be {words} int32 words")
        off = len(sig)
        for i, (kind, w) in enumerate(sig):
            n = flat[i:i + 1]
            nwords = _KIND_ROWS[kind] * w
            plane = flat[off:off + nwords].view(_KIND_ROWS[kind], w)
            off += nwords
            if kind == "news":
                state, dstate = update_news(state, dstate, plane, n, cfg)
            else:
                state = update_hits(state, dstate, plane, n, cfg)
        return state, dstate, flat[:len(sig)].to(torch.int64).sum()

    return prog


def apply_batches(state: FlowSuiteState, dstate: FlowDictState, batches,
                  cfg: FlowSuiteConfig
                  ) -> Tuple[FlowSuiteState, FlowDictState]:
    """Reference consumer: apply packer output plane by plane, in
    emission order, on the state's device."""
    dev = dstate.table.device
    for kind, plane, n in batches:
        p = torch.from_numpy(np.ascontiguousarray(plane).view(np.int32)).to(dev)
        if kind == "news":
            state, dstate = update_news(state, dstate, p, int(n), cfg)
        else:
            state = update_hits(state, dstate, p, int(n), cfg)
    return state, dstate


class FlowDictPacker:
    """Host side: streaming records -> ordered news/hits wire batches.

    Correctness rests on one consumer rule (`apply_batches` and
    `make_wire_update` keep it): batches apply strictly in emission
    order. Within one `pack()` call the call's own hit rows are emitted
    only after its news batches (a hit may reference an index its own
    call's news assigned), but hits pre-drained from earlier calls may
    precede this call's news, so grouping batches by kind is wrong.

    Index reuse after eviction is safe because of the pre-drain in
    pack(): eviction happens only once the dictionary is full, pack()
    flushes every buffered hit row before resolving keys whenever this
    call could fill it, and the call's own hit rows are appended only
    after every key resolved. At any eviction no emitted-or-buffered hit
    row references the freed index, and the index's next tenant is
    scattered (its news batch) before any hit row referencing it exists.
    `_assign` enforces the invariant.

    The packer is windowless: sketch windows close on the device, the
    table persists across windows."""

    def __init__(self, capacity: int = 1 << 20,
                 hits_batch: int = 1 << 17, news_batch: int = 1 << 13):
        if capacity <= hits_batch:
            raise ValueError("capacity must exceed hits_batch")
        if hits_batch % 2:
            raise ValueError("hits_batch must be even (pairs planes)")
        self.capacity = capacity
        self.hits_batch = hits_batch
        self.news_batch = news_batch
        self._idx: "OrderedDict[bytes, int]" = OrderedDict()  # LRU
        self._free = list(range(capacity - 1, -1, -1))        # pop() asc
        self._hit_idx: List[np.ndarray] = []
        self._hit_pkts: List[np.ndarray] = []
        self._hit_count = 0
        self.evictions = 0
        self.bytes_news = 0
        self.bytes_hits = 0

    @staticmethod
    def _bucket(n: int, full: int) -> int:
        """Plane width for n live rows: the smallest power of two >= n
        (floor 256), capped at the full batch width."""
        b = 256
        while b < n:
            b <<= 1
        return min(b, full)

    def _emit_news(self, out: List[Tuple[str, np.ndarray, int]],
                   idx: np.ndarray, keys: np.ndarray,
                   pkts: np.ndarray) -> None:
        """Emit (6, bucket) planes; row 4 carries the RAW proto byte."""
        C = self.news_batch
        for s in range(0, len(idx), C):
            e = min(s + C, len(idx))
            plane = np.zeros((6, self._bucket(e - s, C)), np.uint32)
            plane[0, :e - s] = idx[s:e]
            plane[1:5, :e - s] = keys[s:e].T
            plane[5, :e - s] = pkts[s:e]
            out.append(("news", plane, e - s))
            self.bytes_news += plane.nbytes

    def _flush_hits(self, out: List[Tuple[str, np.ndarray, int]],
                    partial: bool = False) -> None:
        """Emit (3, H) pairs planes: a-lanes fill completely, b-lanes
        take the spill, so valid records sit at [0, count) after the
        device's concat."""
        B = self.hits_batch
        if not self._hit_count:
            return
        idx = np.concatenate(self._hit_idx)
        pkts = np.concatenate(self._hit_pkts)
        end = len(idx) if partial else (len(idx) // B) * B
        for s in range(0, end, B):
            e = min(s + B, end)
            cnt = e - s
            H = self._bucket((cnt + 1) // 2, B // 2)
            k = min(cnt, H)
            plane = np.zeros((3, H), np.uint32)
            plane[0, :k] = idx[s:s + k]
            plane[2, :k] = pkts[s:s + k]
            if cnt > H:
                m = cnt - H
                plane[1, :m] = idx[s + H:e]
                plane[2, :m] |= pkts[s + H:e] << np.uint32(16)
            out.append(("hits", plane, cnt))
            self.bytes_hits += plane.nbytes
        rest_i, rest_p = idx[end:], pkts[end:]
        self._hit_idx = [rest_i] if len(rest_i) else []
        self._hit_pkts = [rest_p] if len(rest_p) else []
        self._hit_count = len(rest_i)

    def _assign(self, key: bytes) -> int:
        """Index for a NEW key, evicting the LRU head when full (only
        reachable with the hit buffer empty)."""
        if not self._free:
            if self._hit_count:
                raise RuntimeError(
                    "flow dict eviction with hits buffered: pack() "
                    "must pre-drain first (bug, not load)")
            _, old_idx = self._idx.popitem(last=False)
            self.evictions += 1
            self._free.append(old_idx)
        idx = self._free.pop()
        self._idx[key] = idx
        return idx

    def pack(self, cols: Dict[str, np.ndarray]
             ) -> List[Tuple[str, np.ndarray, int]]:
        """One record batch -> ordered wire batches [(kind, plane, n)]."""
        out: List[Tuple[str, np.ndarray, int]] = []
        u32 = np.uint32
        n = len(cols["ip_src"])
        if n == 0:
            return out
        pkts = np.minimum(cols["packet_tx"].astype(np.uint64)
                          + cols["packet_rx"], PKTS_CAP).astype(u32)
        keys = np.empty((n, 4), u32)
        keys[:, 0] = cols["ip_src"]
        keys[:, 1] = cols["ip_dst"]
        keys[:, 2] = ((cols["port_src"].astype(u32) & u32(0xFFFF))
                      << u32(16)) | (cols["port_dst"].astype(u32)
                                     & u32(0xFFFF))
        keys[:, 3] = cols["proto"].astype(u32) & u32(0xFF)   # raw byte
        kbytes = np.ascontiguousarray(keys).view("V16").ravel()
        uniq, first, inverse = np.unique(
            kbytes, return_index=True, return_inverse=True)
        if len(uniq) >= self.capacity:
            raise ValueError(
                f"{len(uniq)} unique flows in one pack() call >= "
                f"dictionary capacity {self.capacity}")
        uidx = np.empty(len(uniq), u32)
        is_new = np.zeros(len(uniq), bool)
        if len(self._idx) + len(uniq) > self.capacity and self._hit_count:
            # eviction is possible this call: drain buffered hits first
            self._flush_hits(out, partial=True)
        for i, kb in enumerate(uniq):
            k = bytes(kb)
            got = self._idx.get(k)
            if got is None:
                is_new[i] = True
                uidx[i] = self._assign(k)
            else:
                self._idx.move_to_end(k)
                uidx[i] = got
        rec_idx = uidx[inverse.reshape(-1)]
        news_rows = first[is_new]
        self._emit_news(out, rec_idx[news_rows], keys[news_rows],
                        pkts[news_rows])
        hit_mask = np.ones(n, bool)
        hit_mask[news_rows] = False
        self._hit_idx.append(rec_idx[hit_mask])
        self._hit_pkts.append(pkts[hit_mask])
        self._hit_count += int(hit_mask.sum())
        self._flush_hits(out)                    # full batches only
        return out

    def flush(self) -> List[Tuple[str, np.ndarray, int]]:
        """Drain the partial hit buffer (end of stream / forced tick)."""
        out: List[Tuple[str, np.ndarray, int]] = []
        self._flush_hits(out, partial=True)
        return out
