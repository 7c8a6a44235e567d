"""Batched flow generator: MetaPacket columns -> TaggedFlow output.

Reference: agent/src/flow_generator/flow_map.rs — a per-packet AHashMap
hot loop with a time wheel, TCP state machine (flow_state.rs) and perf
calculator (perf/tcp.rs), ticking TaggedFlows out every second. The
batch-columnar re-design splits that into:

1. per-batch: canonicalize 5-tuples (so both directions share a flow),
   segment-reduce per-direction byte/packet/flag/timestamp aggregates —
   one vectorized pass over the whole batch, device-friendly;
2. cross-batch: merge the per-flow partials into a COLUMNAR flow table —
   the accumulators are numpy arrays indexed by slot, so the merge is a
   handful of vectorized scatters (np.add.at / np.maximum.at). The only
   per-group Python is one dict lookup resolving the 5-tuple to its
   slot (plus allocation for first-seen flows);
3. tick(now): one vectorized pass over the table emits 1s interval
   deltas for active flows and closes flows on FIN/RST or timeout,
   deriving close_type and RTT (SYN->SYN/ACK) the way the reference's
   state machine does. `tick_columns` returns oriented wire-ready
   columns with zero per-flow Python; `tick` wraps them in FlowAcc
   objects for callers that want row views.

The port keeps the JAX package's `agent/flow_map.py` as it is, with one
change: the per-batch (flow, direction) segment reduction of step 1 runs
through the port's `store/rollup.group_reduce` on the map's `device`
(CUDA unless the caller names the CPU, with no fallback). Its key words
are u64 and it asks for the row->group inverse, so it takes the
host-lexsort path in both packages: group ids (and the inverse
`np.bitwise_or.at` reuses) from a host lexsort over the int64-cast key
words, the value columns reduced on the device, and the reduced block
copied back once per batch -- the one sync of `inject`. The flow table
and `TcpPerf`'s state stay host numpy arrays, as in the reference.

Retransmissions are estimated per direction by counting payload-carrying
packets whose sequence did not advance (reference counts true
retransmits from the seq window; this batched estimate matches it for
the common in-order capture case).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.agent.packet import ACK, FIN, PROTO_TCP, RST, SYN
from deepflow_tpu_torch.agent.tcp_perf import TcpPerf
from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.store.rollup import group_reduce

# close types (reference: agent/src/common/enums.rs CloseType)
CLOSE_FORCED_REPORT = 0   # still active at tick
CLOSE_FIN = 1
CLOSE_RST = 2
CLOSE_TIMEOUT = 3

FLOW_TIMEOUT_NS = 120 * 1_000_000_000
_U64 = np.uint64
_BIG = np.int64(1 << 62)


@dataclass
class FlowAcc:
    """Row view of one emitted flow (compat shell over the columnar
    table; tick_columns is the zero-copy path)."""

    ip0: int
    ip1: int
    port0: int
    port1: int
    proto: int
    flow_id: int
    start_ns: int
    last_ns: int
    # per direction (0 = canonical ip0->ip1, 1 = reverse)
    bytes_: List[int] = field(default_factory=lambda: [0, 0])
    packets: List[int] = field(default_factory=lambda: [0, 0])
    flags: List[int] = field(default_factory=lambda: [0, 0])
    retrans: List[int] = field(default_factory=lambda: [0, 0])
    max_seq: List[int] = field(default_factory=lambda: [0, 0])
    syn_ns: int = 0           # first SYN (no ACK)
    synack_ns: int = 0        # first SYN+ACK
    initiator: int = -1       # direction index that sent the first SYN
    reported: bool = False    # has this flow appeared in a tick yet?

    @property
    def rtt_us(self) -> int:
        if self.syn_ns and self.synack_ns > self.syn_ns:
            return (self.synack_ns - self.syn_ns) // 1000
        return 0

    def close_type(self, now_ns: int) -> int:
        f = self.flags[0] | self.flags[1]
        if f & RST:
            return CLOSE_RST
        if (self.flags[0] & FIN) and (self.flags[1] & FIN):
            return CLOSE_FIN
        if now_ns - self.last_ns > FLOW_TIMEOUT_NS:
            return CLOSE_TIMEOUT
        return CLOSE_FORCED_REPORT


class FlowMap:
    """Cross-batch columnar flow table: batched ingest + 1s tick output.
    `device`: where each batch's segment reduction runs."""

    def __init__(self, vtap_id: int = 0, capacity: int = 1024, *,
                 device="cuda") -> None:
        self.device = check_device(device)
        self.vtap_id = vtap_id
        self._slot: Dict[Tuple[int, int, int, int, int], int] = {}
        self._free: List[int] = []
        self._next_flow_id = 1
        # opt-in per-packet context from inject() (flow_id/direction
        # gathers) — only the packet-sequence collector pays for it
        self.want_packet_context = False
        self.packets_in = 0
        self.invalid_packets = 0
        self.flows_created = 0
        self._alloc_cols(max(capacity, 16))
        self.perf = TcpPerf(self._cap)

    def _alloc_cols(self, cap: int) -> None:
        self._cap = cap
        z64 = lambda shape: np.zeros(shape, np.int64)  # noqa: E731
        self.c_key = z64((cap, 5))       # ip0 ip1 p0 p1 proto
        self.c_flow_id = np.zeros(cap, np.uint64)
        self.c_start = z64(cap)
        self.c_last = z64(cap)
        self.c_bytes = z64((cap, 2))
        self.c_pkts = z64((cap, 2))
        self.c_flags = z64((cap, 2))
        self.c_retrans = z64((cap, 2))
        self.c_max_seq = z64((cap, 2))
        self.c_syn = z64(cap)            # 0 = unset
        self.c_synack = z64(cap)
        self.c_tap_side = z64(cap)
        self.c_initiator = np.full(cap, -1, np.int8)
        self.c_reported = np.zeros(cap, np.bool_)
        self.c_live = np.zeros(cap, np.bool_)

    def _grow(self) -> None:
        old = {k: getattr(self, k) for k in (
            "c_key", "c_flow_id", "c_start", "c_last", "c_bytes", "c_pkts",
            "c_flags", "c_retrans", "c_max_seq", "c_syn", "c_synack",
            "c_tap_side", "c_initiator", "c_reported", "c_live")}
        n = self._cap
        self._alloc_cols(self._cap * 2)
        for k, v in old.items():
            getattr(self, k)[:n] = v
        self.perf.grow(self._cap)

    def _allocate(self, key: Tuple[int, int, int, int, int]) -> int:
        if self._free:
            s = self._free.pop()
        else:
            s = len(self._slot)
            while s >= self._cap or self.c_live[s]:
                if s >= self._cap:
                    self._grow()
                    continue
                s += 1
        self._slot[key] = s
        self.c_key[s] = key
        self.c_flow_id[s] = self._next_flow_id
        self._next_flow_id += 1
        self.c_start[s] = _BIG
        self.c_last[s] = 0
        self.c_bytes[s] = 0
        self.c_pkts[s] = 0
        self.c_flags[s] = 0
        self.c_retrans[s] = 0
        self.c_max_seq[s] = 0
        self.c_syn[s] = 0
        self.c_synack[s] = 0
        self.c_tap_side[s] = 0
        self.c_initiator[s] = -1
        self.c_reported[s] = False
        self.c_live[s] = True
        self.perf.reset_slot(s)
        self.flows_created += 1
        return s

    # -- ingest ------------------------------------------------------------
    def inject(self, pkt: Dict[str, np.ndarray]) -> Optional[dict]:
        """Fold one decoded packet batch into the flow table. Returns
        per-packet context for the VALID packets so per-packet
        consumers (the packet-sequence collector) reuse this pass's
        masking/orientation instead of recomputing it:
        {"cols": valid-filtered columns, "flow_id": [n] u64,
        "direction": [n] u32 — the flow's CANONICAL orientation bit
        (0 = packet travels lower-(ip,port)-first), stable for the
        flow's lifetime}."""
        valid = pkt["valid"]
        n = int(valid.sum())
        self.packets_in += len(valid)
        self.invalid_packets += len(valid) - n
        if n == 0:
            return None
        cols = {k: v[valid] for k, v in pkt.items()}

        # canonical orientation: lower (ip, port) first; dir=1 if reversed
        a = (cols["ip_src"].astype(_U64) << _U64(16)) | cols["port_src"]
        b = (cols["ip_dst"].astype(_U64) << _U64(16)) | cols["port_dst"]
        rev = a > b
        ip0 = np.where(rev, cols["ip_dst"], cols["ip_src"])
        ip1 = np.where(rev, cols["ip_src"], cols["ip_dst"])
        p0 = np.where(rev, cols["port_dst"], cols["port_src"])
        p1 = np.where(rev, cols["port_src"], cols["port_dst"])
        direction = rev.astype(np.uint32)

        ts = cols["timestamp_ns"].astype(np.int64)
        tap_side = cols.get("tap_side")
        if tap_side is None:
            tap_side = np.zeros(n, np.int64)
        flags = cols["tcp_flags"].astype(np.int64)
        is_syn = (flags & (SYN | ACK)) == SYN
        is_synack = (flags & (SYN | ACK)) == (SYN | ACK)
        has_payload = cols["payload_len"] > 0

        # per-(flow, direction) segment reduction — one device pass, one
        # copy of the reduced block back.
        # The 6-part key packs into 2 u64 words (ips | ports+proto+dir):
        # grouping cost is 2 radix-friendly i64 sorts, not a 48-byte
        # memcmp sort.
        k_ips = (ip0.astype(_U64) << _U64(32)) | ip1.astype(_U64)
        k_rest = ((p0.astype(_U64) << _U64(25))
                  | (p1.astype(_U64) << _U64(9))
                  | (cols["proto"].astype(_U64) << _U64(1))
                  | direction.astype(_U64))
        work = {
            "k_ips": k_ips, "k_rest": k_rest,
            "bytes": cols["pkt_len"], "pkts": np.ones(n, np.int64),
            "flags": flags, "ts_min": ts, "ts_max": ts,
            "syn_ts": np.where(is_syn, ts, _BIG),
            "synack_ts": np.where(is_synack, ts, _BIG),
            "seq_max": cols["tcp_seq"].astype(np.int64),
            "tap_side": tap_side.astype(np.int64),
            # payload packets whose seq never advances past the running max
            # are the batch-local retrans candidates; cross-batch handled
            # against the accumulator's max_seq at merge time
            "payload_pkts": has_payload.astype(np.int64),
        }
        red, inv = group_reduce(
            work, ["k_ips", "k_rest"],
            {"bytes": "sum", "pkts": "sum", "flags": "max",
             "ts_min": "min", "ts_max": "max", "syn_ts": "min",
             "synack_ts": "min", "seq_max": "max", "payload_pkts": "sum",
             "tap_side": "max"},
            return_inverse=True, device=self.device)
        # flags need OR, not max: OR-reduce per group on host, reusing the
        # group ids from the reduction (group count << packet count)
        red_flags = np.zeros(len(red["k_ips"]), np.int64)
        np.bitwise_or.at(red_flags, inv, flags)

        m = len(red["k_ips"])
        # unpack the key words back to tuple form for slot resolution
        rk_ips = red["k_ips"].astype(_U64)
        rk_rest = red["k_rest"].astype(_U64)
        r_ip0 = (rk_ips >> _U64(32)).astype(np.int64)
        r_ip1 = (rk_ips & _U64(0xFFFFFFFF)).astype(np.int64)
        r_p0 = (rk_rest >> _U64(25)).astype(np.int64)
        r_p1 = ((rk_rest >> _U64(9)) & _U64(0xFFFF)).astype(np.int64)
        r_proto = ((rk_rest >> _U64(1)) & _U64(0xFF)).astype(np.int64)
        # slot resolution: the ONLY per-group Python — one dict op each
        keys = list(zip(r_ip0.tolist(), r_ip1.tolist(), r_p0.tolist(),
                        r_p1.tolist(), r_proto.tolist()))
        get = self._slot.get
        slots = np.fromiter(
            (s if (s := get(k)) is not None else self._allocate(k)
             for k in keys), dtype=np.int64, count=m)
        d = (rk_rest & _U64(1)).astype(np.int64)

        # everything below is vectorized scatter over (slot, dir). A slot
        # can appear for both directions in one batch, so per-slot columns
        # use .at reductions; per-(slot, dir) targets are unique and can
        # assign directly.
        prev_pkts = self.c_pkts[slots, d]
        prev_max = self.c_max_seq[slots, d]
        seq = red["seq_max"]
        self.c_bytes[slots, d] += red["bytes"]
        self.c_pkts[slots, d] = prev_pkts + red["pkts"]
        self.c_flags[slots, d] |= red_flags
        # retrans estimate: payload packets that failed to move seq_max
        self.c_retrans[slots, d] += np.where(
            (prev_pkts > 0) & (prev_max > 0) & (seq <= prev_max),
            red["payload_pkts"], 0)
        self.c_max_seq[slots, d] = np.maximum(prev_max, seq)
        np.minimum.at(self.c_start, slots, red["ts_min"])
        np.maximum.at(self.c_last, slots, red["ts_max"])
        # capture-point side (dispatcher MAC orientation) — constant per
        # observation point, so max-merge is exact
        np.maximum.at(self.c_tap_side, slots, red["tap_side"])
        # handshake stamps: 0 means unset — lift touched slots to +inf
        # BEFORE the min-scatter (min against a 0 target would stick), and
        # lower the never-set ones back after
        touched = np.unique(slots)
        for col, cand in ((self.c_syn, red["syn_ts"]),
                          (self.c_synack, red["synack_ts"])):
            cur = col[touched]
            col[touched] = np.where(cur == 0, _BIG, cur)
            np.minimum.at(col, slots, cand)
            cur = col[touched]
            col[touched] = np.where(cur >= _BIG, 0, cur)
        # initiator: direction of the earliest SYN. Write candidates in
        # DESCENDING syn_ts order so the earliest lands last (last write
        # wins on duplicate fancy indices); only unset slots take it.
        cand = np.nonzero((red["syn_ts"] < _BIG)
                          & (self.c_initiator[slots] < 0))[0]
        if len(cand):
            order = cand[np.argsort(-red["syn_ts"][cand],
                                    kind="stable")]
            self.c_initiator[slots[order]] = d[order].astype(np.int8)

        # TCP perf engine: per-PACKET pass (SRT/ART/CIT need packet
        # ordering the per-(flow,dir) reduction above deliberately
        # discards). Runs after the handshake-stamp merge so in-batch
        # SYN/SYN_ACK timestamps are already resolved in c_syn/c_synack.
        all_slots = slots[inv]
        tcp = np.nonzero(cols["proto"] == PROTO_TCP)[0]
        if len(tcp):
            pkt_slots = all_slots[tcp]
            zeros = np.zeros(n, np.int64)
            self.perf.inject(
                pkt_slots, direction[tcp], ts[tcp], flags[tcp],
                cols["tcp_seq"][tcp].astype(np.int64),
                cols.get("tcp_ack", zeros)[tcp].astype(np.int64),
                cols["payload_len"][tcp].astype(np.int64),
                cols.get("tcp_win", zeros)[tcp].astype(np.int64),
                self.c_syn[pkt_slots], self.c_synack[pkt_slots])
        if not self.want_packet_context:
            return None          # default path: no per-packet gathers
        # the direction bit uses CANONICAL orientation (lower (ip,port)
        # first) — the only basis that is stable for a flow's whole
        # lifetime. An initiator-relative bit would flip mid-flow when
        # the SYN arrives after mid-stream capture started, leaving one
        # block with contradictory bits. The l4_flow_log row for the
        # same flow_id records which canonical side initiated.
        return {"cols": cols, "flow_id": self.c_flow_id[all_slots],
                "direction": direction.astype(np.uint32)}

    # -- tick output -------------------------------------------------------
    def tick_columns(self, now_ns: Optional[int] = None,
                     emit_active: bool = True) -> Dict[str, np.ndarray]:
        """One vectorized pass: closed flows are removed; active ones are
        reported as *interval deltas* and kept with their counters reset
        (the reference's 1s forced report reports per-interval traffic
        too — re-emitting cumulative totals would double-count downstream
        sums). Output columns are oriented client->server: the initiator
        (first SYN sender) is the client."""
        now_ns = int(time.time() * 1e9) if now_ns is None else now_ns
        live = self.c_live
        flags0, flags1 = self.c_flags[:, 0], self.c_flags[:, 1]
        ct = np.zeros(self._cap, np.uint32)
        ct[now_ns - self.c_last > FLOW_TIMEOUT_NS] = CLOSE_TIMEOUT
        ct[((flags0 & FIN) > 0) & ((flags1 & FIN) > 0)] = CLOSE_FIN
        ct[((flags0 | flags1) & RST) > 0] = CLOSE_RST
        closed = live & (ct != CLOSE_FORCED_REPORT)
        active = live & (ct == CLOSE_FORCED_REPORT) & \
            (self.c_pkts.sum(axis=1) > 0)
        emit = closed | (active if emit_active else False)
        idx = np.nonzero(emit)[0]

        cli = np.maximum(self.c_initiator[idx], 0).astype(np.int64)
        srv = 1 - cli
        ips = self.c_key[idx, 0:2]
        ports = self.c_key[idx, 2:4]
        r = np.arange(len(idx))
        syn, synack = self.c_syn[idx], self.c_synack[idx]
        out = {
            "ip_src": ips[r, cli].astype(np.uint32),
            "ip_dst": ips[r, srv].astype(np.uint32),
            "port_src": ports[r, cli].astype(np.uint32),
            "port_dst": ports[r, srv].astype(np.uint32),
            "proto": self.c_key[idx, 4].astype(np.uint32),
            "vtap_id": np.full(len(idx), self.vtap_id, np.uint32),
            "byte_tx": self.c_bytes[idx][r, cli].astype(np.uint64),
            "byte_rx": self.c_bytes[idx][r, srv].astype(np.uint64),
            "packet_tx": self.c_pkts[idx][r, cli].astype(np.uint64),
            "packet_rx": self.c_pkts[idx][r, srv].astype(np.uint64),
            "retrans": self.c_retrans[idx].sum(axis=1).astype(np.uint32),
            "retrans_tx": self.c_retrans[idx][r, cli].astype(np.uint32),
            "retrans_rx": self.c_retrans[idx][r, srv].astype(np.uint32),
            "close_type": ct[idx],
            "flow_id": self.c_flow_id[idx],
            "start_time": self.c_start[idx].astype(np.uint64),
            "duration": np.maximum(self.c_last[idx] - self.c_start[idx],
                                   0).astype(np.uint64),
            "tap_side": self.c_tap_side[idx].astype(np.uint32),
            "l3_epc_id": np.zeros(len(idx), np.int32),
            "is_new_flow": (~self.c_reported[idx]).astype(np.uint32),
        }
        # LogMessageStatus (l4_flow_log.go getStatus :857) computed HERE
        # so the planar columnar wire carries the same value the server
        # derives for protobuf streams (wire-mode must not change data)
        proto_tcp = out["proto"] == PROTO_TCP
        ctv = ct[idx]
        out["status"] = np.where(
            (ctv == CLOSE_FORCED_REPORT) | (ctv == CLOSE_FIN), 0,
            np.where(ctv == CLOSE_TIMEOUT, np.where(proto_tcp, 3, 0),
                     np.where(ctv == CLOSE_RST, 3, 2))).astype(np.uint32)
        # perf-engine window columns (rtt/srt/art/cit/zero-win/...);
        # the full-handshake rtt falls back to the SYN->SYN_ACK estimate
        # when the engine saw no handshake ACK (e.g. ack-less captures)
        perf = self.perf.report(idx, cli)
        est = np.where((syn > 0) & (synack > syn),
                       (synack - syn) // 1000, 0).astype(np.uint32)
        perf["rtt"] = np.where(perf["rtt"] > 0, perf["rtt"], est)
        out.update(perf)
        # reset interval counters on kept-active flows; free closed slots
        act_idx = np.nonzero(active)[0] if emit_active else \
            np.empty(0, np.int64)
        self.c_bytes[act_idx] = 0
        self.c_pkts[act_idx] = 0
        self.c_retrans[act_idx] = 0
        self.c_reported[act_idx] = True
        self.perf.window_reset(act_idx)
        for s in np.nonzero(closed)[0]:
            self.c_live[s] = False
            del self._slot[tuple(self.c_key[s].tolist())]
            self._free.append(int(s))
        return out

    def tick(self, now_ns: Optional[int] = None,
             emit_active: bool = True) -> List[FlowAcc]:
        """Row-view tick for callers that want per-flow objects (tests,
        ad-hoc inspection). Same semantics as tick_columns; the column
        path is the hot one."""
        now_ns = int(time.time() * 1e9) if now_ns is None else now_ns
        snap = self._row_views(now_ns)
        self.tick_columns(now_ns, emit_active=emit_active)
        out = []
        for f in snap:
            closed = f.close_type(now_ns) != CLOSE_FORCED_REPORT
            if closed or (emit_active and f.packets != [0, 0]):
                out.append(f)
        return out

    def _row_views(self, now_ns: int) -> List[FlowAcc]:
        out = []
        for s in np.nonzero(self.c_live)[0]:
            k = self.c_key[s]
            out.append(FlowAcc(
                int(k[0]), int(k[1]), int(k[2]), int(k[3]), int(k[4]),
                flow_id=int(self.c_flow_id[s]),
                start_ns=int(self.c_start[s]), last_ns=int(self.c_last[s]),
                bytes_=self.c_bytes[s].tolist(),
                packets=self.c_pkts[s].tolist(),
                flags=self.c_flags[s].tolist(),
                retrans=self.c_retrans[s].tolist(),
                max_seq=self.c_max_seq[s].tolist(),
                syn_ns=int(self.c_syn[s]), synack_ns=int(self.c_synack[s]),
                initiator=int(self.c_initiator[s]),
                reported=bool(self.c_reported[s])))
        return out

    def __len__(self) -> int:
        return len(self._slot)

    def counters(self) -> dict:
        return {"packets_in": self.packets_in,
                "invalid_packets": self.invalid_packets,
                "flows_created": self.flows_created,
                "active_flows": len(self._slot)}


def flows_to_columns(flows: List[FlowAcc], vtap_id: int,
                     now_ns: int) -> Dict[str, np.ndarray]:
    """TaggedFlow-equivalent columns from FlowAcc row views (compat for
    the tick() path; tick_columns emits these directly)."""
    n = len(flows)
    cols = {k: np.zeros(n, dt) for k, dt in (
        ("ip_src", np.uint32), ("ip_dst", np.uint32),
        ("port_src", np.uint32), ("port_dst", np.uint32),
        ("proto", np.uint32), ("vtap_id", np.uint32),
        ("byte_tx", np.uint64), ("byte_rx", np.uint64),
        ("packet_tx", np.uint64), ("packet_rx", np.uint64),
        ("retrans", np.uint32), ("rtt", np.uint32),
        ("close_type", np.uint32), ("flow_id", np.uint64),
        ("start_time", np.uint64), ("duration", np.uint64),
        ("tap_side", np.uint32), ("l3_epc_id", np.int32),
        ("is_new_flow", np.uint32))}
    for i, f in enumerate(flows):
        cli = f.initiator if f.initiator >= 0 else 0
        srv = 1 - cli
        ips = (f.ip0, f.ip1)
        ports = (f.port0, f.port1)
        cols["ip_src"][i] = ips[cli]
        cols["ip_dst"][i] = ips[srv]
        cols["port_src"][i] = ports[cli]
        cols["port_dst"][i] = ports[srv]
        cols["proto"][i] = f.proto
        cols["vtap_id"][i] = vtap_id
        cols["byte_tx"][i] = f.bytes_[cli]
        cols["byte_rx"][i] = f.bytes_[srv]
        cols["packet_tx"][i] = f.packets[cli]
        cols["packet_rx"][i] = f.packets[srv]
        cols["retrans"][i] = f.retrans[0] + f.retrans[1]
        cols["rtt"][i] = f.rtt_us
        cols["close_type"][i] = f.close_type(now_ns)
        cols["flow_id"][i] = f.flow_id
        cols["start_time"][i] = f.start_ns
        cols["duration"][i] = max(f.last_ns - f.start_ns, 0)
        cols["is_new_flow"][i] = 0 if f.reported else 1
    return cols
