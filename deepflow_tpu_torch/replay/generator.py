"""Synthetic agent: generates wire-exact firehose traffic.

The port's copy of the JAX package's `replay/generator.py`: the same
numpy draws in the same order, so columns, records and frames are equal
for the same seed. Stands in for the Rust agent in tests and benchmarks,
the way the reference uses synthetic senders (reference:
server/ingester/droplet/adapter/tools/send.go) and pcap fixtures
(SURVEY.md §4). Produces TaggedFlow / Document protobuf records with a
Zipf-heavy key distribution plus the matching ground-truth numpy
columns, so decoder and sketch outputs can be scored against exact
aggregation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.wire import (
                                     FlowHeader,
                                     MessageType,
                                     encode_frame,
                                     pack_pb_records,
                                     )
from deepflow_tpu_torch.wire.gen import flow_log_pb2, metric_pb2


@dataclass
class SyntheticAgent:
    """Generates l4 TaggedFlow and flow_metrics Document streams."""

    seed: int = 0xA9E27
    vtap_id: int = 7
    n_hosts: int = 4096          # distinct client IPs
    n_services: int = 64         # distinct (server ip, port) pairs
    zipf_a: float = 1.25
    _seq: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        base = int.from_bytes(b"\x0a\x00\x00\x00", "big")
        self.client_ips = (base + self.rng.choice(1 << 20, self.n_hosts, replace=False)).astype(np.uint32)
        sbase = int.from_bytes(b"\xac\x10\x00\x00", "big")
        self.server_ips = (sbase + self.rng.choice(1 << 16, self.n_services, replace=False)).astype(np.uint32)
        self.server_ports = self.rng.choice(
            np.array([80, 443, 3306, 6379, 8080, 9092, 5432, 53], np.uint32),
            self.n_services,
        )

    def l4_columns(self, n: int) -> dict:
        """Ground-truth columns for n flow records (Zipf-heavy services)."""
        r = self.rng
        svc = (r.zipf(self.zipf_a, n) - 1).clip(max=self.n_services - 1)
        cli = r.integers(0, self.n_hosts, n)
        cols = {
            "ip_src": self.client_ips[cli],
            "ip_dst": self.server_ips[svc],
            "port_src": r.integers(1024, 65536, n).astype(np.uint32),
            "port_dst": self.server_ports[svc].astype(np.uint32),
            "proto": np.where(r.random(n) < 0.9, 6, 17).astype(np.uint32),
            "vtap_id": np.full(n, self.vtap_id, np.uint32),
            "tap_side": r.integers(0, 3, n).astype(np.uint32),
            "byte_tx": r.lognormal(6.0, 1.5, n).astype(np.uint64),
            "byte_rx": r.lognormal(7.0, 1.5, n).astype(np.uint64),
            "packet_tx": r.integers(1, 64, n).astype(np.uint64),
            "packet_rx": r.integers(1, 64, n).astype(np.uint64),
            "l3_epc_id": r.integers(-2, 100, n).astype(np.int32),
            "start_time": (np.uint64(1_700_000_000_000_000_000)
                           + np.arange(n, dtype=np.uint64) * np.uint64(1000)),
            "duration": r.integers(10_000, 10_000_000_000, n).astype(np.uint64),
            "close_type": r.integers(0, 8, n).astype(np.uint32),
            "flow_id": np.arange(n, dtype=np.uint64) + np.uint64(1),
            "rtt": r.integers(100, 200_000, n).astype(np.uint32),
            "retrans": (r.random(n) < 0.02).astype(np.uint32) * r.integers(1, 5, n).astype(np.uint32),
            # wide-schema families
            "mac_src": r.integers(0, 1 << 48, n).astype(np.uint64),
            "mac_dst": r.integers(0, 1 << 48, n).astype(np.uint64),
            "vlan": r.integers(0, 4096, n).astype(np.uint32),
            "tcp_flags_bit_0": r.integers(0, 256, n).astype(np.uint32),
            "tcp_flags_bit_1": r.integers(0, 256, n).astype(np.uint32),
            "syn_seq": r.integers(0, 1 << 32, n).astype(np.uint32),
            "synack_seq": r.integers(0, 1 << 32, n).astype(np.uint32),
            "l3_byte_tx": r.integers(0, 1 << 20, n).astype(np.uint32),
            "l3_byte_rx": r.integers(0, 1 << 20, n).astype(np.uint32),
            "total_packet_tx": r.integers(1, 128, n).astype(np.uint32),
            "total_packet_rx": r.integers(1, 128, n).astype(np.uint32),
            "rtt_client": r.integers(50, 100_000, n).astype(np.uint32),
            "rtt_server": r.integers(50, 100_000, n).astype(np.uint32),
            "retrans_tx": (r.random(n) < 0.02).astype(np.uint32),
            "retrans_rx": (r.random(n) < 0.02).astype(np.uint32),
            "l7_request": r.integers(0, 16, n).astype(np.uint32),
            "l7_response": r.integers(0, 16, n).astype(np.uint32),
            "direction_score": r.integers(0, 256, n).astype(np.uint32),
            "gprocess_id_0": r.integers(0, 1 << 16, n).astype(np.uint32),
            "gprocess_id_1": r.integers(0, 1 << 16, n).astype(np.uint32),
        }
        return cols

    def l4_columns_pooled(self, n: int, pool: int = 2048) -> dict:
        """Columns where rows sample a fixed pool of `pool` distinct flow
        5-tuples with Zipf weights — heavy flows genuinely repeat, so exact
        GROUP BY top-K is well-defined (the recall-harness feed)."""
        r = self.rng
        base = self.l4_columns(pool)
        pick = (r.zipf(self.zipf_a, n) - 1).clip(max=pool - 1)
        cols = {k: v[pick] for k, v in base.items()}
        cols["flow_id"] = np.arange(n, dtype=np.uint64) + np.uint64(1)
        cols["start_time"] = (np.uint64(1_700_000_000_000_000_000)
                              + np.arange(n, dtype=np.uint64) * np.uint64(1000))
        return cols

    @staticmethod
    def l4_record(cols: dict, i: int) -> bytes:
        """Serialize row i of the column dict as one TaggedFlow record."""
        def g(name: str, default: int = 0) -> int:
            return int(cols[name][i]) if name in cols else default

        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        k = f.flow_key
        k.vtap_id = int(cols["vtap_id"][i])
        k.tap_type = 3
        k.ip_src = int(cols["ip_src"][i])
        k.ip_dst = int(cols["ip_dst"][i])
        k.port_src = int(cols["port_src"][i])
        k.port_dst = int(cols["port_dst"][i])
        k.proto = int(cols["proto"][i])
        k.mac_src = g("mac_src")
        k.mac_dst = g("mac_dst")
        src = f.metrics_peer_src
        src.byte_count = int(cols["byte_tx"][i])
        src.packet_count = int(cols["packet_tx"][i])
        src.total_byte_count = int(cols["byte_tx"][i])
        src.total_packet_count = g("total_packet_tx")
        src.l3_byte_count = g("l3_byte_tx")
        src.l3_epc_id = int(cols["l3_epc_id"][i])
        src.tcp_flags = g("tcp_flags_bit_0")
        src.gpid = g("gprocess_id_0")
        dst = f.metrics_peer_dst
        dst.l3_epc_id = g("l3_epc_id_1", int(cols["l3_epc_id"][i]))
        dst.byte_count = int(cols["byte_rx"][i])
        dst.packet_count = int(cols["packet_rx"][i])
        dst.total_byte_count = int(cols["byte_rx"][i])
        dst.total_packet_count = g("total_packet_rx")
        dst.l3_byte_count = g("l3_byte_rx")
        dst.tcp_flags = g("tcp_flags_bit_1")
        dst.gpid = g("gprocess_id_1")
        f.flow_id = int(cols["flow_id"][i])
        f.start_time = int(cols["start_time"][i])
        f.end_time = int(cols["start_time"][i] + cols["duration"][i])
        f.duration = int(cols["duration"][i])
        f.eth_type = 0x0800
        f.vlan = g("vlan")
        f.close_type = int(cols["close_type"][i])
        f.tap_side = int(cols["tap_side"][i])
        f.is_new_flow = 1
        f.syn_seq = g("syn_seq")
        f.synack_seq = g("synack_seq")
        f.direction_score = g("direction_score")
        if cols["rtt"][i] or cols["retrans"][i]:
            f.has_perf_stats = 1
            f.perf_stats.l4_protocol = 1
            tcp = f.perf_stats.tcp
            tcp.rtt = int(cols["rtt"][i])
            tcp.total_retrans_count = int(cols["retrans"][i])
            tcp.rtt_client_max = g("rtt_client")
            tcp.rtt_server_max = g("rtt_server")
            tcp.counts_peer_tx.retrans_count = g("retrans_tx")
            tcp.counts_peer_rx.retrans_count = g("retrans_rx")
            l7 = f.perf_stats.l7
            l7.request_count = g("l7_request")
            l7.response_count = g("l7_response")
        return m.SerializeToString()

    def l4_batch(self, n: int) -> Tuple[dict, List[bytes]]:
        cols = self.l4_columns(n)
        return cols, [self.l4_record(cols, i) for i in range(n)]

    def metric_record(self, ts: int, svc: int, traffic: dict) -> bytes:
        d = metric_pb2.Document()
        d.timestamp = ts
        d.flags = 0
        # zerodoc Code for the dimensions actually populated below:
        # IP | Protocol | ServerPort | VTAPID (tag.go bit layout) — must
        # match agent/quadruple.py so replay and live documents sharing
        # a dimension set group together
        d.tag.code = 0x1 | (1 << 42) | (1 << 43) | (1 << 47)
        fld = d.tag.field
        fld.ip = int(self.server_ips[svc % self.n_services]).to_bytes(4, "big")
        fld.server_port = int(self.server_ports[svc % self.n_services])
        fld.vtap_id = self.vtap_id
        fld.protocol = 6
        d.meter.meter_id = 0
        t = d.meter.flow.traffic
        for name, val in traffic.items():
            setattr(t, name, int(val))
        return d.SerializeToString()

    def frames(self, records: List[bytes], msg_type: MessageType,
               per_frame: int = 64) -> Iterator[bytes]:
        """Pack records into wire frames with sequenced FlowHeaders."""
        for i in range(0, len(records), per_frame):
            payload = pack_pb_records(records[i:i + per_frame])
            self._seq += 1
            yield encode_frame(
                msg_type, payload,
                FlowHeader(sequence=self._seq, vtap_id=self.vtap_id),
            )


# -- DDoS ramp profile -------------------------------------------

@dataclass(frozen=True)
class RampPhase:
    """One phase of the DDoS ramp: ``attack_frac`` of each window's
    rows are src-spoofed attack rows aimed at the victim ("ramp"
    phases interpolate 0 -> attack_frac across their windows);
    ``rate_mult`` scales the window's row count."""

    name: str
    windows: int
    attack_frac: float
    rate_mult: float = 1.0


# the default profile: quiet baseline, a 3-window ramp onto the victim,
# a sustained flood, traffic normalizing. The same schedule as the JAX
# package's, so "detection latency <= 2 windows of onset" means the
# same thing in both packages' tests and in chip_smoke.py.
DDOS_RAMP_PHASES = (
    RampPhase("baseline", 12, 0.0),
    RampPhase("ramp", 3, 0.9, rate_mult=2.0),
    RampPhase("sustained", 5, 0.9, rate_mult=3.0),
    RampPhase("recovery", 8, 0.0),
)


class DDoSRamp:
    """Deterministic windowed DDoS traffic: per-window l4 lane columns
    (the full SyntheticAgent schema, so every wire/decoder eats them)
    plus matching ``metric_record`` golden-signal traffic dicts.

    Determinism is per-(seed, window): ``window_cols(w)`` derives its
    RNG from the seed and the window index alone, so any consumer —
    test, smoke run, two processes replaying against each
    other — sees identical bytes for window w regardless of iteration
    order or how many windows it materializes."""

    def __init__(self, seed: int = 0xDD05,
                 phases: Optional[Tuple[RampPhase, ...]] = None,
                 rows_per_window: int = 4096,
                 victim_ip: int = 0xAC10BEEF,
                 victim_port: int = 80) -> None:
        self.seed = int(seed)
        self.phases = tuple(phases or DDOS_RAMP_PHASES)
        self.rows_per_window = int(rows_per_window)
        self.victim_ip = np.uint32(victim_ip)
        self.victim_port = np.uint32(victim_port)
        # a stable flow pool for the benign share: heavy hitters
        # genuinely repeat across windows (the recall-harness feed)
        self._agent = SyntheticAgent(seed=self.seed)
        self._pool = self._agent.l4_columns_pooled(
            max(2048, rows_per_window), pool=512)

    @property
    def n_windows(self) -> int:
        return sum(p.windows for p in self.phases)

    @property
    def onset_window(self) -> int:
        """First window carrying any attack rows — the latency anchor
        every consumer measures detection against."""
        w = 0
        for p in self.phases:
            if p.attack_frac > 0:
                return w
            w += p.windows
        return w

    def phase_of(self, w: int) -> Tuple[RampPhase, int]:
        """(phase, index within the phase) for window w."""
        off = w
        for p in self.phases:
            if off < p.windows:
                return p, off
            off -= p.windows
        return self.phases[-1], self.phases[-1].windows - 1

    def _attack_frac(self, w: int) -> float:
        p, i = self.phase_of(w)
        frac = p.attack_frac
        if p.name == "ramp" and p.windows > 1:
            frac = p.attack_frac * (i + 1) / p.windows
        return frac

    def window_cols(self, w: int) -> Tuple[str, dict]:
        """(phase name, l4 columns) for window w. Benign rows resample
        the stable pool; attack rows are src-spoofed (uniform /12
        space), single-victim, single-port, 1-packet SYN-shaped."""
        p, _ = self.phase_of(w)
        rng = np.random.default_rng((self.seed, w))
        n = max(1, int(self.rows_per_window * p.rate_mult))
        pool_n = len(next(iter(self._pool.values())))
        pick = rng.integers(0, pool_n, n)
        cols = {k: v[pick].copy() for k, v in self._pool.items()}
        n_attack = int(n * self._attack_frac(w))
        if n_attack:
            sl = slice(n - n_attack, n)      # attack rows at the tail
            cols["ip_src"][sl] = rng.integers(
                0, 1 << 20, n_attack).astype(np.uint32) \
                + np.uint32(0x0B000000)
            cols["ip_dst"][sl] = self.victim_ip
            cols["port_src"][sl] = rng.integers(
                1024, 65536, n_attack).astype(np.uint32)
            cols["port_dst"][sl] = self.victim_port
            cols["proto"][sl] = 6
            # volumetric flood: big one-way packet trains per flow tick
            # (the packet-weighted dst entropy must actually collapse
            # onto the victim, not just the flow-count entropy)
            cols["packet_tx"][sl] = 96
            cols["packet_rx"][sl] = 0
            cols["byte_tx"][sl] = 40 * 96
            cols["byte_rx"][sl] = 0
            cols["retrans"][sl] = 0
        cols["flow_id"] = (np.uint64(w) << np.uint64(32)) \
            + np.arange(n, dtype=np.uint64) + np.uint64(1)
        return p.name, cols

    def windows(self) -> Iterator[Tuple[int, str, dict]]:
        for w in range(self.n_windows):
            name, cols = self.window_cols(w)
            yield w, name, cols

    @staticmethod
    def golden_traffic(cols: dict) -> dict:
        """The window's flow_metrics golden signals (the traffic dict
        ``SyntheticAgent.metric_record`` serializes) derived from the
        SAME columns, so the l4 and metric wires describe one story."""
        n = len(cols["ip_src"])
        return {
            "packet_tx": int(cols["packet_tx"].sum()),
            "packet_rx": int(cols["packet_rx"].sum()),
            "byte_tx": int(cols["byte_tx"].sum()),
            "byte_rx": int(cols["byte_rx"].sum()),
            "new_flow": n,
            "closed_flow": int((cols["close_type"] > 0).sum()),
            # a spoofed flood is one-way: no reply packets ever come
            "syn": int((cols["packet_rx"] == 0).sum()),
        }

    def metric_documents(self, w: int, ts: Optional[int] = None
                         ) -> List[bytes]:
        """One golden-signal Document for window w (reuses the same
        deterministic columns)."""
        _, cols = self.window_cols(w)
        return [self._agent.metric_record(
            int(1_700_000_000 + w if ts is None else ts), 0,
            self.golden_traffic(cols))]


def ddos_ramp(seed: int = 0xDD05,
              phases: Optional[Tuple[RampPhase, ...]] = None,
              **kw) -> DDoSRamp:
    """The deterministic DDoS ramp profile (baseline -> src-spoofed
    ramp -> sustained -> recovery), shared by the tests and
    chip_smoke.py's replay-driven node."""
    return DDoSRamp(seed=seed, phases=phases, **kw)


# -- bursty diurnal duty-cycle sweep ------------------------------

# the default day: quiet trough, morning rise, sustained peak, a short
# 8x burst riding the peak, evening fall, night trough. rate_mult IS
# the duty cycle under sweep — the feed autotuner must be within ~10%
# of the best static config at EVERY phase, which only means something
# if the phases actually disagree about the right knobs.
DIURNAL_PHASES = (
    RampPhase("trough", 4, 0.0, rate_mult=0.25),
    RampPhase("rise", 3, 0.0, rate_mult=1.0),
    RampPhase("peak", 6, 0.0, rate_mult=4.0),
    RampPhase("burst", 2, 0.0, rate_mult=8.0),
    RampPhase("fall", 3, 0.0, rate_mult=1.0),
    RampPhase("night", 4, 0.0, rate_mult=0.25),
)


class BurstyDiurnal(DDoSRamp):
    """Deterministic bursty-diurnal traffic: the DDoSRamp machinery
    (per-(seed, window) RNG, stable benign flow pool, golden-signal
    twins) with NO attack rows — the profile varies only the offered
    rate, sweeping the duty cycle the feed autotuner tunes across.

    The same ``window_cols(w)`` columns feed every wire: the dict wire
    packs them through FlowDictPacker (the stable pool makes flows
    genuinely repeat, so the news/hits split is exercised, not just
    news), the lanes wire packs them into slot planes, and
    ``l4_frames(w)`` serializes them as TaggedFlow wire frames for a
    LIVE ingester replay. Determinism is
    per-(seed, window) exactly like the ramp: any consumer sees
    identical bytes for window w."""

    def l4_frames(self, w: int, per_frame: int = 64) -> List[bytes]:
        """Window w as wire-exact TaggedFlow frames (sequence numbers
        restart per window so two processes replaying different window
        ranges stay deterministic)."""
        _, cols = self.window_cols(w)
        n = len(cols["ip_src"])
        agent = SyntheticAgent(seed=(self.seed ^ 0x5EED) + w)
        recs = [agent.l4_record(cols, i) for i in range(n)]
        return list(agent.frames(recs, MessageType.TAGGEDFLOW,
                                 per_frame=per_frame))


def bursty_diurnal(seed: int = 0xD1A7,
                   phases: Optional[Tuple[RampPhase, ...]] = None,
                   **kw) -> BurstyDiurnal:
    """The deterministic bursty-diurnal duty-cycle sweep (trough ->
    rise -> peak -> 8x burst -> fall -> night), the offered-rate sweep
    the feed autotuner is tuned across."""
    return BurstyDiurnal(seed=seed, phases=phases or DIURNAL_PHASES, **kw)
