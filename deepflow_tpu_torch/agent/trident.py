"""Agent orchestrator (reference: agent/src/trident.rs + rpc/synchronizer).

The port of the JAX package's `agent/trident.py`. Builds the
capture-side pipeline -- packet decode, policy labeler, flow map, L7
session parsing, quadruple generator, uniform senders -- and runs the
control loops: a controller sync heartbeat that registers the agent,
hot-applies pushed config (reference: ConfigHandler diff/apply), follows
ingester reassignment, and escapes to safe defaults when the controller
goes silent; plus the 1s tick that flushes flows and metric documents
onto the firehose.

`Agent(cfg, device=...)` places the two device callers: each capture
batch's `FlowMap.inject` segment reduction and each tick's
`flows_to_documents` rollup (CUDA by default, the CPU only when named).
The wire half (`columns_to_l4_schema`, `columns_to_l4_records`,
`l7_session_message`) is host code. Branches whose modules are not
ported (.so and wasm plugins, the OnCPU profiler, the TLS uprobes, the
k8s apiserver watch, the debug server) raise NotImplementedError when
configured.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.agent.flow_map import FlowMap
from deepflow_tpu_torch.agent.guard import EscapeTimer, Guard
from deepflow_tpu_torch.agent.l7 import (MSG_REQUEST, SessionAggregator,
                                         parse_payload)
# AFTER l7: the l7 <-> l7_ext pair registers extended parsers at
# import time, and l7 must win the import race (importing l7_ext
# first leaves it partially initialized when l7 calls back into it)
from deepflow_tpu_torch.agent.l7_ext import L7_TLS
from deepflow_tpu_torch.agent.packet import PROTO_TCP, PROTO_UDP
from deepflow_tpu_torch.agent.policy import (PolicyEnforcer,
                                             PolicyLabeler)
from deepflow_tpu_torch.agent.quadruple import (documents_to_records,
                                                flows_to_documents)
from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.batch.schema import L4_SCHEMA
from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.wire.framing import MessageType
from deepflow_tpu_torch.wire.gen import flow_log_pb2

__all__ = ["AgentConfig", "Agent", "columns_to_l4_schema",
           "columns_to_l4_records", "l7_session_message", "not_ported"]


def not_ported(what: str, module: str) -> NotImplementedError:
    """The error a branch outside the port raises when configured."""
    return NotImplementedError(
        f"{what} needs deepflow_tpu_torch/agent/{module}, which is not "
        f"ported yet (ROADMAP Queue 1 item 1)")


@dataclass
class AgentConfig:
    ctrl_ip: str = "127.0.0.1"
    host: str = "agent-host"
    controller_url: Optional[str] = None      # None = standalone mode
    ingester_addr: str = "127.0.0.1:30033"
    sync_interval_s: float = 60.0
    escape_after_s: float = 300.0
    revision: str = "deepflow-tpu-agent"
    l7_enabled: bool = True
    # "columnar" ships tick flows as planar COLUMNAR_FLOW frames
    # (vectorized encode, memcpy decode); "protobuf" emits per-row
    # TaggedFlow records for reference-compatible servers
    wire_mode: str = "columnar"
    # platform sync (agent/platform.py): interface report cadence, and an
    # optional k8s resource file to watch (api_watcher analogue)
    platform_sync_interval_s: float = 60.0
    k8s_resource_file: Optional[str] = None
    k8s_cluster_domain: str = "k8s-cluster"
    # live apiserver list/watch (agent/k8s_watch.py, not ported); takes
    # precedence over the file lister when set
    k8s_apiserver_url: Optional[str] = None
    k8s_apiserver_token: Optional[str] = None
    # KVM host: libvirt qemu domain-XML directory to extract guest
    # NICs from (reference: libvirt_xml_extractor.rs); None = off
    libvirt_xml_dir: Optional[str] = None
    # shared-object L7 plugins (agent/plugin.py, not ported)
    so_plugins: tuple = ()
    # sandboxed wasm L7 plugins (agent/wasm_plugin.py, not ported)
    wasm_plugins: tuple = ()
    # packet-sequence collection (agent/packet_sequence.py): per-packet
    # TCP headers -> l4_packet rows. Off by default like the reference's
    # packet_sequence_flag=0 (config.rs:519)
    packet_sequence: bool = False
    # l4 flow-log aggregation interval (agent/flow_aggr.py, the
    # collector/flow_aggr.rs role): 0 ships every 1s tick row; 60
    # matches the reference's 1m l4_flow_log granularity. The metrics
    # fork (quadruple documents) always stays at 1s either way.
    l4_log_aggr_s: int = 0
    # agent-side L7 session rate cap per second (reference:
    # l7_log_collect_nps_threshold, default 10000); 0 = uncapped
    l7_log_rate: int = 10_000
    # continuous OnCPU profiling (agent/profiler.py, not ported): pids
    # to sample. Empty = off.
    profile_pids: tuple = ()
    profile_interval_s: float = 10.0
    profile_duration_s: float = 1.0
    profile_freq_hz: int = 99
    # agent-side UDP debug server (not ported). None disables
    debug_port: Optional[int] = None
    # where controller-pushed upgrade packages are staged (rpc Upgrade
    # role); None = /tmp
    upgrade_dir: Optional[str] = None
    # ship the agent's own counters as DFSTATS onto the firehose
    # (reference: utils/stats.rs -> ingester deepflow_system DB)
    self_telemetry: bool = True
    # dispatcher (agent/dispatcher.py): capture mode + policy actions
    dispatcher_mode: str = "local"
    local_macs: tuple = ()
    npb_addr: Optional[str] = None            # NPB action target
    npb_tunnel: str = "raw"                   # "raw" | "vxlan" encap
    pcap_policy_dir: Optional[str] = None     # PCAP action sink


def columns_to_l4_schema(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Vectorized tick-columns -> L4_SCHEMA planar columns, the payload of
    the columnar wire mode. Matches the server decoders' unit contract
    (timestamp s, duration us, 4-byte planes) without any per-row work."""
    out: Dict[str, np.ndarray] = {}
    for name, dt in L4_SCHEMA.columns:
        if name == "timestamp":
            out[name] = (cols["start_time"]
                         // np.uint64(1_000_000_000)).astype(dt)
        elif name == "duration_us":
            out[name] = np.minimum(cols["duration"] // np.uint64(1000),
                                   np.uint64(0xFFFFFFFF)).astype(dt)
        elif name in cols:
            out[name] = cols[name].astype(dt, copy=False)
        else:
            out[name] = np.zeros(len(cols["ip_src"]), dt)
    return out


def columns_to_l4_records(cols: Dict[str, np.ndarray]) -> List[bytes]:
    """Serialize tick flow columns as TaggedFlow wire records."""
    out: List[bytes] = []
    for i in range(len(cols["ip_src"])):
        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        k = f.flow_key
        k.vtap_id = int(cols["vtap_id"][i])
        k.ip_src = int(cols["ip_src"][i])
        k.ip_dst = int(cols["ip_dst"][i])
        k.port_src = int(cols["port_src"][i])
        k.port_dst = int(cols["port_dst"][i])
        k.proto = int(cols["proto"][i])
        src = f.metrics_peer_src
        src.byte_count = int(cols["byte_tx"][i])
        src.packet_count = int(cols["packet_tx"][i])
        src.l3_epc_id = int(cols["l3_epc_id"][i])
        dst = f.metrics_peer_dst
        dst.byte_count = int(cols["byte_rx"][i])
        dst.packet_count = int(cols["packet_rx"][i])
        f.flow_id = int(cols["flow_id"][i])
        f.start_time = int(cols["start_time"][i])
        f.duration = int(cols["duration"][i])
        f.end_time = f.start_time + f.duration
        f.close_type = int(cols["close_type"][i])
        f.tap_side = int(cols["tap_side"][i])
        f.is_new_flow = int(cols["is_new_flow"][i])
        f.eth_type = 0x0800
        has_perf = cols["rtt"][i] or cols["retrans"][i]
        if not has_perf:
            # any engine signal warrants the stats block: a mid-stream
            # capture can have zero-window/CIT/continuous-RTT data with
            # no handshake rtt and no retransmissions
            for name in ("srt_count", "art_count", "cit_count",
                         "zero_win_tx", "zero_win_rx", "syn_count",
                         "synack_count", "rtt_client", "rtt_server"):
                if name in cols and cols[name][i]:
                    has_perf = True
                    break
        if has_perf:
            f.has_perf_stats = 1
            f.perf_stats.l4_protocol = 1
            t = f.perf_stats.tcp
            t.rtt = int(cols["rtt"][i])
            t.total_retrans_count = int(cols["retrans"][i])
            for name in ("srt_sum", "srt_count", "srt_max", "art_sum",
                         "art_count", "art_max", "cit_sum", "cit_count",
                         "cit_max", "syn_count", "synack_count"):
                if name in cols:
                    setattr(t, name, int(cols[name][i]))
            if "rtt_client" in cols:
                t.rtt_client_max = int(cols["rtt_client"][i])
                t.rtt_server_max = int(cols["rtt_server"][i])
                t.counts_peer_tx.retrans_count = int(cols["retrans_tx"][i])
                t.counts_peer_rx.retrans_count = int(cols["retrans_rx"][i])
                t.counts_peer_tx.zero_win_count = \
                    int(cols["zero_win_tx"][i])
                t.counts_peer_rx.zero_win_count = \
                    int(cols["zero_win_rx"][i])
        out.append(m.SerializeToString())
    return out


def l7_session_message(flow, rec_dict: dict, ts_ns: int,
                       vtap_id: int) -> "flow_log_pb2.AppProtoLogsData":
    """Merged l7 session -> AppProtoLogsData message. ts_ns is the merge
    (response) time; start backs off by the measured round trip."""
    m = flow_log_pb2.AppProtoLogsData()
    b = m.base
    b.start_time = max(ts_ns - rec_dict["rrt_us"] * 1000, 0)
    b.end_time = ts_ns
    b.vtap_id = vtap_id
    b.ip_src, b.ip_dst = int(flow[0]), int(flow[1])
    b.port_src, b.port_dst = int(flow[2]), int(flow[3])
    b.protocol = int(flow[4])
    b.head.proto = rec_dict["proto"]
    b.head.msg_type = 2                # merged session (LogMessageType)
    b.head.rrt = rec_dict["rrt_us"] * 1000
    m.req.endpoint = rec_dict["endpoint"]
    m.resp.status = rec_dict["status"]
    m.req_len = rec_dict["req_len"]
    m.resp_len = rec_dict["resp_len"]
    # instrumented-app trace context + request detail (parsers stamp
    # these when present; empty strings hash to 0 = reference NULL)
    m.version = rec_dict.get("version", "")
    m.req.req_type = rec_dict.get("req_type", "")
    m.req.domain = rec_dict.get("domain", "")
    m.req.resource = rec_dict.get("resource", "")
    m.trace_info.trace_id = rec_dict.get("trace_id", "")
    m.trace_info.span_id = rec_dict.get("span_id", "")
    m.ext_info.x_request_id_0 = rec_dict.get("x_request_id_0", "")
    m.ext_info.x_request_id_1 = rec_dict.get("x_request_id_1", "")
    m.ext_info.client_ip = rec_dict.get("client_ip", "")
    m.ext_info.http_user_agent = rec_dict.get("user_agent", "")
    m.ext_info.http_referer = rec_dict.get("referer", "")
    # packet-path TLS detection: a session the TLS parser recognized
    # (handshake metadata -- SNI/version; the payload itself stays
    # encrypted) carries the is_tls bit, so "WHERE is_tls = 1" finds it
    if rec_dict["proto"] == L7_TLS:
        m.flags = m.flags | 1
    return m


def _l7_record_bytes(flow, rec_dict: dict, ts_ns: int,
                     vtap_id: int) -> bytes:
    return l7_session_message(flow, rec_dict, ts_ns,
                              vtap_id).SerializeToString()


class Agent:
    """Standalone or managed capture agent. `device`: where the flow
    map's batch reduction and the tick's Document rollup run."""

    def __init__(self, cfg: AgentConfig, *, device="cuda") -> None:
        # refuse what this package cannot build before any socket opens
        if cfg.so_plugins:
            raise not_ported("so_plugins", "plugin.py")
        if cfg.wasm_plugins:
            raise not_ported("wasm_plugins", "wasm_plugin.py")
        if cfg.profile_pids:
            raise not_ported("profile_pids", "profiler.py")
        if cfg.k8s_apiserver_url:
            raise not_ported("k8s_apiserver_url", "k8s_watch.py")
        if cfg.debug_port is not None:
            raise not_ported("debug_port (its ebpf dump)",
                             "bpf.py, socket_trace.py and uprobe_trace.py")
        self.device = check_device(device)
        self.cfg = cfg
        self.vtap_id = 0
        self.flow_map = FlowMap(device=self.device)
        self.policy = PolicyLabeler()
        from deepflow_tpu_torch.agent.dispatcher import (Dispatcher,
                                                         DispatcherConfig)
        self.enforcer = PolicyEnforcer(self.policy, npb_addr=cfg.npb_addr,
                                       pcap_dir=cfg.pcap_policy_dir,
                                       npb_tunnel=cfg.npb_tunnel)
        self.dispatcher = Dispatcher(
            DispatcherConfig(mode=cfg.dispatcher_mode,
                             local_macs=set(cfg.local_macs)),
            policy=self.policy, enforcer=self.enforcer)
        self.sessions = SessionAggregator()
        self.flow_aggr = None
        self._pending_aggr = None     # stash drained on interval change
        self.aggr_schema_errors = 0   # divergent hot-switch column sets
        self.last_aggr_schema_error = ""
        if cfg.l4_log_aggr_s:
            from deepflow_tpu_torch.agent.flow_aggr import FlowAggr
            self.flow_aggr = FlowAggr(cfg.l4_log_aggr_s)
        self.guard = Guard()
        self.escape = EscapeTimer(cfg.escape_after_s, self._on_escape)
        sender_types = [MessageType.TAGGEDFLOW, MessageType.METRICS,
                        MessageType.PROTOCOLLOG, MessageType.COLUMNAR_FLOW,
                        MessageType.PROC_EVENT]
        self.pseq = None
        self._pseq_pending: List[bytes] = []
        if cfg.packet_sequence:
            from deepflow_tpu_torch.agent.packet_sequence import \
                PacketSequenceCollector
            self.pseq = PacketSequenceCollector()
            self.flow_map.want_packet_context = True
            sender_types.append(MessageType.PACKETSEQUENCE)
        self.profiles_sent = 0
        self.profile_errors = 0
        self.gpid_map: Dict[int, int] = {}
        self.upgrades_applied = 0
        self.upgrade_errors = 0
        self.sync_errors = 0
        self.plugin_fetch_errors = 0
        self.staged_package: Optional[str] = None
        # real deployments exec the staged binary here; None = revision
        # swap in place (process and firehose sockets stay up)
        self.on_upgrade = None
        self.senders: Dict[MessageType, UniformSender] = {
            mt: UniformSender(mt, cfg.ingester_addr)
            for mt in sender_types
        }
        self._stop = threading.Event()
        self._threads: list = []   # supervisor ThreadHandles
        self._lock = threading.Lock()
        self._l7_out: List[bytes] = []
        self.escaped = False
        self.config_version = 0
        self.platform_watcher = None
        self.k8s_watcher = None
        self.ntp_offset_ns = 0
        self._capture_source = None   # set via attach_source()
        self._l7_rate_sec = -1        # L7 rate-cap window (epoch second)
        self._l7_rate_used = 0
        self.l7_throttled = 0
        # one Countable registry for the DFSTATS self-telemetry loop
        # (reference: utils/stats.rs -- the agent monitors itself with
        # the same pipeline it feeds)
        from deepflow_tpu_torch.runtime.stats import StatsRegistry

        self.stats = StatsRegistry()
        self.stats.register("agent.flow_map", self.flow_map.counters)
        # closure, not a bound method: the aggregator hot-swaps when a
        # pushed config changes l4_log_aggr_s
        self.stats.register(
            "agent.flow_aggr",
            lambda: (self.flow_aggr.counters() if self.flow_aggr
                     is not None else {"rows_in": 0, "rows_out": 0,
                                       "stashed": 0, "enabled": 0}))
        self.stats.register("agent.dispatcher", self.dispatcher.counters)
        self.stats.register("agent.enforcer", self.enforcer.counters)
        self.stats.register("agent.guard", self.guard.counters)
        if self.pseq is not None:
            self.stats.register("agent.packet_sequence",
                                self.pseq.counters)
        self.stats_shipper = None

    def attach_source(self, source) -> None:
        """Declare the live capture source feeding this agent (the
        CaptureLoop's source)."""
        self._capture_source = source

    def set_vtap_id(self, vtap_id: int) -> None:
        """Fan the assigned id out to every component that stamps it:
        flow rows, and each sender's wire FlowHeader."""
        self.vtap_id = vtap_id
        self.flow_map.vtap_id = vtap_id
        for s in self.senders.values():
            s.vtap_id = vtap_id
        if self.stats_shipper is not None:
            self.stats_shipper.sender.vtap_id = vtap_id

    # -- control plane -----------------------------------------------------
    def sync_once(self) -> bool:
        """One controller round trip (reference: Synchronizer.Sync)."""
        if self.cfg.controller_url is None:
            return True
        body = json.dumps({"ctrl_ip": self.cfg.ctrl_ip,
                           "host": self.cfg.host,
                           "revision": self.cfg.revision,
                           "boot": self.vtap_id == 0,
                           # GPIDSync leg: processes this agent observes;
                           # the controller returns globally-unique
                           # gprocess ids
                           "processes": self._local_processes()}).encode()
        req = urllib.request.Request(
            f"{self.cfg.controller_url}/v1/sync", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.time_ns()
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                r = json.load(resp)
        except Exception:
            return False
        t1 = time.time_ns()
        if "server_time_ns" in r:
            # classic NTP midpoint estimate: offset = server - local at
            # the round-trip middle (reference: rpc/ntp.rs). Tracked and
            # surfaced, NOT applied to packet timestamps -- a step-change
            # mid-window would corrupt flow durations.
            self.ntp_offset_ns = int(r["server_time_ns"]) - (t0 + t1) // 2
        self.set_vtap_id(r["vtap_id"])
        if r.get("ingester"):
            for s in self.senders.values():
                s.set_target(r["ingester"])
            if self.stats_shipper is not None:
                # self-telemetry follows the reassignment too
                self.stats_shipper.sender.set_target(r["ingester"])
        if r["config_version"] != self.config_version:
            self._apply_config(r["config"])
            self.config_version = r["config_version"]
        if r.get("gpids"):
            self.gpid_map = {int(k): int(v)
                             for k, v in r["gpids"].items()}
        if r.get("upgrade"):
            self._apply_upgrade(r["upgrade"])
        self.escape.on_sync_ok()
        self.escaped = False
        return True

    def _local_processes(self) -> list:
        """Processes this agent reports for GPIDSync: itself (the eBPF
        tracer that would add the pids it sees is not ported)."""
        return [{"pid": os.getpid(), "name": "deepflow-agent",
                 "start_time": self._self_start_time()}]

    @staticmethod
    def _self_start_time() -> int:
        try:
            with open("/proc/self/stat") as f:
                # field 22 (starttime, clock ticks since boot); fields
                # after the parenthesized comm, which may contain spaces
                return int(f.read().rsplit(")", 1)[1].split()[19])
        except (OSError, IndexError, ValueError):
            return 0

    def _apply_upgrade(self, upg: dict) -> None:
        """Staged agent upgrade (reference: rpc Upgrade + the agent's
        upgrade task): fetch the package from the controller, verify
        the checksum, stage it to disk, flush in-flight data, then
        restart into the new revision. Here "restart" = the on_upgrade
        callback (a real deployment execs the staged binary there); the
        default keeps the process and its sender sockets alive, so the
        firehose never drops a tick."""
        import base64
        import hashlib
        if upg.get("revision") == self.cfg.revision:
            return
        try:
            url = (f"{self.cfg.controller_url}/v1/upgrade-package?name="
                   + urllib.parse.quote(upg["package"]))
            with urllib.request.urlopen(url, timeout=30) as resp:
                doc = json.load(resp)
            data = base64.b64decode(doc["data_b64"])
        except Exception:
            self.upgrade_errors += 1
            return
        digest = hashlib.sha256(data).hexdigest()
        if digest != upg.get("sha256"):
            # corrupt/tampered package: refuse, stay on the old revision
            self.upgrade_errors += 1
            return
        staged = os.path.join(self.cfg.upgrade_dir or "/tmp",
                              f"deepflow-agent-{upg['revision']}")
        try:
            with open(staged + ".tmp", "wb") as f:
                f.write(data)
            os.replace(staged + ".tmp", staged)
        except OSError:
            self.upgrade_errors += 1
            return
        self.tick()                      # flush before the restart
        if self.on_upgrade is not None:
            # the restart hook runs BEFORE the revision flips: if it
            # fails, the agent keeps reporting the old revision so the
            # controller keeps retrying instead of recording a converged
            # agent that never restarted. The except also keeps the
            # synchronizer thread alive.
            try:
                self.on_upgrade(staged, upg["revision"])
            except Exception:
                self.upgrade_errors += 1
                return
        self.cfg.revision = upg["revision"]
        self.upgrades_applied += 1
        self.staged_package = staged

    def _apply_config(self, cfg: dict) -> None:
        """Hot-apply pushed RuntimeConfig (reference: ConfigHandler)."""
        # a pushed plugin list this package cannot load fails the round
        # before anything is applied (the synchronizer counts it in
        # sync_errors); absent, None or [] leaves nothing to load
        if cfg.get("so_plugins"):
            raise not_ported("pushed so_plugins", "plugin.py")
        if cfg.get("wasm_plugins"):
            raise not_ported("pushed wasm_plugins", "wasm_plugin.py")
        self.guard.set_limits(cfg.get("max_memory_mb", 768),
                              cfg.get("max_cpus", 1))
        self.cfg.l7_enabled = bool(cfg.get("l7_log_enabled", True))
        self.cfg.sync_interval_s = cfg.get("sync_interval_s", 60)
        if "l7_log_rate" in cfg:
            self.cfg.l7_log_rate = int(cfg["l7_log_rate"] or 0)
        # flow-log aggregation interval is hot-switchable; turning it
        # OFF flushes the stash so no merged rows strand. Under the
        # agent lock: tick() (flow-tick thread) reads/advances the
        # same aggregator.
        if "l4_log_aggr_s" in cfg:
            want = int(cfg["l4_log_aggr_s"] or 0)
            with self._lock:
                have = (self.flow_aggr.interval_s
                        if self.flow_aggr is not None else 0)
                if want != have:
                    if self.flow_aggr is not None:
                        out = self.flow_aggr.flush()
                        if out is not None:
                            # stash drains through the NEXT tick; a
                            # second switch before that tick must
                            # APPEND, not clobber
                            if self._pending_aggr is not None:
                                if self._aggr_sets_match(
                                        self._pending_aggr, out):
                                    out = {k: np.concatenate(
                                        [self._pending_aggr[k], out[k]])
                                        for k in out}
                                # diverged: keep only the fresh flush --
                                # counted in aggr_schema_errors, never
                                # silently intersected
                            self._pending_aggr = out
                    if want:
                        from deepflow_tpu_torch.agent.flow_aggr import \
                            FlowAggr
                        self.flow_aggr = FlowAggr(want)
                    else:
                        self.flow_aggr = None
                    self.cfg.l4_log_aggr_s = want
        # trace-context header extraction config (reference proxy config
        # http_log_trace_id / http_log_span_id / ...): hot-swapped into
        # the process-global parser registry's extraction config.
        if any(k in cfg for k in ("http_log_trace_id", "http_log_span_id",
                                  "http_log_x_request_id",
                                  "http_log_proxy_client")):
            from deepflow_tpu_torch.agent import trace_context
            trace_context.configure(
                trace_types=cfg.get("http_log_trace_id"),
                span_types=cfg.get("http_log_span_id"),
                x_request_id=cfg.get("http_log_x_request_id"),
                proxy_client=cfg.get("http_log_proxy_client"))
        # pushed policy (reference: FlowAcl push -> policy compile):
        # absent/None = unmanaged; a LIST is authoritative (pushing []
        # must clear the rule set). Versioned like the reference's
        # version_acls so an unchanged push is a no-op.
        if cfg.get("flow_acls") is not None:
            from deepflow_tpu_torch.agent.policy import rules_from_flow_acls
            self.policy.update(rules_from_flow_acls(cfg["flow_acls"]),
                               int(cfg.get("acl_version", 0) or 0)
                               or self.policy.version + 1)

    def _on_escape(self) -> None:
        """Controller silent too long: fall back to conservative defaults
        (reference: escape timer -> safe RuntimeConfig)."""
        self.escaped = True
        self.cfg.l7_enabled = False

    # -- data plane --------------------------------------------------------
    def feed(self, frames: List[bytes],
             timestamps_ns: Optional[np.ndarray] = None) -> int:
        """Ingest one capture batch; returns valid packets."""
        pkt = self.dispatcher.dispatch(frames, timestamps_ns)
        with self._lock:
            # collector state is shared with the tick thread's flush:
            # both run under the same lock (the _l7_out pattern)
            ctx = self.flow_map.inject(pkt)
            if self.pseq is not None and ctx is not None:
                self._collect_pseq(ctx)
        if self.cfg.l7_enabled:
            self._parse_l7(frames, pkt)
        return int(pkt["valid"].sum())

    def _collect_pseq(self, ctx: dict) -> None:
        """Per-packet TCP headers into the sequence collector; `ctx` is
        flow_map.inject's per-valid-packet context (cols/flow_id/
        initiator-relative direction -- one masking+orientation pass,
        owned by the flow map). Caller holds self._lock."""
        cols = ctx["cols"]
        tcp = np.nonzero(cols["proto"] == PROTO_TCP)[0]
        if not len(tcp):
            return
        zeros = np.zeros(len(cols["proto"]), np.uint32)
        blocks = self.pseq.observe(
            ctx["flow_id"][tcp], cols["timestamp_ns"][tcp],
            cols["tcp_seq"][tcp], cols.get("tcp_ack", zeros)[tcp],
            cols["tcp_flags"][tcp], cols.get("tcp_win", zeros)[tcp],
            cols["payload_len"][tcp], ctx["direction"][tcp])
        if blocks:
            self._pseq_pending.extend(blocks)

    def _parse_l7(self, frames: List[bytes],
                  pkt: Dict[str, np.ndarray]) -> None:
        candidates = np.nonzero(
            pkt["valid"] & (pkt["payload_len"] > 0)
            & ((pkt["proto"] == PROTO_TCP) | (pkt["proto"] == PROTO_UDP))
        )[0]
        for i in candidates:
            payload = frames[i][int(pkt["payload_off"][i]):]
            rec = parse_payload(payload, proto=int(pkt["proto"][i]),
                                port_src=int(pkt["port_src"][i]),
                                port_dst=int(pkt["port_dst"][i]),
                                ts_ns=int(pkt["timestamp_ns"][i]),
                                ip_src=int(pkt["ip_src"][i]),
                                ip_dst=int(pkt["ip_dst"][i]),
                                ip_version=int(pkt["ip_version"][i]))
            if rec is None:
                continue
            # session key is direction-agnostic
            key = tuple(sorted([(int(pkt["ip_src"][i]),
                                 int(pkt["port_src"][i])),
                                (int(pkt["ip_dst"][i]),
                                 int(pkt["port_dst"][i]))]))
            # the merged record is emitted on the RESPONSE packet, whose
            # src is the server -- orient the log client->server
            if rec.msg_type == MSG_REQUEST:
                flow = (pkt["ip_src"][i], pkt["ip_dst"][i],
                        pkt["port_src"][i], pkt["port_dst"][i],
                        pkt["proto"][i])
            else:
                flow = (pkt["ip_dst"][i], pkt["ip_src"][i],
                        pkt["port_dst"][i], pkt["port_src"][i],
                        pkt["proto"][i])
            merged = self.sessions.offer((key, int(pkt["proto"][i])), rec,
                                         int(pkt["timestamp_ns"][i]))
            if merged is not None:
                with self._lock:
                    # agent-side L7 rate cap (reference: the LeakyBucket
                    # throttle on PROTOCOLLOG sends,
                    # l7_log_collect_nps_threshold): sessions past this
                    # second's budget drop HERE, before serialization,
                    # and the drop is a Countable
                    sec = int(pkt["timestamp_ns"][i]) // 1_000_000_000
                    # monotonic window roll: an out-of-order EARLIER
                    # stamp must count against the current budget, not
                    # reset it
                    if sec > self._l7_rate_sec:
                        self._l7_rate_sec = sec
                        self._l7_rate_used = 0
                    if self.cfg.l7_log_rate and \
                            self._l7_rate_used >= self.cfg.l7_log_rate:
                        self.l7_throttled += 1
                        continue
                    self._l7_rate_used += 1
                    self._l7_out.append(_l7_record_bytes(
                        flow, merged, int(pkt["timestamp_ns"][i]),
                        self.vtap_id))

    def enable_tls_uprobes(self, paths: Optional[List[str]] = None,
                           pids: Optional[List[int]] = None) -> dict:
        """Live encrypted-traffic capture: not ported."""
        raise not_ported("enable_tls_uprobes",
                         "ebpf_source.py and uprobe_trace.py")

    def tick(self, now_ns: Optional[int] = None,
             final: bool = False) -> dict:
        """1s flush: flows -> COLUMNAR_FLOW or TAGGEDFLOW, documents ->
        METRICS, sessions -> PROTOCOLLOG. `final` force-flushes the
        packet-sequence collector (shutdown: blocks younger than the
        5s budget must not be dropped)."""
        now_ns = int(time.time() * 1e9) if now_ns is None else now_ns
        pseq_blocks: List[bytes] = []
        with self._lock:
            # vectorized tick: oriented wire-ready columns, no per-flow
            # Python (flow_map.tick_columns)
            cols = self.flow_map.tick_columns(now_ns)
            cols["vtap_id"][:] = self.vtap_id
            l7_records, self._l7_out = self._l7_out, []
            if self.pseq is not None:
                pseq_blocks = self._pseq_pending \
                    + self.pseq.flush(now_ns, force=final)
                self._pseq_pending = []
        sent = {"flows": 0, "documents": 0, "l7": 0}
        # flow-log fork: optionally aggregated to l4_log_aggr_s buckets
        # (flow_aggr.rs); the metrics fork below always sees the 1s
        # cols. Under the agent lock: _apply_config (synchronizer
        # thread) flushes/swaps the aggregator on hot-switch.
        flow_cols = cols
        with self._lock:
            if self.flow_aggr is not None:
                agg = self.flow_aggr.add(cols, now_ns)
                if final:
                    fin = self.flow_aggr.flush()
                    if fin is not None:
                        agg = fin if agg is None else {
                            k: np.concatenate([agg[k], fin[k]])
                            for k in agg}
                flow_cols = agg
            if self._pending_aggr is not None:
                # rows flushed by an interval hot-switch ride this tick
                pend, self._pending_aggr = self._pending_aggr, None
                if flow_cols is None or not len(
                        flow_cols.get("ip_src", ())):
                    flow_cols = pend
                elif self._aggr_sets_match(pend, flow_cols):
                    flow_cols = {
                        k: np.concatenate([flow_cols[k], pend[k]])
                        for k in pend}
                # else: column sets diverged; the stale pending rows are
                # DROPPED -- visibly, via aggr_schema_errors
        if flow_cols is not None and len(flow_cols["ip_src"]):
            if self.cfg.wire_mode == "columnar":
                sent["flows"] = self.senders[
                    MessageType.COLUMNAR_FLOW].send_columns(
                        columns_to_l4_schema(flow_cols), L4_SCHEMA)
            else:
                records = columns_to_l4_records(flow_cols)
                sent["flows"] = self.senders[
                    MessageType.TAGGEDFLOW].send(records)
        if len(cols["ip_src"]):
            docs = flows_to_documents(cols, now_ns // 1_000_000_000,
                                      device=self.device)
            doc_records = documents_to_records(docs)
            sent["documents"] = self.senders[MessageType.METRICS].send(
                doc_records)
        if l7_records:
            sent["l7"] = self.senders[MessageType.PROTOCOLLOG].send(
                l7_records)
        if pseq_blocks:
            # packet-sequence blocks are self-delimited by their
            # leading u32 block_size, so frames carry blocks
            # concatenated RAW -- no per-record varint prefixes
            sent["packet_blocks"] = self.senders[
                MessageType.PACKETSEQUENCE].send_raw_batch(pseq_blocks)
        self.sessions.expire(now_ns)
        return sent

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.guard.start()
        if self.cfg.self_telemetry and self.cfg.ingester_addr:
            from deepflow_tpu_torch.runtime.stats import StatsShipper
            self.stats_shipper = StatsShipper(
                self.stats, self.cfg.ingester_addr, vtap_id=self.vtap_id)
            self.stats.start(interval_s=10.0)
        # worker threads ride the supervision tree: crash capture +
        # backoff restart instead of a silently dead synchronizer/ticker
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        if self.cfg.controller_url is not None:
            self._threads.append(sup.spawn(
                "synchronizer", self._sync_loop,
                beat_period_s=self.cfg.sync_interval_s))
            # platform sync: interface report on change + optional k8s
            # cluster watch (agent/platform.py -- api_watcher analogue)
            from deepflow_tpu_torch.agent.platform import (
                file_lister, interface_reporter, k8s_watcher, libvirt_lister,
                local_interfaces)
            lister = None
            if self.cfg.libvirt_xml_dir:
                # KVM host: guest NICs from the domain XML definitions
                # ride the same genesis report as the host's own NICs
                lv = libvirt_lister(self.cfg.libvirt_xml_dir)
                lister = (lambda: local_interfaces() + lv())
            self.platform_watcher = interface_reporter(
                self.cfg.controller_url, self.cfg.host, self.cfg.ctrl_ip,
                lister=lister,
                interval_s=self.cfg.platform_sync_interval_s)
            self.platform_watcher.start()
            if self.cfg.k8s_resource_file:
                self.k8s_watcher = k8s_watcher(
                    self.cfg.controller_url,
                    self.cfg.k8s_cluster_domain,
                    file_lister(self.cfg.k8s_resource_file),
                    interval_s=self.cfg.platform_sync_interval_s)
                self.k8s_watcher.start()
        self._threads.append(sup.spawn("flow-tick", self._tick_loop))

    def close(self) -> None:
        self._stop.set()
        for w in (self.platform_watcher, self.k8s_watcher):
            if w is not None:
                w.close()
        for t in self._threads:
            t.stop()           # cancel any in-progress restart backoff
        for t in self._threads:
            t.join(timeout=2)
        self.tick(final=True)  # final flush incl. young pseq blocks
        if self.stats_shipper is not None:
            # final scrape: an agent shorter-lived than the 10s cadence
            # (or counters updated since the last tick) must still land
            self.stats.collect()
            self.stats_shipper.close()   # removes sink, flushes, closes
        self.stats.stop()
        self.enforcer.close()
        self.guard.close()
        for s in self.senders.values():
            s.close()

    def _sync_loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while True:
            sup.beat()
            # the synchronizer thread must survive any single round's
            # exception (a bad pushed config, an upgrade hook error):
            # a dead sync loop means no config pushes, no escape
            # checks, and no recovery -- forever
            try:
                self.sync_once()
                self.escape.check()
            except Exception:
                self.sync_errors += 1
            if self._stop.wait(self.cfg.sync_interval_s):
                return

    def _tick_loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._stop.wait(1.0):
            sup.beat()
            self.tick()

    def _aggr_sets_match(self, a: dict, b: dict) -> bool:
        """True when two aggregated-column dicts share an identical key
        set; on divergence, records it (visible in counters)."""
        if set(a) == set(b):
            return True
        self.aggr_schema_errors += 1
        self.last_aggr_schema_error = (
            f"only_a={sorted(set(a) - set(b))} "
            f"only_b={sorted(set(b) - set(a))}")
        return False

    def counters(self) -> dict:
        c = self.flow_map.counters()
        c["escaped"] = int(self.escaped)
        c["aggr_schema_errors"] = self.aggr_schema_errors
        c["profiles_sent"] = self.profiles_sent
        c["profile_errors"] = self.profile_errors
        c["upgrades_applied"] = self.upgrades_applied
        c["upgrade_errors"] = self.upgrade_errors
        c["ntp_offset_ns"] = self.ntp_offset_ns
        c["sessions_merged"] = self.sessions.merged
        c["l7_throttled"] = self.l7_throttled
        for mt, s in self.senders.items():
            c[f"sent_{mt.name.lower()}"] = s.sent_records
        return c
