"""trident.Synchronizer gRPC service: the reference-agent control plane.

Reference: message/trident.proto Synchronizer service +
server/controller/trisolaris/services/grpc/synchronize/ — the gRPC
surface an UNMODIFIED reference agent speaks. The JSON/HTTP control
plane (controller/server.py) remains the native surface; this bridge
serves the same VTapRegistry state over the reference's wire so a
reference agent can register, receive pushed config, learn upgrade
targets, stream upgrade packages, resolve gpids, and NTP-sync:

- Sync: register-or-refresh via registry.sync (same allocation/groups/
  staged-upgrade bookkeeping as /v1/sync); RuntimeConfig mapped onto
  the Config fields the subset proto carries; an upgrade offer rides
  `revision` + `self_update_url` exactly like the reference triggers
  its Upgrade rpc.
- Upgrade: streams the targeted package in chunks with md5/total_len/
  pkt_count (trident.proto UpgradeResponse contract).
- GPIDSync: entry pids are replaced with controller-global gprocess
  ids (process_info.go role) keyed by the registry's persisted
  (vtap, pid) allocation.
- Query: a real 48-byte NTPv3 server answer (rpc/ntp.rs client side):
  originate := client transmit, receive/transmit := server clock.

grpcio carries HTTP/2; the service handlers are plain functions over
generated-from-our-subset-proto messages (wire/protos/trident.proto,
field-number compatible with the reference).

The port's own copy of the JAX package's `controller/trident_grpc.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import hashlib
import struct
import time
from concurrent import futures
from typing import Callable, Optional

from deepflow_tpu_torch.controller.registry import VTapRegistry
from deepflow_tpu_torch.wire.gen import trident_pb2 as pb

UPGRADE_CHUNK = 1 << 20

# seconds between the NTP epoch (1900) and the unix epoch (1970)
_NTP_UNIX_DELTA = 2208988800


def _ntp_ts(unix: float) -> int:
    sec = int(unix) + _NTP_UNIX_DELTA
    frac = int((unix % 1.0) * (1 << 32))
    return (sec << 32) | frac


def ntp_answer(request: bytes, now: Optional[float] = None) -> bytes:
    """48-byte NTPv3 mode-4 (server) answer to a client packet: LI=0,
    stratum 1, originate := client's transmit, recv/trans := now."""
    now = time.time() if now is None else now
    client_transmit = request[40:48] if len(request) >= 48 \
        else b"\0" * 8
    vn = (request[0] >> 3) & 0x7 if request else 3
    head = bytes([((vn & 0x7) << 3) | 4, 1, 0, 0])      # mode 4, stratum 1
    ts = _ntp_ts(now)
    return (head + b"\0" * 8                             # delay/dispersion
            + b"DFTP"                                    # reference id
            + struct.pack(">Q", ts)                      # reference ts
            + client_transmit                            # originate
            + struct.pack(">Q", ts)                      # receive
            + struct.pack(">Q", ts))                     # transmit


class SynchronizerService:
    """Handler set behind grpc.method_handlers_generic_handler."""

    def __init__(self, registry: VTapRegistry,
                 package_bytes: Callable[[str], Optional[bytes]],
                 platform_version: Callable[[], int] = lambda: 0,
                 genesis_report: Optional[Callable] = None,
                 assign: Optional[Callable] = None) -> None:
        self.registry = registry
        self.package_bytes = package_bytes
        self.platform_version = platform_version
        self.genesis_report = genesis_report
        self.assign = assign          # (ctrl_ip, host) -> "ip:port"
        self.syncs = 0
        self.upgrades_streamed = 0
        self.genesis_syncs = 0
        # reference agents stamp boot_time on EVERY periodic Sync; a
        # boot is when it CHANGES (process restarted), not when present
        self._boot_times: dict = {}
        import threading
        self._push_slots = threading.Semaphore(self.max_push_streams)

    # -- rpc Sync ----------------------------------------------------------
    def Sync(self, req: "pb.SyncRequest", ctx) -> "pb.SyncResponse":
        self.syncs += 1
        key = (req.ctrl_ip, req.host or req.ctrl_ip)
        boot = self._boot_times.get(key) != req.boot_time
        self._boot_times[key] = req.boot_time
        r = self.registry.sync(req.ctrl_ip, req.host or req.ctrl_ip,
                               revision=req.revision, boot=boot,
                               ctrl_mac=req.ctrl_mac)
        return self._sync_response(req, r)

    def _sync_response(self, req: "pb.SyncRequest",
                       r: dict) -> "pb.SyncResponse":
        cfg = r["config"]
        resp = pb.SyncResponse(
            status=pb.SUCCESS,
            version_platform_data=self.platform_version())
        c = resp.config
        c.vtap_id = r["vtap_id"]
        c.enabled = True
        c.max_cpus = int(cfg.get("max_cpus", 1))
        c.max_memory = int(cfg.get("max_memory_mb", 768))
        c.sync_interval = int(cfg.get("sync_interval_s", 60))
        c.stats_interval = int(cfg.get("stats_interval_s", 10))
        c.global_pps_threshold = int(cfg.get("max_collect_pps", 200000))
        c.max_escape_seconds = 3600
        c.capture_bpf = str(cfg.get("capture_bpf", ""))
        c.l4_log_tap_types.extend(
            int(t) for t in cfg.get("l4_log_tap_types", ()))
        # capture / resource-limit / l7 surface (round-5 Config
        # widening; reference trident.proto:185-289): only fields the
        # group config actually carries are set — proto2 defaults
        # cover the rest, so an unmodified reference agent sees its
        # own defaults for unmanaged knobs rather than zeros
        _scalar = (("tap_interface_regex", "tap_interface_regex", str),
                   ("extra_netns_regex", "extra_netns_regex", str),
                   ("mtu", "mtu", int),
                   ("output_vlan", "output_vlan", int),
                   ("npb_bps_threshold", "max_npb_bps", int),
                   ("capture_packet_size", "capture_packet_size", int),
                   ("l7_log_packet_size", "l7_log_packet_size", int),
                   ("log_threshold", "log_threshold", int),
                   ("log_level", "log_level", str),
                   ("thread_threshold", "thread_threshold", int),
                   ("process_threshold", "process_threshold", int),
                   ("log_retention", "log_retention_days", int),
                   ("ntp_enabled", "ntp_enabled", bool),
                   ("platform_enabled", "platform_enabled", bool),
                   ("kubernetes_api_enabled", "kubernetes_api_enabled",
                    bool),
                   ("l4_performance_enabled", "l4_performance_enabled",
                    bool),
                   ("l7_metrics_enabled", "l7_metrics_enabled", bool),
                   ("tap_mode", "tap_mode", int),
                   ("region_id", "region_id", int),
                   ("epc_id", "epc_id", int),
                   ("pod_cluster_id", "pod_cluster_id", int),
                   ("http_log_trace_id", "http_log_trace_id", None),
                   ("http_log_span_id", "http_log_span_id", None),
                   ("http_log_x_request_id", "http_log_x_request_id",
                    None),
                   ("http_log_proxy_client", "http_log_proxy_client",
                    None))
        for pb_field, cfg_key, cast in _scalar:
            v = cfg.get(cfg_key)
            if v is None:
                continue
            if cast is None:       # header lists ride comma-joined
                v = ", ".join(v) if isinstance(v, (list, tuple)) \
                    else str(v)
                setattr(c, pb_field, v)
            else:
                setattr(c, pb_field, cast(v))
        # the data-plane destination (JSON route's resp["ingester"]):
        # without analyzer_ip a managed agent has nowhere to ship
        if self.assign is not None:
            target = self.assign(req.ctrl_ip, req.host or req.ctrl_ip)
            if target:
                ip, _, port = str(target).rpartition(":")
                c.analyzer_ip = ip or str(target)
                if port.isascii() and port.isdigit():
                    c.analyzer_port = int(port)  # parse_int's form
        # policy push (round-5: reference SyncResponse.flow_acls — a
        # serialized FlowAcls blob + version; the reference agent
        # re-compiles its labeler only when version_acls moves).
        # `is not None`: an EMPTY list is authoritative and must ship
        # (as a present-but-empty blob with a bumped version) so
        # agents actually CLEAR their rules — `if acls:` would leave a
        # fleet dropping traffic forever after a policy disable
        acls = cfg.get("flow_acls")
        if acls is not None:
            resp.version_acls = int(cfg.get("acl_version", 1) or 1)
            fa = pb.FlowAcls()
            for a in acls:
                f = fa.flow_acl.add()
                f.id = int(a.get("id", 0))
                f.tap_type = int(a.get("tap_type", 0))
                f.protocol = int(a.get("protocol", 256))
                f.src_ports = str(a.get("src_ports", "") or "")
                f.dst_ports = str(a.get("dst_ports", "") or "")
                for act in a.get("npb_actions") or ():
                    na = f.npb_actions.add()
                    na.tunnel_type = int(act.get("tunnel_type", 0))
                    na.tunnel_id = int(act.get("tunnel_id", 0))
                    na.tunnel_ip = str(act.get("tunnel_ip", "") or "")
                    na.payload_slice = int(
                        act.get("payload_slice", 65535))
            resp.flow_acls = fa.SerializeToString()
        upg = r.get("upgrade")
        if upg:
            resp.revision = upg["revision"]
            resp.self_update_url = "grpc"      # fetch via rpc Upgrade
        return resp

    # -- rpc Push (server-stream Sync) -------------------------------------
    push_poll_s = 5.0
    # a Push generator parks one executor thread for the connection's
    # lifetime; the cap keeps unary rpcs (Sync/Upgrade/NTP) schedulable
    # when many agents hold push channels — an over-cap agent gets one
    # snapshot and falls back to Sync polling
    max_push_streams = 24

    def Push(self, req: "pb.SyncRequest", ctx):
        """The reference's push channel: one response immediately, then
        a new one whenever the group config / platform version / an
        upgrade offer moves, until the agent disconnects. Each round
        refreshes the vtap's liveness; restarts are detected from
        boot_time changes exactly like Sync. Upgrade attempt budget
        accrues per TIME (registry.upgrade_attempt_interval_s), so the
        5s poll burns it no faster than the 60s Sync cadence — and a
        wedged push-mode agent still quarantines."""
        key = (req.ctrl_ip, req.host or req.ctrl_ip)
        boot = self._boot_times.get(key) != req.boot_time
        self._boot_times[key] = req.boot_time
        over_cap = not self._push_slots.acquire(blocking=False)
        last = None
        try:
            while ctx.is_active():
                self.syncs += 1
                r = self.registry.sync(req.ctrl_ip,
                                       req.host or req.ctrl_ip,
                                       revision=req.revision, boot=boot,
                                       ctrl_mac=req.ctrl_mac)
                boot = False
                upg = r.get("upgrade")
                # the offered REVISION is part of the change state: a
                # re-target while an offer stands must push anew
                state = (r["config_version"], self.platform_version(),
                         upg["revision"] if upg else None)
                if state != last:
                    last = state
                    yield self._sync_response(req, r)
                if over_cap:
                    return                    # snapshot-only fallback
                # responsive to cancellation: short sleeps, not one long
                waited = 0.0
                while waited < self.push_poll_s and ctx.is_active():
                    step = min(0.25, self.push_poll_s - waited)
                    time.sleep(step)
                    waited += step
        finally:
            if not over_cap:
                self._push_slots.release()

    # -- rpc GetKubernetesClusterID ----------------------------------------
    def GetKubernetesClusterID(self, req: "pb.KubernetesClusterIDRequest",
                               ctx) -> "pb.KubernetesClusterIDResponse":
        """Stable cluster-id allocation keyed by the cluster CA's md5
        (trisolaris kubernetes_cluster service role): every agent in
        one cluster gets the same id."""
        if not req.ca_md5:
            return pb.KubernetesClusterIDResponse(
                error_msg="ca_md5 required")
        cid = self.registry.cluster_id_for(
            req.ca_md5, req.kubernetes_cluster_name)
        return pb.KubernetesClusterIDResponse(cluster_id=cid)

    # -- rpc Query (NTP) ---------------------------------------------------
    def Query(self, req: "pb.NtpRequest", ctx) -> "pb.NtpResponse":
        return pb.NtpResponse(response=ntp_answer(req.request))

    # -- rpc Upgrade (server-stream) ---------------------------------------
    def Upgrade(self, req: "pb.UpgradeRequest", ctx):
        # UpgradeRequest carries only ctrl_ip+ctrl_mac (reference
        # trident.proto:579) while the registry keys vtaps by
        # (ctrl_ip, host): disambiguate shared ctrl_ips by the mac the
        # vtap reported at Sync, falling back to ctrl_ip-only for
        # agents that never sent one
        cands = [v for v in self.registry.list()
                 if v.ctrl_ip == req.ctrl_ip]
        if req.ctrl_mac:
            # exact mac match first; else a candidate that never
            # reported a mac (pre-mac registration) may be it. A
            # mac-bearing request matching NO candidate while all
            # candidates carry different recorded macs must FAIL, not
            # serve an arbitrary host's package
            vt = (next((v for v in cands
                        if v.ctrl_mac == req.ctrl_mac), None)
                  or next((v for v in cands if not v.ctrl_mac), None))
        else:
            vt = cands[0] if cands else None
        tgt = self.registry.upgrade_target(vt.group) if vt else None
        data = self.package_bytes(tgt["package"]) if tgt else None
        if data is None:
            yield pb.UpgradeResponse(status=pb.FAILED)
            return
        self.upgrades_streamed += 1
        md5 = hashlib.md5(data).hexdigest()
        total = len(data)
        count = (total + UPGRADE_CHUNK - 1) // UPGRADE_CHUNK or 1
        for off in range(0, total or 1, UPGRADE_CHUNK):
            yield pb.UpgradeResponse(
                status=pb.SUCCESS, content=data[off:off + UPGRADE_CHUNK],
                md5=md5, total_len=total, pkt_count=count)

    # -- rpc GenesisSync ---------------------------------------------------
    def GenesisSync(self, req: "pb.GenesisSyncRequest",
                    ctx) -> "pb.GenesisSyncResponse":
        """Platform report leg: InterfaceInfo entries map onto the same
        genesis ingestion the JSON route uses — "ip/masklen" strings
        become host rows, mac-only entries vinterface rows (device_name
        as the owning domain)."""
        if self.genesis_report is None:
            return pb.GenesisSyncResponse(version=0)
        self.genesis_syncs += 1
        host = req.platform_data.raw_hostname or req.source_ip
        rows = []
        for itf in req.platform_data.interfaces:
            mac = itf.mac
            mac_str = ":".join(f"{(mac >> s) & 0xFF:02x}"
                               for s in range(40, -8, -8)) if mac else ""
            # EVERY address gets a row (genesis_report keys host rows
            # by host|ip, so one interface may emit several); invalid
            # entries are dropped by genesis_report's own validation
            for addr in itf.ip:
                rows.append({"name": itf.name,
                             "ip": addr.split("/")[0]})
            if mac_str and itf.device_name:
                rows.append({"name": itf.name, "mac": mac_str,
                             "domain_name": itf.device_name,
                             "domain_uuid": itf.device_id})
        self.genesis_report(host, rows)
        return pb.GenesisSyncResponse(version=self.platform_version())

    # -- rpc GPIDSync ------------------------------------------------------
    def GPIDSync(self, req: "pb.GPIDSyncRequest",
                 ctx) -> "pb.GPIDSyncResponse":
        gpids = self.registry.gpid_batch(
            req.vtap_id,
            [p for e in req.entries for p in (e.pid_0, e.pid_1)])
        resp = pb.GPIDSyncResponse()
        for e in req.entries:
            out = resp.entries.add()
            out.CopyFrom(e)
            out.pid_0 = gpids[e.pid_0]
            out.pid_1 = gpids[e.pid_1]
        return resp


def serve(registry: VTapRegistry,
          package_bytes: Callable[[str], Optional[bytes]],
          platform_version: Callable[[], int] = lambda: 0,
          genesis_report: Optional[Callable] = None,
          assign: Optional[Callable] = None,
          host: str = "127.0.0.1", port: int = 30035):
    """Start the gRPC server; returns (server, bound_port, service).
    Port 30035 is the reference's proxy_controller_port default."""
    import grpc

    svc = SynchronizerService(registry, package_bytes, platform_version,
                              genesis_report=genesis_report,
                              assign=assign)
    # worker pool sized above the push-stream cap so unary rpcs always
    # find a schedulable thread even at full push occupancy
    max_workers = svc.max_push_streams + 8
    handlers = {
        "Sync": grpc.unary_unary_rpc_method_handler(
            svc.Sync,
            request_deserializer=pb.SyncRequest.FromString,
            response_serializer=pb.SyncResponse.SerializeToString),
        "Query": grpc.unary_unary_rpc_method_handler(
            svc.Query,
            request_deserializer=pb.NtpRequest.FromString,
            response_serializer=pb.NtpResponse.SerializeToString),
        "Upgrade": grpc.unary_stream_rpc_method_handler(
            svc.Upgrade,
            request_deserializer=pb.UpgradeRequest.FromString,
            response_serializer=pb.UpgradeResponse.SerializeToString),
        "GPIDSync": grpc.unary_unary_rpc_method_handler(
            svc.GPIDSync,
            request_deserializer=pb.GPIDSyncRequest.FromString,
            response_serializer=pb.GPIDSyncResponse.SerializeToString),
        "GenesisSync": grpc.unary_unary_rpc_method_handler(
            svc.GenesisSync,
            request_deserializer=pb.GenesisSyncRequest.FromString,
            response_serializer=pb.GenesisSyncResponse.SerializeToString),
        "Push": grpc.unary_stream_rpc_method_handler(
            svc.Push,
            request_deserializer=pb.SyncRequest.FromString,
            response_serializer=pb.SyncResponse.SerializeToString),
        "GetKubernetesClusterID": grpc.unary_unary_rpc_method_handler(
            svc.GetKubernetesClusterID,
            request_deserializer=pb.KubernetesClusterIDRequest.FromString,
            response_serializer=(
                pb.KubernetesClusterIDResponse.SerializeToString)),
    }
    server = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max_workers))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("trident.Synchronizer",
                                             handlers),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound, svc
