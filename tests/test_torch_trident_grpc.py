"""The port's trident gRPC bridge (deepflow_tpu_torch/controller/
trident_grpc.py, wire/gen/trident_pb2.py) against the JAX package's, on
the CPU, over real gRPC (grpcio drives the client side).

Both packages serve the same registry story, each with its own
trident_pb2, and every response is compared byte for byte: Sync for a
fleet (boots, a group config with the widened knobs and a flow ACL
push, analyzer assignment), NTP Query under one frozen clock, the
Upgrade stream of a package larger than one chunk and its refusal,
GPIDSync, GenesisSync into a ControllerServer's genesis ingestion,
GetKubernetesClusterID, and the first message of a Push stream. Also:
the two trident_pb2 modules are the same file and describe the same
messages, ntp_answer agrees on short and full requests, and the JAX
package's tests/test_trident_grpc.py bodies run against the port."""

import hashlib
import importlib
import inspect
import struct
from pathlib import Path

import pytest

import torch_ctl_pair as cp

grpc = pytest.importorskip("grpc")

REPO = cp.TESTS.parent


def test_trident_pb2_is_the_reference_file():
    a = REPO / "deepflow_tpu/wire/gen/trident_pb2.py"
    b = REPO / "deepflow_tpu_torch/wire/gen/trident_pb2.py"
    assert a.read_bytes() == b.read_bytes()
    pa = REPO / "deepflow_tpu/wire/protos/trident.proto"
    pb_ = REPO / "deepflow_tpu_torch/wire/protos/trident.proto"
    assert pa.read_bytes() == pb_.read_bytes()
    ja = importlib.import_module("deepflow_tpu.wire.gen.trident_pb2")
    ta = importlib.import_module("deepflow_tpu_torch.wire.gen.trident_pb2")
    assert ta.DESCRIPTOR.serialized_pb == ja.DESCRIPTOR.serialized_pb


@pytest.mark.parametrize("request_bytes", [
    b"", b"\x1b" + bytes(47),
    bytes([0x1b]) + bytes(39) + struct.pack(">Q", 0x1122334455667788),
    bytes(range(64))])
def test_ntp_answer_matches_jax(request_bytes):
    out = [m.trident_grpc.ntp_answer(request_bytes, now=1_700_000_123.25)
           for m in cp.both()]
    assert out[0] == out[1] and len(out[1]) == 48


def _bridge_run(m, tmp, monkeypatch):
    # the NTP answer reads a frozen clock (grpc's deadlines need the real
    # one, so only the bridge module's view of time is frozen)
    import time as real_time
    frozen = type(real_time)("time")
    frozen.__dict__.update(vars(real_time))
    frozen.time = lambda: 1_700_000_000.5
    monkeypatch.setattr(m.trident_grpc, "time", frozen)
    pb = importlib.import_module(f"{m.pkg}.wire.gen.trident_pb2")
    root = Path(tmp) / m.pkg
    root.mkdir()
    model = m.model.ResourceModel()
    reg = m.registry.VTapRegistry(str(root / "vtaps.json"))
    mon = m.monitor.FleetMonitor(reg)
    mon.set_ingesters(["10.20.0.1:30033", "10.20.0.2:30033"])
    ctl = m.server.ControllerServer(model, reg, mon, port=0)
    packages = {"pkg.bin": bytes(range(256)) * 9000}
    server, port, svc = m.trident_grpc.serve(
        reg, packages.get, platform_version=lambda: model.version,
        genesis_report=ctl.genesis_report, assign=mon.assign, port=0)
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")

    def call(method, req, resp_cls):
        return chan.unary_unary(
            f"/trident.Synchronizer/{method}",
            request_serializer=lambda x: x.SerializeToString(),
            response_deserializer=resp_cls.FromString)(req, timeout=10)

    def stream(method, req, resp_cls, n=None):
        it = chan.unary_stream(
            f"/trident.Synchronizer/{method}",
            request_serializer=lambda x: x.SerializeToString(),
            response_deserializer=resp_cls.FromString)(req, timeout=10)
        out = []
        for r in it:
            out.append(r.SerializeToString().hex())
            if n is not None and len(out) == n:
                it.cancel()
                break
        return out

    out = {}
    try:
        syncs = []
        for i in range(8):
            syncs.append(call("Sync", pb.SyncRequest(
                ctrl_ip=f"10.1.0.{i}", host=f"agent-{i}", revision="v6",
                boot_time=1000 + i, state=pb.RUNNING, cpu_num=4,
                ctrl_mac=f"02:00:00:00:00:{i:02x}"),
                pb.SyncResponse).SerializeToString().hex())
        reg.set_config("default", {
            "max_cpus": 4, "mtu": 9000, "tap_mode": 1, "log_level": "warn",
            "ntp_enabled": True, "http_log_trace_id": ["traceparent",
                                                       "sw8"],
            "flow_acls": [{"id": 7, "protocol": 6, "dst_ports": "80,443",
                           "npb_actions": [{"tunnel_type": 1,
                                            "tunnel_id": 42,
                                            "tunnel_ip": "10.9.9.9"}]}]})
        model.update_domain("k8s", [m.model.make_resource(
            "pod", 10, "web-0", "k8s", ip="10.0.0.5")])
        for i in (0, 3):
            syncs.append(call("Sync", pb.SyncRequest(
                ctrl_ip=f"10.1.0.{i}", host=f"agent-{i}", revision="v6",
                boot_time=2000 + i), pb.SyncResponse)
                .SerializeToString().hex())
        out["sync"] = syncs
        client = bytearray(48)
        client[0] = (3 << 3) | 3
        client[40:48] = struct.pack(">Q", 0x1122334455667788)
        out["ntp"] = call("Query", pb.NtpRequest(
            ctrl_ip="10.1.0.1", request=bytes(client)),
            pb.NtpResponse).SerializeToString().hex()
        reg.set_upgrade("default", "v7", "pkg.bin", hashlib.sha256(
            packages["pkg.bin"]).hexdigest())
        out["offer"] = call("Sync", pb.SyncRequest(
            ctrl_ip="10.1.0.2", host="agent-2", revision="v6",
            boot_time=1002), pb.SyncResponse).SerializeToString().hex()
        out["upgrade"] = stream("Upgrade", pb.UpgradeRequest(
            ctrl_ip="10.1.0.2", ctrl_mac="02:00:00:00:00:02"),
            pb.UpgradeResponse)
        out["upgrade_refused"] = stream("Upgrade", pb.UpgradeRequest(
            ctrl_ip="10.99.0.1"), pb.UpgradeResponse)
        g = pb.GPIDSyncRequest(ctrl_ip="10.1.0.1", vtap_id=2)
        for k in range(5):
            e = g.entries.add()
            e.ipv4_0, e.port_0, e.pid_0 = 0x0A000001 + k, 40000 + k, 100 + k
            e.ipv4_1, e.port_1, e.pid_1 = 0x0A000100, 80, 200 + k % 2
        out["gpid"] = [call("GPIDSync", g, pb.GPIDSyncResponse)
                       .SerializeToString().hex() for _ in range(2)]
        gen = pb.GenesisSyncRequest(source_ip="10.1.0.4")
        gen.platform_data.raw_hostname = "agent-4"
        itf = gen.platform_data.interfaces.add()
        itf.name, itf.mac = "eth0", 0x020000000004
        itf.ip.extend(["10.1.0.4/24", "10.1.0.40/24", "bogus"])
        vm = gen.platform_data.interfaces.add()
        vm.name, vm.mac = "vnet0", 0x525400000001
        vm.device_name, vm.device_id = "guest-1", "uuid-1"
        out["genesis"] = call("GenesisSync", gen, pb.GenesisSyncResponse
                              ).SerializeToString().hex()
        out["genesis_rows"] = cp.rows(model.list())
        out["cluster"] = [call("GetKubernetesClusterID",
                               pb.KubernetesClusterIDRequest(
                                   ca_md5=ca, kubernetes_cluster_name=nm),
                               pb.KubernetesClusterIDResponse)
                          .SerializeToString().hex()
                          for ca, nm in (("ca-1", "prod"), ("", ""),
                                         ("ca-1", ""), ("ca-2", "dev"))]
        out["push"] = stream("Push", pb.SyncRequest(
            ctrl_ip="10.1.0.5", host="agent-5", revision="v6",
            boot_time=1005), pb.SyncResponse, n=1)
        out["counters"] = [svc.syncs, svc.upgrades_streamed,
                           svc.genesis_syncs]
        out["vtaps"] = [[v.vtap_id, v.ctrl_ip, v.host, v.ctrl_mac, v.group,
                         v.revision, v.boot_count] for v in reg.list()]
    finally:
        chan.close()
        server.stop(grace=0)
        ctl._httpd.server_close()
    return out


def test_bridge_answers_match_jax(tmp_path, monkeypatch):
    out = [_bridge_run(m, tmp_path, monkeypatch) for m in cp.both()]
    assert out[1] == out[0]
    assert len(out[1]["upgrade"]) >= 2 and len(out[1]["upgrade_refused"]) == 1
    assert out[1]["push"] and out[1]["counters"][2] == 1


# -- the JAX package's own bridge tests, on the port ----------------------
_REF, _REF_MOD = cp.reference_tests(cp.TESTS / "test_trident_grpc.py")
bridge = _REF_MOD.bridge        # the reference's fixture, on the port


@pytest.fixture
def cpu_defaults(monkeypatch):
    """The port's Server defaults to the card; the reference test bodies
    build one without a device, so here it defaults to the CPU."""
    from deepflow_tpu_torch.server import Server
    init = Server.__init__
    monkeypatch.setattr(init, "__defaults__", tuple(
        "cpu" if d == "cuda" else d for d in init.__defaults__))


@pytest.mark.parametrize("name", sorted(_REF))
def test_reference_bridge_tests_on_port(name, request, cpu_defaults):
    """tests/test_trident_grpc.py's test bodies, compiled against the
    port's modules (torch_ctl_pair.port_source), pass on the port."""
    fn = _REF[name]
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})
