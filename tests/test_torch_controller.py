"""The port's controller (deepflow_tpu_torch/controller/) against the JAX
package's, on the CPU.

Each scenario runs once per package from the same seeded inputs, and the
two results are compared for equality: ResourceModel diffs, events and
persistence; Recorder reconcile, orphans, refusals, sub-domains and the
soft-delete cleanup; VTapRegistry sync, group config, staged upgrades,
GPIDs and cluster ids; FleetMonitor assignments over 1-4 ingesters and
liveness; Election acquire, renew and expiry on one lease file;
TagRecorder dicts and their files; compile_platform_data, and
PlatformPusher into each package's PlatformDataManager with the same l4
columns stamped; GenesisSync export and merge; and ControllerServer's
JSON answer on every route, ports and timestamps masked. Last, the JAX
package's own tests/test_controller.py bodies run against the port.
Wall-clock inputs are frozen (torch_ctl_pair.FrozenClock) so both
packages see the same time."""

import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import torch_ctl_pair as cp

REF = cp.TESTS / "test_controller.py"


def _same(run, *a, **k):
    """run(mods, *a) for the JAX package and the port; equal results."""
    out = [run(m, *a, **k) for m in cp.both()]
    assert json.dumps(out[1], sort_keys=True, default=str) == \
        json.dumps(out[0], sort_keys=True, default=str)
    return out[1]


def _snapshot(m, rng, domain="k8s", **kw):
    return m.cloud.parse_resource_doc(cp.make_doc(rng, **kw), domain)


# -- ResourceModel and Recorder -------------------------------------------
def _model_run(m, tmp, seed):
    rng = np.random.default_rng(seed)
    root = Path(tmp) / m.pkg
    root.mkdir()
    model = m.model.ResourceModel(str(root / "model.json"))
    events = []
    model.subscribe(lambda d: events.append(cp.diff_json(d)))
    rec = m.recorder.Recorder(model, retention_s=100.0)
    snap = _snapshot(m, rng)
    out = {"parsed": cp.rows(snap)}
    out["d1"] = cp.diff_json(rec.reconcile("k8s", snap, now=1000.0))
    out["d_same"] = cp.diff_json(rec.reconcile("k8s", snap, now=1001.0))
    # drop 5 pods, rename 3, move 2 to another node, add an orphan whose
    # node does not exist, and a second domain
    pods = [r for r in snap if r.type == "pod"]
    drop = {r.id for r in pods[:5]}
    snap2 = []
    for r in snap:
        if r.id in drop and r.type == "pod":
            continue
        if r.type == "pod" and r in pods[5:8]:
            r = m.model.make_resource(r.type, r.id, r.name + "-x", r.domain,
                                      **dict(r.attrs))
        elif r.type == "pod" and r in pods[8:10]:
            a = dict(r.attrs)
            a["pod_node_id"] = [x.id for x in snap
                                if x.type == "pod_node"][-1]
            r = m.model.make_resource(r.type, r.id, r.name, r.domain, **a)
        snap2.append(r)
    snap2.append(m.model.make_resource("pod", 999_001, "stray", "k8s",
                                       pod_node_id=424242))
    d2 = rec.reconcile("k8s", snap2, now=1010.0)
    out["d2"] = cp.diff_json(d2)
    out["d2_fields"] = [[c.type, c.id, c.field, c.old, c.new]
                        for c in d2.field_changes]
    out["other"] = cp.diff_json(rec.reconcile(
        "vm-dom", _snapshot(m, rng, "vm-dom", prefix="o-", n_pods=6,
                  subnet_id=201),
        now=1020.0))
    # refusals: a duplicate row, an unknown type, a row of another domain
    errs = []
    for bad in ([snap2[0], snap2[0]],
                [m.model.make_resource("frobnicator", 1, "x", "k8s")],
                [m.model.make_resource("pod", pods[20].id, "thief",
                                       "vm-dom")]):
        try:
            rec.reconcile(bad[0].domain, bad, now=1030.0)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    # a sub-domain refresh inside k8s, then one that drops a row
    sd = m.model.make_resource("sub_domain", 77, "attached", "k8s")
    base = [r for r in model.list(domain="k8s")]
    rec.reconcile("k8s", base + [sd], now=1040.0)
    sub = [m.model.make_resource("pod", 880_000 + i, f"sub-{i}", "k8s",
                                 sub_domain_id=77, ip=f"10.9.0.{i}")
           for i in range(4)]
    out["sub1"] = cp.diff_json(rec.reconcile_sub_domain("k8s", 77, sub,
                                                        now=1050.0))
    out["sub2"] = cp.diff_json(rec.reconcile_sub_domain("k8s", 77, sub[:2],
                                                        now=1060.0))
    out["tombs"] = cp.rows(rec.deleted_resources())
    out["counters_before"] = rec.counters()
    out["cleanup_early"] = rec.cleanup(now=1100.0)
    out["cleanup"] = rec.cleanup(now=1200.0)
    out["counters"] = rec.counters()
    out["upsert"] = [model.upsert(m.model.make_resource(
        "sub_domain", 78, "v", "genesis-processes")) for _ in range(2)]
    out["events"] = events
    out["version"] = model.version
    out["model"] = cp.rows(model.list())
    again = m.model.ResourceModel(str(root / "model.json"))
    out["reloaded"] = [again.version, cp.rows(again.list())]
    out["by_type"] = {t: len(model.list(type=t)) for t in
                      m.model.RESOURCE_TYPES if model.list(type=t)}
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_model_and_recorder_match_jax(tmp_path, seed):
    out = _same(_model_run, tmp_path, seed)
    assert out["d1"]["created"] and not out["d_same"]["created"]
    assert len(out["d2"]["deleted"]) == 5 and out["d2"]["orphaned"]
    assert all(out["errors"]) and out["cleanup"] > 0


# -- VTapRegistry and FleetMonitor ----------------------------------------
def _vtap(v):
    return {k: val for k, val in vars(v).items()
            if k not in ("created_at", "last_seen")}


def _resp(r):
    return {k: v for k, v in r.items() if k != "server_time_ns"}


def _registry_run(m, tmp, seed, monkeypatch):
    clock = cp.FrozenClock(monkeypatch)
    rng = np.random.default_rng(seed)
    path = str(Path(tmp) / f"{m.pkg}-vtaps.json")
    reg = m.registry.VTapRegistry(path)
    agents = [(f"10.{i // 256}.{i % 256}.{rng.integers(1, 250)}",
               f"node-{i}") for i in range(40)]
    out = {"sync": []}
    for i, (ip, host) in enumerate(agents):
        procs = [{"pid": int(p), "start_time": int(s)}
                 for p, s in zip(rng.integers(100, 200, 3),
                                 rng.integers(0, 3, 3))]
        out["sync"].append(_resp(reg.sync(ip, host, "rev-1",
                                          boot=bool(i % 3 == 0),
                                          processes=procs)))
    out["set_config"] = [reg.set_config("default", {"max_cpus": 4,
                                                    "l7_log_rate": 77}),
                         reg.set_config("edge", {"max_memory_mb": 512})]
    for bad in ({"nope": 1}, {"so_plugins": "x.so"}, {"mtu": -1},
                {"tap_mode": 9}, {"flow_acls": [1]}):
        with pytest.raises(ValueError) as e:
            reg.set_config("default", bad)
        out.setdefault("refused", []).append(str(e.value))
    for ip, host in agents[:10]:
        reg.set_group(ip, host, "edge")
    out["groups"] = reg.groups()
    out["configs"] = [reg.get_config("edge"), reg.get_config("nope")]
    out["resync"] = [_resp(reg.sync(ip, host, "rev-1"))
                     for ip, host in agents[:12]]
    # a staged upgrade of "edge", one agent at a time
    reg.set_upgrade("edge", "rev-2", "agent-2.bin", "ab" * 32)
    offers = []
    for round_ in range(4):
        clock.advance(61.0)
        for ip, host in agents[:10]:
            r = reg.sync(ip, host, "rev-2" if round_ and
                         offers and offers[-1][0] == host else "rev-1")
            offers.append((host, r.get("upgrade")))
    out["offers"] = offers
    out["status"] = reg.upgrade_status()
    out["target"] = reg.upgrade_target("edge")
    out["cleared"] = [reg.clear_upgrade("edge"), reg.clear_upgrade("edge")]
    out["gpid_batch"] = {str(k): v for k, v in reg.gpid_batch(
        3, [0, 101, 102, 150, 5000]).items()}
    out["cluster"] = [reg.cluster_id_for("ca-1", "c1"),
                      reg.cluster_id_for("ca-2"),
                      reg.cluster_id_for("ca-1", "renamed")]
    out["vtaps"] = [_vtap(v) for v in reg.list()]
    again = m.registry.VTapRegistry(path)
    out["reloaded"] = [[_vtap(v) for v in again.list()],
                       again.config_version, again.get_config("edge"),
                       _resp(again.sync(*agents[5], "rev-1"))]
    out["file"] = _masked(json.loads(Path(path).read_text()))
    # the fleet monitor over the same registry: 1..4 ingesters
    mon = m.monitor.FleetMonitor(reg, offline_after_s=30.0)
    out["assign"] = []
    for k in range(0, 5):
        mon.set_ingesters([f"ing-{j}:30033" for j in range(k)])
        out["assign"].append([mon.ingesters(), mon.assignments(),
                              [mon.assign(ip, h) for ip, h in agents]])
    # liveness: half the fleet goes quiet
    clock.advance(40.0)
    for ip, host in agents[::2]:
        reg.sync(ip, host, "rev-1")
    out["check"] = mon.check()
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_registry_and_monitor_match_jax(tmp_path, seed, monkeypatch):
    out = _same(_registry_run, tmp_path, seed, monkeypatch)
    assert [s["vtap_id"] for s in out["sync"]] == list(range(1, 41))
    assert any(o for _, o in out["offers"])
    assert len(out["check"]["offline"]) == 20
    # rendezvous: adding a fourth ingester moves only its own share
    three, four = out["assign"][3][2], out["assign"][4][2]
    assert all(b == a or b == "ing-3:30033" for a, b in zip(three, four))


# -- Election -------------------------------------------------------------
def _election_run(m, tmp, monkeypatch):
    lease = str(Path(tmp) / f"{m.pkg}-lease.json")
    ids = iter(["a" * 32, "b" * 32])
    monkeypatch.setattr(m.election.uuid, "uuid4",
                        lambda: type("U", (), {"hex": next(ids)})())
    a = m.election.Election(lease, lease_seconds=5.0)
    b = m.election.Election(lease, lease_seconds=5.0)
    seen = []
    a.on_started_leading.append(lambda: seen.append("a+"))
    a.on_stopped_leading.append(lambda: seen.append("a-"))
    b.on_started_leading.append(lambda: seen.append("b+"))
    steps = [(a, 0.0), (b, 1.0), (a, 3.0), (b, 6.0), (b, 9.0), (a, 10.0),
             (b, 12.0), (a, 20.0)]
    out = []
    for who, t in steps:
        out.append([who.identity, t, who.try_acquire(now=t),
                    a.is_leader, b.is_leader,
                    json.loads(Path(lease).read_text())])
    b.close()
    out.append([Path(lease).exists(), b.is_leader, seen])
    # tampered lease content reads as no lease, judged by file age
    Path(lease).write_text("true")
    out.append([a.try_acquire(now=time.time() + 60), a.is_leader])
    a.close()
    return out


def test_election_matches_jax(tmp_path, monkeypatch):
    out = _same(_election_run, tmp_path, monkeypatch)
    # b takes the lease once a's expires, a takes it back once b's does
    assert [s[2] for s in out[:8]] == [True, False, True, False, True,
                                       False, True, True]


# -- TagRecorder, platform data, genesis ----------------------------------
COLUMNS = ("pod_id_0", "pod_id_1", "pod_node_id_1", "pod_ns_id", "subnet_id_1",
           "region_id_0", "az_id_1", "l3_epc_id", "service_id_1",
           "pod_group_id_0", "pod_cluster_id", "gprocess_id_0", "ip_0",
           "nothing")


def _tag_run(m, tmp, seed):
    rng = np.random.default_rng(seed)
    root = Path(tmp) / m.pkg
    model = m.model.ResourceModel()
    tr = m.tagrecorder.TagRecorder(model, root=str(root))
    snap = _snapshot(m, rng)
    model.update_domain("k8s", snap)
    model.update_domain("k8s", snap[:-6])
    ids = sorted({r.id for r in snap})
    out = {"names": {c: [tr.column_name(c, i) for i in ids]
                     for c in COLUMNS},
           "dicts": {c: (None if tr.dict_for_column(c) is None
                         else sorted(tr.dict_for_column(c).snapshot()
                                     .items()))
                     for c in COLUMNS},
           "by_name": tr.dict_for_column("pod_id").ids_for_name("pod-3"),
           "files": {p.name: p.read_text() for p in
                     sorted((root / "tagrecorder").iterdir())}}
    again = m.tagrecorder.TagRecorder(m.model.ResourceModel(),
                                      root=str(root))
    out["reloaded"] = {t: sorted(d.snapshot().items())
                       for t, d in again.dicts.items() if len(d)}
    return out


def test_tagrecorder_matches_jax(tmp_path):
    out = _same(_tag_run, tmp_path, 6)
    assert out["names"]["pod_id_1"].count(None) < len(
        out["names"]["pod_id_1"])
    assert out["by_name"]


def _l4_cols(rng, doc, n=4096):
    """l4 columns whose addresses hit pods, nodes, services, the
    domain's CIDRs and nothing, with epc 0 and a few other epcs."""
    pods = [int.from_bytes(bytes(map(int, p["ip"].split("."))), "big")
            for p in doc["pods"]]
    pool = np.array(pods + [0x0A000001, 0x0A010001, 0xC0A80101,
                            0xAC1F0005, 0x08080808], np.uint32)
    return {
        "ip_src": rng.choice(pool, n).astype(np.uint32),
        "ip_dst": rng.choice(pool, n).astype(np.uint32),
        "port_dst": rng.choice(np.array([80, 443, 8080, 53], np.uint32), n),
        "proto": rng.choice(np.array([6, 17], np.uint32), n),
        "l3_epc_id": rng.choice(np.array([0, 0, 0, 3, -2], np.int32), n),
        "l3_epc_id_1": rng.choice(np.array([0, 0, 3], np.int32), n),
    }


def _platform_run(m, seed):
    rng = np.random.default_rng(seed)
    doc = cp.make_doc(rng, n_pods=64)
    model = m.model.ResourceModel()
    model.update_domain("k8s", m.cloud.parse_resource_doc(doc, "k8s"))
    # hosts, vms, vinterfaces with lan/wan ips, and bad rows
    extra = [
        m.model.make_resource("host", 7001, "h1", "iaas", ip="10.3.3.3",
                              az_id=1, region_id=1),
        m.model.make_resource("host", 7002, "bad", "iaas", ip="nope"),
        m.model.make_resource("vm", 7101, "vm1", "iaas", ip="10.4.4.4",
                              vpc_id=3, az_id=2),
        m.model.make_resource("vinterface", 7201, "eni", "iaas",
                              device_vm_id=7101, subnet_id=102),
        m.model.make_resource("lan_ip", 7301, "10.4.4.5", "iaas",
                              vinterface_id=7201),
        m.model.make_resource("wan_ip", 7302, "8.8.8.8", "iaas",
                              vinterface_id=7201, ip="8.8.8.8"),
        m.model.make_resource("subnet", 7401, "badnet", "iaas",
                              cidr="x/99"),
    ]
    model.update_domain("iaas", extra)
    ifaces, cidrs, services, version = \
        m.platform_compiler.compile_platform_data(model)
    out = {"compiled": [[vars(i) for i in ifaces], [vars(c) for c in cidrs],
                        [vars(s) for s in services], version]}
    mgr = m.platform_data.PlatformDataManager()
    pusher = m.platform_compiler.PlatformPusher(model, mgr)
    cols = _l4_cols(rng, doc)
    stamped = mgr.stamp_l4(cols)
    out["stamp"] = {k: [str(v.dtype), v.tolist()]
                    for k, v in sorted(stamped.items())}
    # the next version reaches the manager through the subscription
    model.update_domain("k8s", m.cloud.parse_resource_doc(
        {**doc, "pods": doc["pods"][:32]}, "k8s"))
    out["pushed_again"] = [pusher.push(), mgr.info.version, model.version]
    out["stamp2"] = mgr.stamp_l4(cols)["pod_id_1"].tolist()
    out["counters"] = mgr.info.counters()
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_platform_data_matches_jax(seed):
    out = _same(_platform_run, seed)
    assert any(out["stamp"]["pod_id_1"][1])
    assert out["pushed_again"][1] == out["pushed_again"][2]


def _genesis_run(m):
    model = m.model.ResourceModel()
    g = m.genesis_sync.GenesisSync(model)
    for d in ("genesis/a", "genesis/b"):
        model.update_domain(d, [m.model.make_resource(
            "host", 1_000_000 + len(d) + ord(d[-1]), f"{d}:eth0", d,
            ip=f"10.0.0.{ord(d[-1])}")])
        g.mark_local(d)
    peer_model = m.model.ResourceModel()
    peer = m.genesis_sync.GenesisSync(peer_model)
    out = {"export": g.export()}
    out["merge1"] = peer.merge(g.export(), peer="http://a")
    out["peer_rows"] = cp.rows(peer_model.list())
    peer.mark_local("genesis/b")
    out["merge2"] = peer.merge({"genesis/a": []}, peer="http://a")
    out["merge3"] = peer.merge({}, peer="http://a")
    out["peer_rows2"] = cp.rows(peer_model.list())
    out["counters"] = [g.counters(), peer.counters()]
    return out


def test_genesis_sync_matches_jax():
    _same(_genesis_run)


# -- ControllerServer: every route ----------------------------------------
_MASK = ("server_time_ns", "created_at", "last_seen", "identity",
         "last_gather_s", "last_gather", "cost_s", "last_cost_s",
         "next_gather", "gather_cost_s")


def _masked(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in _MASK else _masked(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_masked(v) for v in x]
    return x


def _call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return [r.status, json.load(r)]
    except urllib.error.HTTPError as e:
        return [e.code, json.load(e)]


def _routes_run(m, tmp, monkeypatch):
    cp.FrozenClock(monkeypatch)
    root = Path(tmp) / m.pkg
    root.mkdir()
    docs = root / "docs"
    docs.mkdir()
    doc = cp.make_doc(np.random.default_rng(9), n_pods=16)
    (docs / "k8s.json").write_text(json.dumps(doc))
    model = m.model.ResourceModel(str(root / "model.json"))
    reg = m.registry.VTapRegistry(str(root / "vtaps.json"))
    mon = m.monitor.FleetMonitor(reg)
    ids = iter(["e" * 32])
    monkeypatch.setattr(m.election.uuid, "uuid4",
                        lambda: type("U", (), {"hex": next(ids)})())
    el = m.election.Election(str(root / "lease.json"))
    el.try_acquire()
    tr = m.tagrecorder.TagRecorder(model, root=str(root))
    srv = m.server.ControllerServer(
        model, reg, mon, election=el, tagrecorder=tr,
        cloud_resource_dir=str(docs), package_dir=str(root / "pkgs"),
        port=0)
    srv.start()
    p = srv.port
    calls = [
        ("GET", "/v1/health", None), ("GET", "/health", None),
        ("GET", "/v1/election", None),
        ("POST", "/v1/ingesters", {"addrs": ["127.0.0.1:30033",
                                             "127.0.0.1:30034"]}),
        ("GET", "/v1/vtap-group-config", None),
        ("POST", "/v1/vtap-group-config?group=default",
         {"max_cpus": 2, "sync_interval_s": 5}),
        ("POST", "/v1/vtap-group-config?group=default", {"nope": 1}),
        ("GET", "/v1/vtap-group-config?group=default", None),
        ("GET", "/v1/vtap-groups", None),
    ]
    for i in range(6):
        calls.append(("POST", "/v1/sync", {
            "ctrl_ip": f"10.8.0.{i}", "host": f"n{i}", "revision": "r1",
            "boot": i % 2 == 0,
            "processes": [{"pid": 10 + i, "name": f"proc-{i}",
                           "start_time": 5}]}))
    calls += [
        ("POST", "/v1/sync", {"host": "no-ip"}),
        ("GET", "/v1/vtaps", None), ("GET", "/v1/assignments", None),
        ("POST", "/v1/genesis", {"ctrl_ip": "10.8.0.1", "host": "n1",
                                 "interfaces": [
                                     {"name": "eth0", "ip": "10.8.0.1"},
                                     {"name": "bad", "ip": "x"},
                                     {"name": "vnet0", "mac": "52:54:00:1",
                                      "domain_name": "guest-1"}]}),
        ("GET", "/v1/genesis/export", None),
        ("POST", "/v1/domains/manual/resources", {"resources": [
            {"type": "region", "id": 1, "name": "r"},
            {"type": "pod", "id": 10, "name": "web-0", "ip": "10.0.0.5",
             "epc_id": 3, "region_id": 1}]}),
        ("POST", "/v1/domains/manual/resources", {"resources": [
            {"type": "region", "id": 1, "name": "r"},
            {"type": "pod", "id": 10, "name": "web-0b", "ip": "10.0.0.6",
             "epc_id": 3, "region_id": 1}]}),
        ("POST", "/v1/cloud/domains", {"domain": "k8s",
                                       "platform": "filereader",
                                       "path": str(docs / "k8s.json"),
                                       "interval_s": 3600}),
        ("POST", "/v1/cloud/domains", {"domain": "x", "platform":
                                       "filereader", "path": "/etc/hosts"}),
        ("POST", "/v1/cloud/domains", {"domain": "h", "platform": "http",
                                       "url": "file:///etc/hosts"}),
        ("POST", "/v1/cloud/domains", {"domain": "v", "platform": "vmware"}),
        ("POST", "/v1/cloud/domains", {"domain": "", "platform": "http"}),
        ("POST", "/v1/cloud/domains", {"domain": "kg", "platform":
                                       "kubernetes_gather",
                                       "cluster": "c1", "interval_s": 3600}),
        ("POST", "/v1/domains/k8s/refresh", None),
        ("POST", "/v1/domains/kg/refresh", None),
        ("POST", "/v1/domains/none/refresh", None),
        ("GET", "/v1/cloud/tasks", None),
        ("GET", "/v1/resources?type=pod", None),
        ("GET", "/v1/resources", None),
        ("GET", "/v1/platform-data", None),
        ("GET", "/v1/recorder", None),
        ("POST", "/v1/upgrade-package", {"name": "agent.bin",
                                         "data_b64": "AAECAw=="}),
        ("POST", "/v1/upgrade-package", {"name": "../x",
                                         "data_b64": "AA=="}),
        ("GET", "/v1/upgrade-package?name=agent.bin", None),
        ("GET", "/v1/upgrade-package?name=agent.bin&meta=1", None),
        ("GET", "/v1/upgrade-package?name=missing", None),
        ("POST", "/v1/upgrade", {"group": "default", "revision": "r2",
                                 "package": "agent.bin"}),
        ("POST", "/v1/upgrade", {"revision": "r2", "package": "gone"}),
        ("POST", "/v1/sync", {"ctrl_ip": "10.8.0.0", "host": "n0",
                              "revision": "r1"}),
        ("GET", "/v1/upgrade", None),
        ("DELETE", "/v1/upgrade/default", None),
        ("DELETE", "/v1/upgrade/default", None),
        ("DELETE", "/v1/cloud/domains/k8s", None),
        ("DELETE", "/v1/cloud/domains/k8s", None),
        ("DELETE", "/v1/nothing", None),
        ("GET", "/v1/nothing", None), ("POST", "/v1/nothing", {}),
        ("GET", "/v1/resources?type=pod", None),
        ("GET", "/v1/recorder", None),
    ]
    try:
        out = [[meth, path, _masked(_call(p, meth, path, body))]
               for meth, path, body in calls]
        out.append(["prune", srv.prune_dead_vtap_processes(ttl_s=-1.0)])
        out.append(["package", srv.package_bytes("agent.bin"),
                    srv.package_bytes("missing")])
        out.append(["counters", srv.recorder.counters(),
                    srv.genesis_sync.counters(),
                    srv.process_record_errors])
        out.append(["files", sorted(x.name for x in root.iterdir())])
    finally:
        srv.close()
        el.close()
    return out


def test_controller_routes_match_jax(tmp_path, monkeypatch):
    out = _same(_routes_run, tmp_path, monkeypatch)
    codes = {(m, p): r[0] for m, p, r in out[:-4]}
    assert codes[("GET", "/v1/platform-data")] == 200
    assert codes[("GET", "/v1/nothing")] == 404
    assert codes[("POST", "/v1/sync")] == 200


def test_package_bytes_survive_restart(tmp_path):
    """An uploaded package is read back from package_dir by a fresh
    server of either package (a controller restart mid-rollout)."""
    def run(m):
        d = tmp_path / m.pkg
        srv = m.server.ControllerServer(
            m.model.ResourceModel(), m.registry.VTapRegistry(),
            package_dir=str(d), port=0)
        srv.start()
        srv._post("/v1/upgrade-package", {},
                  {"name": "a.bin", "data_b64": "aGVsbG8="})
        srv.close()
        again = m.server.ControllerServer(
            m.model.ResourceModel(), m.registry.VTapRegistry(),
            package_dir=str(d), port=0)
        again.start()
        try:
            return [again.package_bytes("a.bin").decode(),
                    again.package_bytes("../a.bin"),
                    again._get("/v1/upgrade-package",
                               {"name": "a.bin", "meta": "1"})]
        finally:
            again.close()
    assert _same(run)[0] == "hello"


# -- the JAX package's own controller tests, on the port ------------------
# the concurrent race is load-sensitive under the suite's parallel run
# (ROADMAP standing context); test_election_matches_jax covers the port's
# election deterministically
_REF, _REF_MOD = cp.reference_tests(
    REF, skip=("test_election_concurrent_race_exactly_one_winner",))


@pytest.fixture
def cpu_defaults(monkeypatch):
    """The port's entry points that default to the card default to the
    CPU here (this host has none): the reference test bodies build a
    QueryEngine without a device."""
    from deepflow_tpu_torch.querier.engine import QueryEngine
    init = QueryEngine.__init__
    monkeypatch.setattr(init, "__defaults__", tuple(
        "cpu" if d == "cuda" else d for d in init.__defaults__))


@pytest.mark.parametrize("name", sorted(_REF))
def test_reference_controller_tests_on_port(name, tmp_path, cpu_defaults,
                                            request):
    """tests/test_controller.py's test bodies, compiled against the port's
    modules (torch_ctl_pair.port_source), pass on the port."""
    import inspect
    fn = _REF[name]
    params = inspect.signature(fn).parameters
    marks = [mk for mk in getattr(fn, "pytestmark", [])
             if mk.name == "parametrize"]
    if marks:
        argname, values = marks[0].args
        for v in values:
            kw = {argname: v}
            if "tmp_path" in params:
                kw["tmp_path"] = tmp_path / str(v)
                kw["tmp_path"].mkdir()
            fn(**kw)
        return
    kw = {}
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    fn(**kw)
