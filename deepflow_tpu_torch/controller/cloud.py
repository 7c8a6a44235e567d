"""Cloud platform pollers: domain task loops feeding the recorder.

Reference: server/controller/cloud/ — one `Cloud` task per domain wraps a
platform client (aliyun/aws/.../filereader) behind a common interface
(`CheckAuth`, `GetCloudData() -> model.Resource`), polls it on the
configured gather interval (cloud.go:201 run loop), records per-task
cost (cloud.go:194 sendStatsd), holds the last-good resource snapshot on
failure (cloud.go:155 getCloudData), and runs kubernetes_gather subtasks
that compile k8s state reported via genesis into cloud resources
(kubernetes_gather_task.go). The 21k LoC of per-vendor API glue is
deployment-specific and stays out of scope (PARITY.md); what this module
keeps is the framework: the platform interface, the task loop, the
normalization into the resource model, and three real platform clients —

- FileReaderPlatform: the reference's `filereader` (YAML/JSON document of
  regions/azs/hosts/vpcs/subnets/pods/services — the manual-data path,
  filereader/filereader.go:105);
- HttpPlatform: a generic poller for anything that can serve the
  normalized snapshot shape over HTTP (the role of the per-vendor SDKs);
- KubernetesGatherPlatform: compiles agent-reported genesis interfaces
  into pod_node/pod rows for a named cluster (kubernetes_gather/).

Gathered snapshots flow through the Recorder (validated, ordered,
field-diffed reconciliation), exactly like hand-POSTed domain snapshots.

The port's own copy of the JAX package's `controller/cloud.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import contextlib
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from deepflow_tpu_torch.controller.model import (RESOURCE_TYPES, Resource,
                                                 ResourceModel, make_resource)
from deepflow_tpu_torch.controller.recorder import Recorder
from deepflow_tpu_torch.store.dict_store import fnv1a32

# document list-key -> resource type, in dependency order (parents first,
# the reference's getRegions->getAZs->getHosts->... sequencing)
_DOC_KEYS = (
    ("regions", "region"), ("azs", "az"), ("hosts", "host"),
    ("vpcs", "vpc"), ("subnets", "subnet"),
    ("pod_clusters", "pod_cluster"), ("pod_nodes", "pod_node"),
    ("pod_namespaces", "pod_ns"), ("pod_groups", "pod_group"),
    ("pods", "pod"), ("services", "service"),
)


def _stable_id(domain: str, rtype: str, name: str) -> int:
    """Restart-stable resource id from content (the role lcuuid plays in
    the reference: identity survives re-polls and controller restarts)."""
    return 1 + (fnv1a32(f"{domain}|{rtype}|{name}".encode()) & 0x3FFFFFF)


class ResourceBuilder:
    """Shared row builder for the vendor clients (aws/aliyun/tencent/
    huawei/qingcloud/baidubce): ids are CONTENT-STABLE 26-bit hashes
    of (domain, type, vendor key) — the role lcuuid plays in the
    reference — so re-polls and row-order changes keep every id (a
    local 1..N counter reshuffled on reorders and collided across
    domains on the same controller).

    Collision honesty (the id space is 26-bit because vendor ids flow
    into i32/u32 KnowledgeGraph columns): a WITHIN-domain hash
    collision (~1.5e-8 per pair) re-salts deterministically per key
    (key#1, key#2, ...) and is counted in `collisions` — the colliding
    key's id is then stable only while the winning key keeps first
    insertion, so treat a nonzero counter as a prompt to rename.
    CROSS-domain collisions are not resolvable here (the model keys
    rows by (type, id) globally); the recorder rejects that domain's
    snapshot LOUDLY ("owned by domain X") rather than silently
    merging two vendors' resources."""

    def __init__(self, domain: str) -> None:
        self.domain = domain
        self._ids: Dict[tuple, int] = {}
        self._used: Dict[str, set] = {}     # rtype -> {id}
        self._rows: List[Resource] = []
        self.collisions = 0

    def add(self, rtype: str, key: str, name: str, **attrs) -> int:
        rid = self._ids.get((rtype, key))
        if rid is None:
            used = self._used.setdefault(rtype, set())
            rid = _stable_id(self.domain, rtype, str(key))
            salt = 0
            while rid in used:
                self.collisions += 1
                salt += 1
                rid = _stable_id(self.domain, rtype,
                                 f"{key}#{salt}")
            used.add(rid)
            self._ids[(rtype, key)] = rid
            self._rows.append(make_resource(rtype, rid, name,
                                            domain=self.domain,
                                            **attrs))
        return rid

    def get(self, rtype: str, key: str, default: int = 0) -> int:
        return self._ids.get((rtype, key), default)

    def rows(self) -> List[Resource]:
        return self._rows


def add_vm_public_addresses(b: "ResourceBuilder", vm_key: str,
                            vm_rid: int, epc: int,
                            addrs: Sequence[tuple]) -> None:
    """The one normalized public-address shape every vendor client
    emits (one copy, not N drifting ones): WAN vinterface per
    (vm, mac) — vendors without macs collapse to one per vm — plus a
    wan_ip and a vm-bound floating_ip per address."""
    for ip, mac in addrs:
        if not ip:
            continue
        vif = b.add("vinterface", f"{vm_key}/wan/{mac}",
                    f"{vm_key}-wan", device_vm_id=vm_rid, mac=mac)
        b.add("wan_ip", f"{vm_key}/{ip}", ip,
              vinterface_id=vif, ip=ip)
        b.add("floating_ip", f"{vm_key}/{ip}", ip,
              vpc_id=epc, vm_id=vm_rid, ip=ip)


def rows_to_resources(rows: Sequence[dict], domain: str) -> List[Resource]:
    """Normalized snapshot rows ({type, id?, name, ...attrs}) ->
    Resource list. Shared by HttpPlatform and the controller's
    /v1/domains/<d>/resources handler so the two ingest paths can't
    diverge. A row without `id` gets a content-stable one."""
    return [make_resource(
        r["type"],
        int(r.get("id", 0)) or _stable_id(domain, r["type"], r["name"]),
        r["name"], domain,
        **{k: v for k, v in r.items()
           if k not in ("type", "id", "name", "domain")})
        for r in rows]


def parse_resource_doc(doc: dict, domain: str) -> List[Resource]:
    """Normalize a filereader-style document into Resource rows.

    Each list entry needs `name`; `id` is optional (content-hashed when
    absent). Parent links may be given by id (`vpc_id`) or by name
    (`vpc`), resolved against earlier rows of this document.
    """
    by_name: Dict[tuple, int] = {}
    out: List[Resource] = []
    for key, rtype in _DOC_KEYS:
        for entry in doc.get(key, []):
            if "name" not in entry:
                raise ValueError(f"{key} entry without name: {entry!r}")
            attrs = {k: v for k, v in entry.items()
                     if k not in ("name", "id")}
            # name-based parent refs -> id links
            for pk, pt in (("region", "region"), ("az", "az"),
                           ("vpc", "vpc"), ("pod_cluster", "pod_cluster"),
                           ("pod_node", "pod_node"), ("pod_ns", "pod_ns"),
                           ("pod_group", "pod_group")):
                if pk in attrs and isinstance(attrs[pk], str):
                    ref = (pt, attrs.pop(pk))
                    if ref not in by_name:
                        raise ValueError(
                            f"{key} entry {entry['name']!r} references "
                            f"unknown {pt} {ref[1]!r}")
                    attrs[f"{pk}_id"] = by_name[ref]
            rid = int(entry.get("id", 0)) or _stable_id(
                domain, rtype, entry["name"])
            by_name[(rtype, entry["name"])] = rid
            out.append(make_resource(rtype, rid, entry["name"],
                                     domain=domain, **attrs))
    return out


class FileReaderPlatform:
    """Reference filereader: a YAML/JSON resource document on disk."""

    def __init__(self, path: str, domain: str) -> None:
        self.path = path
        self.domain = domain

    def check_auth(self) -> None:
        with open(self.path):
            pass

    def get_cloud_data(self) -> List[Resource]:
        with open(self.path) as f:
            text = f.read()
        try:
            doc = json.loads(text)
        except ValueError:
            import yaml
            doc = yaml.safe_load(text)
        return parse_resource_doc(doc or {}, self.domain)


class HttpPlatform:
    """Polls a URL serving the normalized snapshot shape:
    {"resources": [{type, id?, name, ...attrs}, ...]} or a
    filereader-style document. Stands in for the per-vendor SDK glue."""

    def __init__(self, url: str, domain: str, timeout_s: float = 10.0,
                 headers: Optional[dict] = None) -> None:
        self.url = url
        self.domain = domain
        self.timeout_s = timeout_s
        self.headers = dict(headers or {})
        self._cached: Optional[dict] = None

    def _fetch(self) -> dict:
        req = urllib.request.Request(self.url, headers=self.headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.load(resp)

    def check_auth(self) -> None:
        # the snapshot IS the auth probe; keep it for the first gather so
        # `cloud add` doesn't fetch the same document twice back-to-back
        self._cached = self._fetch()

    def get_cloud_data(self) -> List[Resource]:
        doc, self._cached = self._cached, None
        if doc is None:
            doc = self._fetch()
        if "resources" in doc:
            return rows_to_resources(doc["resources"], self.domain)
        return parse_resource_doc(doc, self.domain)


# virtual-device name prefixes that must never be picked as a node's
# primary interface (genesis rows are named "<host>:<ifname>")
_VIRTUAL_IFACES = ("veth", "br", "docker", "cni", "flannel", "cali",
                   "lo", "tun", "vxlan", "kube")


def _iface_rank(r: Resource):
    """Primary NIC first: physical-looking names (eth0, ens3, ...) rank
    ahead of virtual devices, then lexicographic for stability. Plain
    name-sorting would crown 'br0' over 'eth0'."""
    ifname = r.name.rsplit(":", 1)[-1]
    return (ifname.startswith(_VIRTUAL_IFACES), r.name)


class KubernetesGatherPlatform:
    """Compiles genesis-reported agent interfaces into a k8s cluster view.

    Reference: controller/cloud/kubernetes_gather/ builds pod/node rows
    from the k8s API snapshot the agent ships via GenesisSync. Here the
    raw material is the per-agent genesis domains already in the model
    (`genesis/<host>` host rows): every reporting agent host becomes a
    pod_node of the named cluster, and interfaces it reported beyond the
    node address become pods on that node.
    """

    def __init__(self, model: ResourceModel, cluster: str, domain: str,
                 genesis_prefix: str = "genesis/") -> None:
        self.model = model
        self.cluster = cluster
        self.domain = domain
        self.genesis_prefix = genesis_prefix

    def check_auth(self) -> None:
        pass

    def get_cloud_data(self) -> List[Resource]:
        cluster_id = _stable_id(self.domain, "pod_cluster", self.cluster)
        ns_id = _stable_id(self.domain, "pod_ns", "default")
        out = [
            make_resource("pod_cluster", cluster_id, self.cluster,
                          domain=self.domain),
            make_resource("pod_ns", ns_id, "default", domain=self.domain,
                          pod_cluster_id=cluster_id),
        ]
        # genesis rows are per-agent domains: genesis/<host>
        by_host: Dict[str, List[Resource]] = {}
        for r in self.model.list(type="host"):
            if not r.domain.startswith(self.genesis_prefix):
                continue
            by_host.setdefault(
                r.domain[len(self.genesis_prefix):], []).append(r)
        for host, ifaces in sorted(by_host.items()):
            node_id = _stable_id(self.domain, "pod_node", host)
            ifaces = sorted(ifaces, key=_iface_rank)
            out.append(make_resource(
                "pod_node", node_id, host, domain=self.domain,
                pod_cluster_id=cluster_id,
                ip=ifaces[0].attr("ip", "")))
            for itf in ifaces[1:]:
                # secondary interfaces are pod veths in the k8s model
                out.append(make_resource(
                    "pod",
                    _stable_id(self.domain, "pod", itf.name),
                    itf.name, domain=self.domain,
                    pod_ns_id=ns_id, pod_node_id=node_id,
                    ip=itf.attr("ip", "")))
        return out


@dataclass
class TaskInfo:
    """Basic info + cost, the reference's GetBasicInfo + CloudTaskStatsd."""

    domain: str
    platform: str
    interval_s: float
    gathers_ok: int = 0
    gathers_failed: int = 0
    auth_failed: bool = False
    last_cost_s: float = 0.0
    last_error: str = ""
    last_gather_ts: float = 0.0
    resource_count: int = 0


class CloudTask:
    """One domain's poll loop: platform -> recorder, hold-last-good."""

    def __init__(self, platform, recorder: Recorder, domain: str,
                 interval_s: float = 60.0,
                 on_diff: Optional[Callable] = None) -> None:
        interval_s = float(interval_s)
        if not interval_s > 0:   # rejects 0, negatives, and NaN
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.platform = platform
        self.recorder = recorder
        self.domain = domain
        self.interval_s = interval_s
        self.on_diff = on_diff
        self.info = TaskInfo(domain, type(platform).__name__, interval_s)
        self._wake = threading.Event()
        self._stop = threading.Event()
        # serializes reconciles against teardown: a gather whose platform
        # fetch outlives close() (fetch timeout > join timeout) must not
        # re-insert resources after the manager's cascade delete
        self._reconcile_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def gather_once(self, now: Optional[float] = None) -> bool:
        """One gather+reconcile. On any failure the model keeps the
        last-good snapshot (reference cloud.go:155: a failed poll never
        clears resources). Returns success."""
        t0 = time.perf_counter()
        try:
            snapshot = self.platform.get_cloud_data()
            with self._reconcile_lock:
                if self._stop.is_set():   # closed mid-fetch: discard
                    return False
                diff = self.recorder.reconcile(self.domain, snapshot,
                                               now=now)
        except Exception as e:
            self.info.gathers_failed += 1
            self.info.last_error = f"{type(e).__name__}: {e}"
            return False
        finally:
            self.info.last_cost_s = time.perf_counter() - t0
            self.info.last_gather_ts = time.time() if now is None else now
        self.info.gathers_ok += 1
        self.info.last_error = ""
        self.info.auth_failed = False   # a working gather IS the auth proof
        self.info.resource_count = len(
            self.recorder.model.list(domain=self.domain))
        if self.on_diff is not None and diff.changed:
            try:
                self.on_diff(self.domain, diff)
            except Exception as e:
                # a broken subscriber must not kill the poll loop; the
                # gather itself succeeded and the model is updated
                self.info.last_error = f"on_diff: {type(e).__name__}: {e}"
        return True

    def trigger(self) -> None:
        """Request an immediate out-of-band gather (the reference's
        refresh-domain API path)."""
        self._wake.set()

    def start(self) -> None:
        try:
            self.platform.check_auth()
        except Exception as e:
            # reference: a task whose platform fails auth is created but
            # reports unhealthy; the loop still runs and retries
            self.info.auth_failed = True
            self.info.last_error = f"{type(e).__name__}: {e}"
        # supervised: a raising platform poller is crash-captured and
        # restarted instead of silently freezing the domain's resource
        # model
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            f"cloud-{self.domain}", self._loop,
            beat_period_s=self.interval_s)

    def _loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        self.gather_once()
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)   # trigger() shortcuts the wait
            self._wake.clear()
            sup.beat()
            if self._stop.is_set():
                break
            self.gather_once()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)


class CloudManager:
    """Owns one CloudTask per domain (reference: manager/ holding a Cloud
    per mysql.Domain row, rebuilding tasks as domains come and go)."""

    def __init__(self, recorder: Recorder,
                 on_diff: Optional[Callable] = None) -> None:
        self.recorder = recorder
        self.on_diff = on_diff
        self._tasks: Dict[str, CloudTask] = {}
        self._lock = threading.Lock()
        # per-domain locks order same-domain add()/remove() without
        # holding the manager lock across task.close() (a slow-to-stop
        # poller's 2s join must not stall get()/tasks()/other domains).
        # Entries are refcounted [lock, holders] and pruned at zero —
        # domain names come from the unauthenticated ops API, so an
        # unpruned dict would grow without bound.
        self._domain_locks: Dict[str, list] = {}
        self._started = False

    @contextlib.contextmanager
    def _domain_lock(self, domain: str):
        with self._lock:
            ent = self._domain_locks.setdefault(
                domain, [threading.Lock(), 0])
            ent[1] += 1
        try:
            with ent[0]:
                yield
        finally:
            with self._lock:
                ent[1] -= 1
                # prune only OUR entry at refcount zero: deleting while a
                # waiter holds a reference would hand the next caller a
                # fresh lock and break same-domain mutual exclusion
                if ent[1] == 0 and self._domain_locks.get(domain) is ent:
                    del self._domain_locks[domain]

    def add(self, domain: str, platform, interval_s: float = 60.0
            ) -> CloudTask:
        # construct (and validate) BEFORE popping the old task: a raising
        # constructor must not orphan a still-running poller
        task = CloudTask(platform, self.recorder, domain,
                         interval_s=interval_s, on_diff=self.on_diff)
        with self._domain_lock(domain):
            with self._lock:
                old = self._tasks.pop(domain, None)
                self._tasks[domain] = task
                started = self._started
            if old is not None:
                old.close()
        if started:
            task.start()
        return task

    def remove(self, domain: str) -> bool:
        # pop+close+cascade run under the DOMAIN lock so a concurrent
        # add() of the same domain is ordered strictly after (otherwise
        # the new task's first gather could land between the pop and the
        # cascade and have its fresh resources wiped); the manager lock
        # is held only for the pop, so other domains never block on a
        # slow close()
        with self._domain_lock(domain):
            with self._lock:
                task = self._tasks.pop(domain, None)
            if task is None:
                return False
            task.close()
            # domain deleted -> its resources go too (reference: deleting
            # a mysql.Domain cascades through recorder cleanup). Under the
            # task's reconcile lock: close() set _stop, so any gather
            # still blocked in its platform fetch will discard its
            # snapshot rather than resurrect the domain after this delete.
            with task._reconcile_lock:
                self.recorder.reconcile(domain, [])
        return True

    def get(self, domain: str) -> Optional[CloudTask]:
        with self._lock:
            return self._tasks.get(domain)

    def tasks(self) -> List[TaskInfo]:
        with self._lock:
            return [t.info for t in self._tasks.values()]

    def start(self) -> None:
        with self._lock:
            self._started = True
            tasks = list(self._tasks.values())
        for t in tasks:
            t.start()

    def close(self) -> None:
        with self._lock:
            self._started = False
            tasks = list(self._tasks.values())
            self._tasks.clear()
        for t in tasks:
            t.close()

    def counters(self) -> dict:
        infos = self.tasks()
        return {"tasks": len(infos),
                "gathers_ok": sum(i.gathers_ok for i in infos),
                "gathers_failed": sum(i.gathers_failed for i in infos)}
