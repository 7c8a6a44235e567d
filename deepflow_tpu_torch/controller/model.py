"""Resource model: the controller's source-of-truth tables.

Reference: server/controller/recorder/ reconciles cloud-API and
genesis-reported snapshots into MySQL resource tables (region/az/host/
vpc/subnet/pod_node/pod_ns/pod_group/pod/service), and emits change
events. Here the model is in-memory dataclass tables persisted as one
JSON document, with the same diff-on-update discipline: update_domain()
reconciles a full snapshot per domain and reports created/deleted ids so
resource events and dictionary syncs stay incremental.

The port's own copy of the JAX package's `controller/model.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# Ordered PARENTS-FIRST: the recorder sorts created lists by this index
# so a subscriber never sees a child before its parent. The set mirrors
# the reference's updater fleet (server/controller/recorder/updater/ —
# region.go, az.go, sub_domain.go, host.go, vm.go, vpc.go, network.go,
# vrouter.go, routing_table.go, vinterface.go, wan_ip.go, lan_ip.go,
# floating_ip.go, security_group(+_rule).go, nat_gateway.go,
# nat_rule.go, nat_vm_connection.go, lb.go, lb_listener.go,
# lb_target_server.go, lb_vm_connection.go, peer_connection.go, cen.go,
# rds_instance.go, redis_instance.go, pod_cluster.go, pod_node.go,
# vm_pod_node_connection.go, pod_namespace.go, pod_ingress(+rule,
# +rule_backend).go, pod_service(+port).go, pod_group(+port).go,
# pod_replica_set.go, pod.go, process.go).
RESOURCE_TYPES = (
    "region", "az", "sub_domain", "host", "vpc", "vm", "subnet",
    "vrouter", "routing_table", "vinterface", "wan_ip", "lan_ip",
    "security_group", "security_group_rule",
    "nat_gateway", "nat_rule", "nat_vm_connection",
    "floating_ip",      # links vpc+vm+nat_gateway: after all three
    "lb", "lb_listener", "lb_target_server", "lb_vm_connection",
    "peer_connection", "cen", "rds_instance", "redis_instance",
    "pod_cluster", "pod_node", "vm_pod_node_connection",
    "pod_ns", "pod_ingress", "pod_ingress_rule",
    "pod_ingress_rule_backend", "service", "pod_service_port",
    "pod_group", "pod_group_port", "pod_replica_set", "pod",
    "process",
)


@dataclass(frozen=True)
class Resource:
    """One row of any resource table."""

    type: str
    id: int
    name: str
    domain: str = "default"
    # type-specific links (epc_id for subnets/pods, ip/port for services...)
    attrs: Tuple[Tuple[str, object], ...] = ()

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default


def make_resource(type: str, id: int, name: str, domain: str = "default",
                  **attrs) -> Resource:
    return Resource(type, id, name, domain,
                    tuple(sorted(attrs.items())))


@dataclass
class DomainDiff:
    created: List[Resource] = field(default_factory=list)
    deleted: List[Resource] = field(default_factory=list)
    updated: List[Resource] = field(default_factory=list)

    @property
    def changed(self) -> bool:
        return bool(self.created or self.deleted or self.updated)


class ResourceModel:
    """All resource tables + version counter + change subscribers."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._rows: Dict[Tuple[str, int], Resource] = {}
        self._lock = threading.Lock()
        self.version = 1
        self._subscribers: List[Callable[[DomainDiff], None]] = []
        if path is not None and os.path.exists(path):
            self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        with open(self.path) as f:
            doc = json.load(f)
        self.version = doc.get("version", 1)
        for r in doc.get("resources", []):
            res = Resource(r["type"], r["id"], r["name"], r["domain"],
                           tuple((k, v) for k, v in r["attrs"]))
            self._rows[(res.type, res.id)] = res

    def _save(self) -> None:
        if self.path is None:
            return
        doc = {
            "version": self.version,
            "resources": [
                {"type": r.type, "id": r.id, "name": r.name,
                 "domain": r.domain, "attrs": [list(a) for a in r.attrs]}
                for r in self._rows.values()
            ],
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    # -- queries -----------------------------------------------------------
    def list(self, type: Optional[str] = None,
             domain: Optional[str] = None) -> List[Resource]:
        with self._lock:
            return [r for r in self._rows.values()
                    if (type is None or r.type == type)
                    and (domain is None or r.domain == domain)]

    def get(self, type: str, id: int) -> Optional[Resource]:
        with self._lock:
            return self._rows.get((type, id))

    # -- updates -----------------------------------------------------------
    def upsert(self, resource: Resource) -> bool:
        """Atomic single-row create/update (no deletion scope at all —
        unlike update_domain this can never remove anything). Returns
        True when the row changed; subscribers see a one-row diff.
        Exists for hot-path upserts (per-sync sub_domain rows) where a
        whole-domain reconcile would be an O(domain) read-modify-write
        race against concurrent syncs."""
        with self._lock:
            old = self._rows.get((resource.type, resource.id))
            if old == resource:
                return False
            if old is not None and old.domain != resource.domain:
                raise ValueError(
                    f"resource {(resource.type, resource.id)} is owned "
                    f"by domain {old.domain!r}")
            self._rows[(resource.type, resource.id)] = resource
            self.version += 1
            self._save()
        diff = DomainDiff(created=[resource] if old is None else [],
                          updated=[resource] if old is not None else [])
        for fn in self._subscribers:
            fn(diff)
        return True

    def subscribe(self, fn: Callable[[DomainDiff], None]) -> None:
        """Called after each update_domain with the diff (reference:
        recorder/pubsub feeding tagrecorder + resource-event emit)."""
        self._subscribers.append(fn)

    def update_domain(self, domain: str, snapshot: List[Resource],
                      sub_domain_id: Optional[int] = None) -> DomainDiff:
        """Reconcile the full snapshot for one domain (reference:
        recorder.Refresh diff engines, recorder/updater/).

        `sub_domain_id` narrows the reconciliation scope to ONE
        sub-domain's rows (reference: cloud/sub_domain.go — an attached
        k8s cluster refreshes independently of its owning cloud
        domain): only rows carrying that sub_domain_id attr are
        eligible for deletion, and every snapshot row must carry it —
        a sub-domain refresh can never delete the parent domain's own
        resources, and a full-domain refresh (None) owns only the
        un-scoped rows."""
        for r in snapshot:   # validate before any mutation
            if r.domain != domain:
                raise ValueError(f"resource {r} not in domain {domain}")
            # scope symmetry: a sub-domain refresh must carry ITS id on
            # every row, and a full-domain refresh must carry none — a
            # scoped row upserted by the full-domain path would be
            # deletable by NO refresh (each side's deletion scope would
            # skip it), i.e. an immortal stale resource
            if r.attr("sub_domain_id", 0) != (sub_domain_id or 0):
                raise ValueError(
                    f"resource {(r.type, r.id)} sub_domain scope "
                    f"mismatch (refresh scope: {sub_domain_id})")
        diff = DomainDiff()
        with self._lock:
            new_keys = {(r.type, r.id) for r in snapshot}
            for key, old in list(self._rows.items()):
                if old.domain != domain or key in new_keys:
                    continue
                if old.attr("sub_domain_id", 0) != (sub_domain_id or 0):
                    continue         # outside this refresh's scope
                del self._rows[key]
                diff.deleted.append(old)
            for r in snapshot:
                old = self._rows.get((r.type, r.id))
                if old is None:
                    diff.created.append(r)
                elif old != r:
                    diff.updated.append(r)
                self._rows[(r.type, r.id)] = r
            if diff.changed:
                self.version += 1
                self._save()
        if diff.changed:
            for fn in self._subscribers:
                fn(diff)
        return diff
