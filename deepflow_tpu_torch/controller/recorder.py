"""Recorder: per-resource reconciliation engines over the ResourceModel.

Reference: server/controller/recorder/ — per-type updaters
(recorder/updater/pod.go:144 generateUpdateInfo field diffs), ordered
refresh (regions before azs before hosts...), lcuuid link checks, and
soft-delete cleanup. The deepflow_tpu_torch model keeps whole-snapshot
reconciliation (update_domain), and this layer adds what the reference's
updater fleet adds on top:

- dependency-aware validation: a row whose parent link points at a
  resource that exists in neither the snapshot nor the model is
  quarantined and counted (cascading: a quarantined parent orphans its
  children), so one orphan can't poison the platform-data compile; an
  already-known resource with a transiently bad link is held at its
  last-good state instead of deleted;
- field-level update info: each updated resource reports exactly which
  attrs changed (old -> new), the recorder/pubsub message shape;
- creation ordering: created/deleted lists come back parent-types-first /
  children-first respectively, so subscribers that mirror into ordered
  stores never see a child before its parent;
- soft delete: deleted rows become tombstones retained for
  `retention_s`, the reference's deleted_at + cleaner discipline.

The port's own copy of the JAX package's `controller/recorder.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from deepflow_tpu_torch.controller.model import (RESOURCE_TYPES, DomainDiff,
                                                 Resource, ResourceModel)

# child attr -> parent type links (reference: recorder/updater per-type
# lcuuid-to-id lookups — lb.go resolves vpc, lb_listener.go resolves
# lb, pod_ingress_rule_backend.go resolves rule + ingress, ...).
# 0 / missing attr = no link claimed (many links are optional in the
# reference too: a floating ip may not be bound to a vm yet).
PARENT_LINKS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "az": (("region_id", "region"),),
    "host": (("az_id", "az"),),
    "vm": (("host_id", "host"), ("vpc_id", "vpc")),
    "subnet": (("vpc_id", "vpc"),),
    "vrouter": (("vpc_id", "vpc"),),
    "routing_table": (("vrouter_id", "vrouter"),),
    "vinterface": (("subnet_id", "subnet"),),
    "wan_ip": (("vinterface_id", "vinterface"),),
    "lan_ip": (("vinterface_id", "vinterface"),),
    "floating_ip": (("vpc_id", "vpc"), ("vm_id", "vm"),
                    ("nat_gateway_id", "nat_gateway")),
    "security_group_rule": (("security_group_id", "security_group"),),
    "nat_gateway": (("vpc_id", "vpc"),),
    "nat_rule": (("nat_gateway_id", "nat_gateway"),),
    "nat_vm_connection": (("nat_gateway_id", "nat_gateway"),
                          ("vm_id", "vm")),
    "lb": (("vpc_id", "vpc"),),
    "lb_listener": (("lb_id", "lb"),),
    "lb_target_server": (("lb_id", "lb"),
                         ("lb_listener_id", "lb_listener")),
    "lb_vm_connection": (("lb_id", "lb"), ("vm_id", "vm")),
    "rds_instance": (("vpc_id", "vpc"),),
    "redis_instance": (("vpc_id", "vpc"),),
    "pod_node": (("pod_cluster_id", "pod_cluster"),),
    "vm_pod_node_connection": (("vm_id", "vm"),
                               ("pod_node_id", "pod_node")),
    "pod_ns": (("pod_cluster_id", "pod_cluster"),),
    "pod_ingress": (("pod_ns_id", "pod_ns"),),
    "pod_ingress_rule": (("pod_ingress_id", "pod_ingress"),),
    "pod_ingress_rule_backend": (
        ("pod_ingress_rule_id", "pod_ingress_rule"),),
    "service": (("vpc_id", "vpc"),),
    "pod_service_port": (("service_id", "service"),),
    "pod_group": (("pod_ns_id", "pod_ns"),),
    "pod_group_port": (("pod_group_id", "pod_group"),
                       ("service_id", "service")),
    "pod_replica_set": (("pod_group_id", "pod_group"),),
    "pod": (("pod_ns_id", "pod_ns"), ("pod_node_id", "pod_node"),
            ("pod_group_id", "pod_group")),
    "process": (("pod_id", "pod"), ("vm_id", "vm")),
}

# every type may additionally claim sub-domain membership (reference:
# each mysql model carries sub_domain lcuuid; cloud/sub_domain.go owns
# those rows' lifecycle) — validated like any other parent link
_SUB_DOMAIN_LINK = ("sub_domain_id", "sub_domain")

_TYPE_ORDER = {t: i for i, t in enumerate(RESOURCE_TYPES)}


@dataclass(frozen=True)
class FieldChange:
    """One changed attr of one updated resource (reference:
    message.PodFieldsUpdate and friends)."""

    type: str
    id: int
    field: str
    old: object
    new: object


@dataclass
class RecorderDiff:
    created: List[Resource] = field(default_factory=list)
    deleted: List[Resource] = field(default_factory=list)
    updated: List[Resource] = field(default_factory=list)
    field_changes: List[FieldChange] = field(default_factory=list)
    orphaned: List[Resource] = field(default_factory=list)

    @property
    def changed(self) -> bool:
        return bool(self.created or self.deleted or self.updated)


class Recorder:
    """Validated, ordered, field-diffed reconciliation for one model."""

    def __init__(self, model: ResourceModel,
                 retention_s: float = 24 * 3600.0) -> None:
        self.model = model
        self.retention_s = retention_s
        # reconcile is validate-then-apply over shared state; the HTTP
        # server is threaded, so the pair must be atomic or two racing
        # snapshots can bypass the cross-domain ownership check
        self._lock = threading.RLock()
        # (type, id) -> (resource, deleted_at)
        self._tombstones: Dict[Tuple[str, int], Tuple[Resource, float]] = {}
        self.orphans_total = 0

    # -- validation --------------------------------------------------------
    def _validate(self, domain: str, snapshot: List[Resource]
                  ) -> Tuple[List[Resource], List[Resource]]:
        """(accepted, orphaned). Duplicate (type, id), unknown type, or an
        id already owned by ANOTHER domain raises — malformed snapshots
        fail whole, before any model mutation (no half-applied state)."""
        seen = set()
        for r in snapshot:
            if r.type not in RESOURCE_TYPES:
                raise ValueError(f"unknown resource type {r.type!r}")
            key = (r.type, r.id)
            if key in seen:
                raise ValueError(f"duplicate resource {key} in snapshot")
            seen.add(key)
            old = self.model.get(r.type, r.id)
            if old is not None and old.domain != domain:
                raise ValueError(
                    f"resource {key} is owned by domain {old.domain!r}")
        model_known = {(r.type, r.id) for r in self.model.list()}
        accepted = list(snapshot)
        orphaned: List[Resource] = []
        # fixpoint: quarantining a parent orphans its children too — keep
        # sweeping until no row's link resolves against a quarantined row
        while True:
            known = model_known | {(r.type, r.id) for r in accepted}
            known -= {(r.type, r.id) for r in orphaned}
            still, newly = [], []
            for r in accepted:
                ok = True
                links = PARENT_LINKS.get(r.type, ())
                if r.type != "sub_domain":
                    links = links + (_SUB_DOMAIN_LINK,)
                for attr, parent_type in links:
                    pid = r.attr(attr, 0)
                    if pid and (parent_type, pid) not in known:
                        ok = False
                        break
                (still if ok else newly).append(r)
            if not newly:
                break
            orphaned += newly
            accepted = still
        # a quarantined row that already exists keeps its last-good state:
        # one transiently bad parent field must not DELETE the resource
        for r in orphaned:
            old = self.model.get(r.type, r.id)
            if old is not None:
                accepted.append(old)
        return accepted, orphaned

    # -- reconciliation ----------------------------------------------------
    def reconcile(self, domain: str, snapshot: List[Resource],
                  now: Optional[float] = None) -> RecorderDiff:
        with self._lock:
            return self._reconcile_locked(domain, snapshot, now, None)

    def reconcile_sub_domain(self, domain: str, sub_domain_id: int,
                             snapshot: List[Resource],
                             now: Optional[float] = None
                             ) -> RecorderDiff:
        """Refresh ONE attached k8s cluster inside a cloud domain
        (reference: cloud/sub_domain.go + the recorder's sub_domain-
        scoped updaters): deletions are bounded to rows carrying this
        sub_domain_id, so a sub-domain poller can never erase the
        owning domain's resources — and vice versa."""
        for r in snapshot:
            if r.attr("sub_domain_id", 0) != sub_domain_id:
                raise ValueError(
                    f"resource {(r.type, r.id)} does not carry "
                    f"sub_domain_id={sub_domain_id}")
        with self._lock:
            return self._reconcile_locked(domain, snapshot, now,
                                          sub_domain_id)

    def _reconcile_locked(self, domain: str, snapshot: List[Resource],
                          now: Optional[float],
                          sub_domain_id: Optional[int]) -> RecorderDiff:
        now = time.time() if now is None else now
        accepted, orphaned = self._validate(domain, snapshot)
        self.orphans_total += len(orphaned)
        olds = {(r.type, r.id): r for r in self.model.list(domain=domain)}
        diff = self.model.update_domain(domain, accepted,
                                        sub_domain_id=sub_domain_id)
        out = RecorderDiff(
            created=sorted(diff.created,
                           key=lambda r: (_TYPE_ORDER[r.type], r.id)),
            deleted=sorted(diff.deleted,
                           key=lambda r: (-_TYPE_ORDER[r.type], r.id)),
            updated=diff.updated,
            orphaned=orphaned,
        )
        for r in out.updated:
            old = olds[(r.type, r.id)]
            if old.name != r.name:
                out.field_changes.append(
                    FieldChange(r.type, r.id, "name", old.name, r.name))
            oa, na = dict(old.attrs), dict(r.attrs)
            for k in sorted(set(oa) | set(na)):
                if oa.get(k) != na.get(k):
                    out.field_changes.append(
                        FieldChange(r.type, r.id, k, oa.get(k), na.get(k)))
        for r in out.deleted:
            self._tombstones[(r.type, r.id)] = (r, now)
        for r in out.created:
            self._tombstones.pop((r.type, r.id), None)
        self.cleanup(now=now)
        return out

    # -- tombstones --------------------------------------------------------
    def deleted_resources(self) -> List[Resource]:
        """Soft-deleted rows still within retention (reference: the
        deleted_at-marked rows the cleaner hasn't purged)."""
        with self._lock:
            return [r for r, _ in self._tombstones.values()]

    def cleanup(self, now: Optional[float] = None) -> int:
        """Purge tombstones past retention; returns purged count."""
        now = time.time() if now is None else now
        with self._lock:
            dead = [k for k, (_, t) in self._tombstones.items()
                    if now - t >= self.retention_s]
            for k in dead:
                del self._tombstones[k]
        return len(dead)

    def counters(self) -> dict:
        return {"tombstones": len(self._tombstones),
                "orphans_total": self.orphans_total,
                "model_version": self.model.version}
