"""TagRecorder: resource tables -> id->name dimension dictionaries.

Reference: server/controller/tagrecorder/ — ~50 ch_* builders copy MySQL
resource rows into flow_tag dimension tables in every ClickHouse so
queries can dictGet() names for SmartEncoded integer ids. Here each
resource type becomes a persistent IdNameDict the querier consults when
humanizing KnowledgeGraph columns (pod_id_0 -> pod name).

The port's own copy of the JAX package's `controller/tagrecorder.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional

from deepflow_tpu_torch.controller.model import (RESOURCE_TYPES, DomainDiff,
                                                 Resource, ResourceModel)


class IdNameDict:
    """Persistent integer-id -> name map (one resource dimension)."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._map: Dict[int, str] = {}
        self._lock = threading.Lock()
        if path is not None and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        e = json.loads(line)
                        self._map[e["id"]] = e["name"]
                    except ValueError:
                        continue

    def update(self, rows: Iterable[Resource]) -> None:
        with self._lock:
            for r in rows:
                self._map[r.id] = r.name
            self._persist()

    def remove(self, ids: Iterable[int]) -> None:
        with self._lock:
            for i in ids:
                self._map.pop(i, None)
            self._persist()

    def _persist(self) -> None:
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for i, name in self._map.items():
                f.write(json.dumps({"id": i, "name": name}) + "\n")
        os.replace(tmp, self.path)

    def name(self, id: int) -> Optional[str]:
        with self._lock:
            return self._map.get(int(id))

    def ids_for_name(self, name: str) -> List[int]:
        """Reverse lookup for WHERE-by-name (reference: dictGet-joined
        name conditions). Names are not unique across domains, so all
        matching ids come back."""
        with self._lock:
            return [i for i, n in self._map.items() if n == name]

    def snapshot(self) -> Dict[int, str]:
        """One locked copy for bulk lookups (querier humanization)."""
        with self._lock:
            return dict(self._map)

    def __len__(self) -> int:
        return len(self._map)


class TagRecorder:
    """Subscribes to the resource model; keeps one dict per type."""

    def __init__(self, model: ResourceModel,
                 root: Optional[str] = None) -> None:
        self.dicts: Dict[str, IdNameDict] = {}
        for t in RESOURCE_TYPES:
            path = None if root is None else \
                os.path.join(root, "tagrecorder", f"{t}.jsonl")
            if path is not None:
                os.makedirs(os.path.dirname(path), exist_ok=True)
            self.dicts[t] = IdNameDict(path)
        # initial full sync, then incremental via diffs
        for t in RESOURCE_TYPES:
            self.dicts[t].update(model.list(type=t))
        model.subscribe(self.on_diff)

    def on_diff(self, diff: DomainDiff) -> None:
        touched: Dict[str, List[Resource]] = {}
        for r in diff.created + diff.updated:
            touched.setdefault(r.type, []).append(r)
        for t, rows in touched.items():
            self.dicts[t].update(rows)
        removed: Dict[str, List[int]] = {}
        for r in diff.deleted:
            removed.setdefault(r.type, []).append(r.id)
        for t, ids in removed.items():
            self.dicts[t].remove(ids)

    def name(self, resource_type: str, id: int) -> Optional[str]:
        d = self.dicts.get(resource_type)
        return None if d is None else d.name(id)

    # column -> resource type, for querier humanization of KG tags
    COLUMN_TYPES = {
        "region_id": "region", "az_id": "az", "host_id": "host",
        "subnet_id": "subnet", "pod_cluster_id": "pod_cluster",
        "pod_node_id": "pod_node", "pod_ns_id": "pod_ns",
        "pod_group_id": "pod_group", "pod_id": "pod",
        "service_id": "service", "l3_epc_id": "vpc",
        # round-5 model widening (reference: tagrecorder's ch_lb /
        # ch_chost / ch_gprocess / ch_pod_ingress dimension tables)
        "gprocess_id": "process", "chost_id": "vm", "vm_id": "vm",
        "lb_id": "lb", "lb_listener_id": "lb_listener",
        "natgw_id": "nat_gateway", "nat_gateway_id": "nat_gateway",
        "pod_ingress_id": "pod_ingress",
        "pod_service_id": "service",
    }

    def dict_for_column(self, column: str) -> Optional[IdNameDict]:
        base = column
        for suffix in ("_0", "_1"):
            if base.endswith(suffix):
                base = base[:-2]
                break
        t = self.COLUMN_TYPES.get(base)
        return None if t is None else self.dicts.get(t)

    def column_name(self, column: str, id: int) -> Optional[str]:
        d = self.dict_for_column(column)
        return None if d is None else d.name(id)
