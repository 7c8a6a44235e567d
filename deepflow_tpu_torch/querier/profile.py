"""Profile query: folded stacks -> flame-graph tree.

Reference: server/querier/profile/ (service/profile.go GenerateProfile
turns in_process_profile rows into the tree the DeepFlow UI renders).
Here the table's SmartEncoded stack hashes decode through the
profile_stack TagDict back to folded "a;b;c" strings, values aggregate
per node with one pass, and the response is a nested
{name, self_value, total_value, children} tree plus the function-level
totals table (the two shapes profilers consume).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.pipelines.profile import PROFILE_DB, PROFILE_TABLE
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry

ROOT = "root"


class ProfileQuery:
    def __init__(self, store: Store, tag_dicts: TagDictRegistry) -> None:
        self.store = store
        self.stacks = tag_dicts.get("profile_stack")
        self.names = tag_dicts.get("profile_name")

    def _rows(self, app_service: Optional[str], event_type: Optional[str],
              time_range: Optional[Tuple[int, int]]
              ) -> List[Tuple[str, int]]:
        """(folded_stack, value) pairs after filtering + dict decode."""
        try:
            table = self.store.table(PROFILE_DB, PROFILE_TABLE.name)
        except KeyError:
            return []
        cols = table.scan(time_range=time_range)
        sel = np.ones(len(cols["stack"]), np.bool_)
        # read-only lookups: a filter naming an unknown service must not
        # grow the dictionary — it just matches nothing
        if app_service:
            h = self.names.lookup(app_service)
            if h is None:
                return []
            sel &= cols["app_service"] == np.uint32(h)
        if event_type:
            h = self.names.lookup(event_type)
            if h is None:
                return []
            sel &= cols["event_type"] == np.uint32(h)
        stacks = cols["stack"][sel]
        values = cols["value"][sel].astype(np.int64)
        # aggregate per distinct stack hash before decoding: one dict
        # lookup per unique stack, not per row
        uniq, inv = np.unique(stacks, return_inverse=True)
        sums = np.bincount(inv, weights=values.astype(np.float64))
        out = []
        for h, v in zip(uniq.tolist(), sums.tolist()):
            folded = self.stacks.decode(int(h))
            if folded:
                out.append((folded, int(v)))
        return out

    def flame(self, app_service: Optional[str] = None,
              event_type: Optional[str] = None,
              time_range: Optional[Tuple[int, int]] = None) -> dict:
        """Nested flame-graph tree. Every node: {name, self_value,
        total_value, children: [...]}; root totals the whole selection."""
        rows = self._rows(app_service, event_type, time_range)
        root = {"name": ROOT, "self_value": 0, "total_value": 0,
                "children": {}}
        for folded, value in rows:
            node = root
            node["total_value"] += value
            for frame in folded.split(";"):
                child = node["children"].get(frame)
                if child is None:
                    child = {"name": frame, "self_value": 0,
                             "total_value": 0, "children": {}}
                    node["children"][frame] = child
                child["total_value"] += value
                node = child
            node["self_value"] += value

        def freeze(node: dict) -> dict:
            return {
                "name": node["name"],
                "self_value": node["self_value"],
                "total_value": node["total_value"],
                "children": [freeze(c) for c in sorted(
                    node["children"].values(),
                    key=lambda c: -c["total_value"])],
            }

        return freeze(root)

    def top_functions(self, app_service: Optional[str] = None,
                      event_type: Optional[str] = None,
                      time_range: Optional[Tuple[int, int]] = None,
                      limit: int = 50) -> List[dict]:
        """Function-level rollup: self/total value per frame name
        (the 'top' table beside the flame graph)."""
        rows = self._rows(app_service, event_type, time_range)
        self_v: Dict[str, int] = {}
        total_v: Dict[str, int] = {}
        for folded, value in rows:
            frames = folded.split(";")
            for f in set(frames):
                total_v[f] = total_v.get(f, 0) + value
            leaf = frames[-1]
            self_v[leaf] = self_v.get(leaf, 0) + value
        out = [{"name": n, "self_value": self_v.get(n, 0),
                "total_value": t} for n, t in total_v.items()]
        out.sort(key=lambda r: (-r["self_value"], -r["total_value"],
                                r["name"]))
        return out[:limit]
