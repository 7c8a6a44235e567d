"""Genesis cross-controller exchange.

Reference: server/controller/genesis/ — every agent reports interfaces
to the one controller it syncs with, and controllers share their genesis
sinks with each other so any node can compile the full platform picture
(genesis/sync.go fetches peers' data keyed by vtap/node ownership).

Here each controller exports the genesis domains it heard FIRST-HAND
(`/v1/genesis/export`), and a GenesisSync on every node pulls peers on an
interval and merges their domains into the local model. Ownership guards
the loop: a node never exports a domain it merged from a peer, and never
merges a domain it owns locally — so data flows agent -> owning
controller -> everyone else, exactly once.

The port's own copy of the JAX package's `controller/genesis_sync.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Dict, Iterable, List, Optional

from deepflow_tpu_torch.controller.model import (Resource, ResourceModel,
                                                 make_resource)


class GenesisSync:
    def __init__(self, model: ResourceModel, peers: Iterable[str] = (),
                 interval_s: float = 30.0) -> None:
        self.model = model
        self.peers = list(peers)          # peer controller base URLs
        self.interval_s = interval_s
        self._local_domains: set = set()  # domains heard from agents here
        self._merged_domains: set = set()
        # peer url -> domains last merged from it, so a domain that
        # disappears from a peer's export (agent decommissioned, peer
        # rebuilt) is cleared here instead of living forever
        self._peer_domains: Dict[str, set] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pulls_ok = 0
        self.pulls_failed = 0

    # -- ownership ---------------------------------------------------------
    def mark_local(self, domain: str) -> None:
        """Call when an agent reports this domain first-hand."""
        with self._lock:
            self._local_domains.add(domain)
            self._merged_domains.discard(domain)

    def export(self) -> Dict[str, List[dict]]:
        """{domain: rows} for locally-owned genesis domains only."""
        with self._lock:
            owned = set(self._local_domains)
        out: Dict[str, List[dict]] = {}
        for d in sorted(owned):
            rows = self.model.list(domain=d)
            out[d] = [{"type": r.type, "id": r.id, "name": r.name,
                       **dict(r.attrs)} for r in rows]
        return out

    # -- pulling -----------------------------------------------------------
    def merge(self, domains: Dict[str, List[dict]],
              peer: Optional[str] = None) -> int:
        """Apply a peer's export; returns domains merged. Locally-owned
        domains are never overwritten by a peer's copy. With `peer` set,
        domains previously merged from that peer but absent from this
        export are cleared (the owning agent is gone)."""
        merged = 0
        applied: set = set()
        for domain, rows in domains.items():
            with self._lock:
                if domain in self._local_domains:
                    continue
                self._merged_domains.add(domain)
            applied.add(domain)
            snapshot: List[Resource] = [
                make_resource(r["type"], r["id"], r["name"], domain,
                              **{k: v for k, v in r.items()
                                 if k not in ("type", "id", "name")})
                for r in rows]
            self.model.update_domain(domain, snapshot)
            merged += 1
        if peer is not None:
            with self._lock:
                # a domain that has since failed over to THIS controller
                # (mark_local) is first-hand data now — never clear it
                # just because the old owner stopped exporting it
                stale = (self._peer_domains.get(peer, set()) - applied
                         - self._local_domains)
                self._peer_domains[peer] = applied
                for d in stale:
                    self._merged_domains.discard(d)
            for d in stale:
                self.model.update_domain(d, [])
        return merged

    def pull_once(self) -> int:
        """One round over all peers; returns total domains merged."""
        total = 0
        for peer in self.peers:
            try:
                with urllib.request.urlopen(
                        f"{peer}/v1/genesis/export", timeout=5) as resp:
                    doc = json.load(resp)
                total += self.merge(doc.get("domains", {}), peer=peer)
                self.pulls_ok += 1
            except Exception:
                self.pulls_failed += 1
        return total

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if not self.peers:
            return
        # supervised
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "genesis-sync", self._loop, beat_period_s=self.interval_s)

    def _loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._stop.wait(self.interval_s):
            sup.beat()
            self.pull_once()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)

    def counters(self) -> dict:
        with self._lock:
            return {"local_domains": len(self._local_domains),
                    "merged_domains": len(self._merged_domains),
                    "pulls_ok": self.pulls_ok,
                    "pulls_failed": self.pulls_failed}
