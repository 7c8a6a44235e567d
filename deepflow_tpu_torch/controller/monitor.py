"""Fleet monitor: vtap liveness + agent->ingester rebalancing.

Reference: server/controller/monitor/ — marks agents offline when their
sync heartbeats stop and rebalances agents across analyzer (ingester)
replicas. Rebalancing here is rendezvous hashing: each agent reports to
the ingester with the highest hash(agent, ingester) weight, so adding or
removing one ingester moves only its own share of agents.

The port's own copy of the JAX package's `controller/monitor.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

from deepflow_tpu_torch.controller.registry import VTapRegistry


def _weight(vtap_key: str, ingester: str) -> int:
    h = hashlib.blake2s(f"{vtap_key}|{ingester}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


class FleetMonitor:
    def __init__(self, registry: VTapRegistry,
                 offline_after_s: float = 120.0) -> None:
        self.registry = registry
        self.offline_after_s = offline_after_s
        self._ingesters: List[str] = []
        self._lock = threading.Lock()

    # -- ingester membership ----------------------------------------------
    def set_ingesters(self, addrs: List[str]) -> None:
        with self._lock:
            self._ingesters = sorted(addrs)

    def ingesters(self) -> List[str]:
        with self._lock:
            return list(self._ingesters)

    # -- assignment --------------------------------------------------------
    def assign(self, ctrl_ip: str, host: str) -> Optional[str]:
        """The ingester this agent should ship its firehose to."""
        with self._lock:
            if not self._ingesters:
                return None
            key = f"{ctrl_ip}|{host}"
            return max(self._ingesters, key=lambda a: _weight(key, a))

    def assignments(self) -> Dict[str, List[str]]:
        with self._lock:
            ingesters = list(self._ingesters)  # one consistent snapshot
        out: Dict[str, List[str]] = {a: [] for a in ingesters}
        if not ingesters:
            return out
        for vt in self.registry.list():
            key = f"{vt.ctrl_ip}|{vt.host}"
            a = max(ingesters, key=lambda addr: _weight(key, addr))
            out[a].append(key)
        return out

    # -- liveness ----------------------------------------------------------
    def check(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        now = time.time() if now is None else now
        alive, offline = [], []
        for vt in self.registry.list():
            key = f"{vt.ctrl_ip}|{vt.host}"
            if now - vt.last_seen > self.offline_after_s:
                offline.append(key)
            else:
                alive.append(key)
        return {"alive": alive, "offline": offline}
