"""Kubernetes apiserver list/watch client: the real protocol.

Reference: agent/src/platform/kubernetes/{api_watcher.rs:90,
resource_watcher.rs} — per-resource watchers that LIST the apiserver
(resourceVersion + `continue` pagination), then hold a WATCH stream
(`?watch=1&resourceVersion=RV`) applying ADDED/MODIFIED/DELETED events
to a local cache, advancing RV on BOOKMARKs, and falling back to a full
re-list when the server expires the version (410 Gone). Unlike a
poll-snapshot lister it has the correct latency/load profile:
steady state is one idle HTTP stream per resource, not a periodic full
dump.

Transport is stdlib urllib over a long-lived chunked response (events
are newline-delimited JSON, exactly what `readline()` yields).
`snapshot()` returns normalized resource-document rows, so the watcher
plugs straight into platform.k8s_watcher as its lister — the
SnapshotWatcher's hash-on-change push to the controller is unchanged.

The tests hold it against a stub apiserver that speaks the protocol:
pagination, event application, bookmark RV advance, and the
410-expired re-list path.

The port's own copy of the JAX package's `agent/k8s_watch.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

# resource plural -> (row type, extractor of extra attrs)
_RESOURCES: Dict[str, str] = {
    "pods": "pod",
    "nodes": "pod_node",
    "namespaces": "pod_ns",
    "services": "service",
}


class _Expired(Exception):
    """The server no longer has our resourceVersion: full re-list."""


def _normalize(resource: str, obj: dict) -> Optional[dict]:
    meta = obj.get("metadata", {})
    name = meta.get("name")
    if not name:
        return None
    row = {"type": _RESOURCES[resource], "name": name}
    ns = meta.get("namespace")
    if ns:
        row["namespace"] = ns
    labels = meta.get("labels")
    if labels:
        row["labels"] = dict(labels)
    status = obj.get("status", {})
    if resource == "pods":
        if status.get("podIP"):
            row["ip"] = status["podIP"]
        node = obj.get("spec", {}).get("nodeName")
        if node:
            row["node"] = node
    elif resource == "nodes":
        for addr in status.get("addresses", ()):
            if addr.get("type") == "InternalIP":
                row["ip"] = addr.get("address")
                break
    elif resource == "services":
        ip = obj.get("spec", {}).get("clusterIP")
        if ip and ip != "None":
            row["ip"] = ip
    return row


class ApiWatcher:
    """One list/watch loop per resource kind, shared object cache."""

    def __init__(self, base_url: str,
                 resources: Tuple[str, ...] = ("pods", "nodes",
                                               "namespaces", "services"),
                 token: Optional[str] = None,
                 watch_timeout_s: int = 60,
                 backoff_s: float = 1.0,
                 list_limit: int = 500,
                 on_change: Optional[Callable[[], None]] = None) -> None:
        unknown = set(resources) - set(_RESOURCES)
        if unknown:
            raise ValueError(f"unknown k8s resources: {sorted(unknown)}")
        self.base_url = base_url.rstrip("/")
        self.resources = resources
        self.token = token
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        self.list_limit = list_limit
        self.on_change = on_change
        self._cache: Dict[str, Dict[str, dict]] = {r: {} for r in resources}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []   # supervisor ThreadHandles
        self.lists = 0
        self.watch_events = 0
        self.relists_410 = 0
        self.errors = 0

    # -- HTTP --------------------------------------------------------------
    def _open(self, resource: str, params: Dict[str, str],
              timeout: float):
        url = (f"{self.base_url}/api/v1/{resource}"
               f"?{urllib.parse.urlencode(params)}")
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(req, timeout=timeout)

    def _key(self, obj: dict) -> str:
        meta = obj.get("metadata", {})
        return meta.get("uid") or \
            f'{meta.get("namespace", "")}/{meta.get("name", "")}'

    # -- protocol ----------------------------------------------------------
    def _list(self, resource: str) -> str:
        """Full list with `continue` pagination; replaces the cache
        atomically and returns the collection resourceVersion."""
        items: List[dict] = []
        params: Dict[str, str] = {"limit": str(self.list_limit)}
        rv = "0"
        while True:
            with self._open(resource, params, timeout=30) as resp:
                body = json.load(resp)
            items.extend(body.get("items", ()))
            meta = body.get("metadata", {})
            rv = meta.get("resourceVersion", rv)
            cont = meta.get("continue")
            if not cont:
                break
            params = {"limit": str(self.list_limit), "continue": cont}
        with self._lock:
            self._cache[resource] = {self._key(o): o for o in items}
            self.lists += 1
        self._notify()
        return rv

    def _watch(self, resource: str, rv: str) -> str:
        """Hold one watch stream, applying events until the server ends
        it (timeoutSeconds); returns the latest resourceVersion."""
        params = {"watch": "1", "resourceVersion": rv,
                  "timeoutSeconds": str(self.watch_timeout_s),
                  "allowWatchBookmarks": "true"}
        with self._open(resource, params,
                        timeout=self.watch_timeout_s + 15) as resp:
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                etype = event.get("type")
                obj = event.get("object", {})
                if etype == "ERROR":
                    if obj.get("code") == 410:
                        raise _Expired()
                    raise OSError(f"watch error: {obj}")
                new_rv = obj.get("metadata", {}).get("resourceVersion")
                if new_rv:
                    rv = new_rv
                if etype == "BOOKMARK":
                    continue
                with self._lock:
                    self.watch_events += 1
                    if etype == "DELETED":
                        self._cache[resource].pop(self._key(obj), None)
                    elif etype in ("ADDED", "MODIFIED"):
                        self._cache[resource][self._key(obj)] = obj
                self._notify()
        return rv

    def _run(self, resource: str) -> None:
        rv: Optional[str] = None
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._list(resource)
                before = self.watch_events
                rv = self._watch(resource, rv)
                # a healthy stream lives ~watch_timeout_s; one that the
                # server closes immediately with no events must not turn
                # into a tight reconnect loop hammering the apiserver
                if self.watch_events == before:
                    self._stop.wait(self.backoff_s)
            except _Expired:
                with self._lock:
                    self.relists_410 += 1
                rv = None
            except (OSError, ValueError, urllib.error.URLError):
                # network/parse trouble: back off, then re-list (the
                # stream position is unknowable after an error)
                with self._lock:
                    self.errors += 1
                rv = None
                self._stop.wait(self.backoff_s)

    def _notify(self) -> None:
        if self.on_change is not None:
            try:
                self.on_change()
            except Exception:
                pass

    # -- public ------------------------------------------------------------
    def start(self) -> None:
        # supervised. deadman off: the watch stream legitimately blocks
        # ~watch_timeout_s between events, which would read permanently
        # stale to the watchdog
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        for r in self.resources:
            t = sup.spawn(f"k8s-watch-{r}",
                          lambda r=r: self._run(r), deadman_s=None)
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.stop()
            t.join(timeout=2)

    def snapshot(self) -> List[dict]:
        """Normalized resource rows from the live cache — the lister
        contract platform.k8s_watcher expects."""
        out: List[dict] = []
        with self._lock:
            for resource in self.resources:
                for obj in self._cache[resource].values():
                    row = _normalize(resource, obj)
                    if row is not None:
                        out.append(row)
        out.sort(key=lambda r: (r["type"], r.get("namespace", ""),
                                r["name"]))
        return out

    def counters(self) -> dict:
        with self._lock:
            cached = {r: len(c) for r, c in self._cache.items()}
        return {"lists": self.lists, "watch_events": self.watch_events,
                "relists_410": self.relists_410, "errors": self.errors,
                "cached": cached}
