"""Agent platform sync: interface reports + a k8s watch analogue.

Reference: the agent reports its host's interfaces to genesis
(agent/src/platform/ InterfaceInfo reporting) and, on k8s nodes, watches
the apiserver and streams pod/node/namespace/service state to the
controller (agent/src/platform/kubernetes/api_watcher.rs:90). Both are
re-shaped here as *snapshot watchers*: a pluggable lister produces the
current state, the watcher content-hashes it, and a report goes to the
controller ONLY when the hash moves — the watch semantics (push on
change) without holding an apiserver connection protocol in-tree.

Listers are injectable: `local_interfaces` reads the host's real NICs,
`file_lister` follows a JSON file (e.g. a kubectl export refreshed out
of band), and tests pass plain callables.

The port's own copy of the JAX package's `agent/platform.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import urllib.request
from typing import Callable, List, Optional

from deepflow_tpu_torch.store.dict_store import fnv1a32


def _nic_ipv4(name: str) -> str:
    """Per-NIC IPv4 via SIOCGIFADDR (linux); '' when unassigned."""
    import fcntl
    import struct

    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            packed = fcntl.ioctl(
                s.fileno(), 0x8915,  # SIOCGIFADDR
                struct.pack("256s", name.encode()[:15]))
        return socket.inet_ntoa(packed[20:24])
    except OSError:
        return ""


def local_interfaces() -> List[dict]:
    """Real host NICs, each with ITS OWN IPv4 address (linux /sys walk +
    SIOCGIFADDR); NICs without an address fall back to the hostname's so
    the host still registers."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir("/sys/class/net"))
    except OSError:
        names = []
    try:
        host_ip = socket.gethostbyname(socket.gethostname())
    except OSError:
        host_ip = ""
    for name in names:
        if name == "lo":
            continue
        ip = _nic_ipv4(name) or host_ip
        if ip:
            out.append({"name": name, "ip": ip})
    return out


def libvirt_lister(xml_dir: str = "/etc/libvirt/qemu"
                   ) -> Callable[[], List[dict]]:
    """Follow a libvirt qemu domain-XML directory and report each VM's
    virtual interfaces (reference:
    agent/src/platform/libvirt_xml_extractor.rs — on KVM hosts the
    agent learns guest NICs from the domain definitions, no guest agent
    needed). Per interface: the target dev name, mac, and the owning
    domain's name/uuid. Files that fail to parse are skipped (a
    half-written definition mid-virsh-edit must not drop the report);
    interfaces without a mac are skipped like the reference's."""
    import xml.etree.ElementTree as ET

    def lister() -> List[dict]:
        out: List[dict] = []
        try:
            names = sorted(os.listdir(xml_dir))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".xml"):
                continue
            try:
                root = ET.parse(os.path.join(xml_dir, fn)).getroot()
            except (ET.ParseError, OSError):
                continue
            domain_name = root.findtext("name") or ""
            domain_uuid = root.findtext("uuid") or ""
            if not domain_name or not domain_uuid:
                continue
            for itf in root.findall("devices/interface"):
                mac_el = itf.find("mac")
                tgt_el = itf.find("target")
                mac = (mac_el.get("address", "")
                       if mac_el is not None else "")
                dev = (tgt_el.get("dev", "")
                       if tgt_el is not None else "")
                if not mac:
                    continue
                # PERSISTENT domain XML strips auto-generated vnetX
                # <target dev> names on save — only runtime XML keeps
                # them. The mac is the durable key (the reference keys
                # on it too); a mac-derived name keeps the row usable
                # when dev is absent.
                if not dev:
                    dev = "tap-" + mac.replace(":", "")[-6:]
                out.append({"name": dev, "mac": mac,
                            "domain_name": domain_name,
                            "domain_uuid": domain_uuid})
        return out
    return lister


def file_lister(path: str) -> Callable[[], List[dict]]:
    """Follow a JSON file holding a resource list (kubectl-export style);
    missing/invalid file reads as empty, not fatal."""
    def lister() -> List[dict]:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return []
        return doc if isinstance(doc, list) else doc.get("resources", [])
    return lister


class SnapshotWatcher:
    """Push-on-change watcher: lister() -> content hash -> report_fn.

    `poll_once()` returns True when a report went out. The thread form
    (`start`/`close`) polls on `interval_s`; report failures keep the old
    hash so the next tick retries (at-least-once toward the controller).
    """

    def __init__(self, lister: Callable[[], List[dict]],
                 report_fn: Callable[[List[dict]], bool],
                 interval_s: float = 30.0) -> None:
        self.lister = lister
        self.report_fn = report_fn
        self.interval_s = interval_s
        self._last_hash: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reports = 0
        self.report_errors = 0

    def poll_once(self) -> bool:
        snapshot = self.lister()
        h = fnv1a32(json.dumps(snapshot, sort_keys=True).encode())
        if h == self._last_hash:
            return False
        if self.report_fn(snapshot):
            self._last_hash = h
            self.reports += 1
            return True
        self.report_errors += 1
        return False

    def start(self) -> None:
        # supervised: a raising lister /
        # report hook is crash-captured and restarted with backoff
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "platform-watch", self._loop, beat_period_s=self.interval_s)

    def _loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        self.poll_once()
        while not self._stop.wait(self.interval_s):
            sup.beat()
            self.poll_once()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)

    def counters(self) -> dict:
        return {"reports": self.reports,
                "report_errors": self.report_errors}


def _post_json(url: str, body: dict) -> bool:
    try:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5):
            return True
    except Exception:
        return False


def interface_reporter(controller_url: str, host: str, ctrl_ip: str,
                       lister: Optional[Callable[[], List[dict]]] = None,
                       interval_s: float = 60.0) -> SnapshotWatcher:
    """Genesis interface report on change (reference: platform report)."""
    def report(snapshot: List[dict]) -> bool:
        return _post_json(f"{controller_url}/v1/genesis",
                          {"ctrl_ip": ctrl_ip, "host": host,
                           "interfaces": snapshot})
    return SnapshotWatcher(lister or local_interfaces, report, interval_s)


def k8s_watcher(controller_url: str, cluster_domain: str,
                lister: Callable[[], List[dict]],
                interval_s: float = 30.0) -> SnapshotWatcher:
    """api_watcher analogue: pod/node/ns/service snapshots -> the domain
    resource endpoint, pushed only when the cluster state changes."""
    def report(snapshot: List[dict]) -> bool:
        return _post_json(
            f"{controller_url}/v1/domains/{cluster_domain}/resources",
            {"resources": snapshot})
    return SnapshotWatcher(lister, report, interval_s)
