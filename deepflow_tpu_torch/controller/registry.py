"""VTap (agent) registry + group config distribution.

Reference: server/controller/trisolaris/ — agents call Synchronizer.Sync
with (ctrl_ip, ctrl_mac, host); the controller matches/creates a vtap row,
assigns vtap_id, and returns the group's RuntimeConfig plus the platform
data version so the agent knows when to re-pull. Group configs are the
yaml documents deepflow-ctl agent-group-config CRUDs.

The port's own copy of the JAX package's `controller/registry.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_CONFIG = {
    # trimmed mirror of the reference RuntimeConfig defaults
    # (agent/src/config/handler.rs; trident.proto Config)
    "max_cpus": 1,
    "max_memory_mb": 768,
    "sync_interval_s": 60,
    "stats_interval_s": 10,
    "log_threshold": 300,
    "l4_log_tap_types": [0],
    "l7_log_enabled": True,
    "capture_bpf": "",
    "max_collect_pps": 200_000,
    "throttle_per_s": 50_000,
    # agent-side L7 session cap/s (l7_log_collect_nps_threshold role)
    "l7_log_rate": 10_000,
    # l4 flow-log aggregation interval (flow_aggr role); 0 = every tick
    "l4_log_aggr_s": 0,
    # L7 parser plugins: None = "not managed by this group" (agents
    # keep their static sets); a LIST is authoritative and the agent
    # hot-converges to exactly it (Agent._sync_*_plugins)
    "so_plugins": None,
    "wasm_plugins": None,
    # trace-context header extraction (agent/trace_context.py): ordered
    # key lists (or the reference's comma-joined string form); None =
    # not managed by this group
    "http_log_trace_id": None,
    "http_log_span_id": None,
    "http_log_x_request_id": None,
    "http_log_proxy_client": None,
    # round-5 Config widening (reference trident.proto:185-289):
    # capture surface + resource limits + l7 sizes. None = unmanaged
    # (the agent keeps its own default; the gRPC bridge leaves the
    # proto2 default in place)
    "tap_interface_regex": None,
    "extra_netns_regex": None,
    "tap_mode": None,              # 0 LOCAL / 1 MIRROR / 2 ANALYZER
    "mtu": None,
    "output_vlan": None,
    "max_npb_bps": None,
    "capture_packet_size": None,
    "l7_log_packet_size": None,
    "log_level": None,
    "thread_threshold": None,
    "process_threshold": None,
    "log_retention_days": None,
    "ntp_enabled": None,
    "platform_enabled": None,
    "kubernetes_api_enabled": None,
    "l4_performance_enabled": None,
    "l7_metrics_enabled": None,
    "region_id": None,
    "epc_id": None,
    "pod_cluster_id": None,
    # pushed policy (reference FlowAcl push): list of FlowAcl dicts
    # {id, tap_type, protocol, src_ports, dst_ports, npb_actions:
    # [{tunnel_type, tunnel_id, tunnel_ip, payload_slice}]} + a
    # monotonic version; None = policy not managed by this group
    "flow_acls": None,
    "acl_version": 0,
}


@dataclass
class VTap:
    vtap_id: int
    ctrl_ip: str
    host: str
    ctrl_mac: str = ""
    group: str = "default"
    created_at: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.time)
    revision: str = ""
    boot_count: int = 0

    @property
    def alive(self) -> bool:
        return time.time() - self.last_seen < 120


class VTapRegistry:
    """Assigns vtap ids, tracks liveness, versions group configs."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._vtaps: Dict[str, VTap] = {}      # key = ctrl_ip|host
        self._configs: Dict[str, dict] = {"default": dict(DEFAULT_CONFIG)}
        self.config_version = 1
        self._next_id = 1
        # global process ids (reference: trisolaris GPIDSync /
        # process_info.go): stable allocation keyed (vtap, pid,
        # start_time) — a pid reused after process exit gets a FRESH
        # global id because its start_time differs
        self._gpids: Dict[str, int] = {}
        self._next_gpid = 1
        self._cluster_ids: Dict[str, str] = {}   # ca_md5 -> cluster id
        # staged fleet upgrade (reference: trident.proto rpc Upgrade):
        # per-group target revision + package checksum; at most
        # max_concurrent agents hold an in-flight upgrade offer
        self._upgrades: Dict[str, dict] = {}
        self._upgrading: Dict[str, float] = {}   # vtap key -> 1st offer
        # vtap key -> [attempt count, last bump ts]: attempts accrue at
        # most once per upgrade_attempt_interval_s, so a 5s Push poll
        # and a 60s Sync cadence burn budget at the SAME rate — and a
        # wedged push-mode agent still reaches quarantine
        self._upgrade_attempts: Dict[str, list] = {}
        self._upgrade_failed: set = set()        # quarantined vtap keys
        self.upgrade_max_concurrent = 1
        self.upgrade_max_attempts = 5
        self.upgrade_attempt_interval_s = 60.0
        self._lock = threading.Lock()
        if path is not None and os.path.exists(path):
            self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        with open(self.path) as f:
            doc = json.load(f)
        self._next_id = doc["next_id"]
        self.config_version = doc.get("config_version", 1)
        self._configs = doc.get("configs", self._configs)
        self._gpids = doc.get("gpids", {})
        self._next_gpid = doc.get("next_gpid", 1)
        self._cluster_ids = doc.get("cluster_ids", {})
        self._upgrades = doc.get("upgrades", {})
        for v in doc.get("vtaps", []):
            vt = VTap(**v)
            self._vtaps[f"{vt.ctrl_ip}|{vt.host}"] = vt

    def _save_locked(self) -> None:
        if self.path is None:
            return
        doc = {
            "next_id": self._next_id,
            "config_version": self.config_version,
            "configs": self._configs,
            "gpids": self._gpids,
            "next_gpid": self._next_gpid,
            "cluster_ids": self._cluster_ids,
            "upgrades": self._upgrades,
            "vtaps": [vars(v) for v in self._vtaps.values()],
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    # -- sync (the agent-facing RPC) ---------------------------------------
    def sync(self, ctrl_ip: str, host: str, revision: str = "",
             boot: bool = False,
             processes: Optional[list] = None,
             ctrl_mac: str = "") -> dict:
        """Register-or-refresh; returns the Sync response body
        (reference: trisolaris synchronize service Sync; the GPIDSync
        rpc is folded in via `processes`, and the Upgrade stream's
        "here is your target package" leg rides the response)."""
        key = f"{ctrl_ip}|{host}"
        with self._lock:
            vt = self._vtaps.get(key)
            registered = vt is None
            if vt is None:
                vt = VTap(vtap_id=self._next_id, ctrl_ip=ctrl_ip, host=host)
                self._next_id += 1
                self._vtaps[key] = vt
            vt.last_seen = time.time()
            vt.revision = revision
            mac_changed = bool(ctrl_mac) and vt.ctrl_mac != ctrl_mac
            if mac_changed:
                # recorded so mac-keyed rpcs (Upgrade carries only
                # ctrl_ip+ctrl_mac) can disambiguate two hosts that
                # share a ctrl_ip (NAT / host-network pods); persisted
                # NOW — a restart before the next dirty event must not
                # forget it (the mac match would silently fall back)
                vt.ctrl_mac = ctrl_mac
            if boot:
                vt.boot_count += 1
            cfg = self._configs.get(vt.group,
                                    self._configs["default"])
            dirty = registered or boot or mac_changed
            resp = {
                "vtap_id": vt.vtap_id,
                "group": vt.group,
                "config": cfg,
                "config_version": self.config_version,
                # controller wall clock (ns): the agent derives its NTP
                # offset from this (reference: Synchronizer.NTP — a
                # dedicated rpc there; piggybacked on Sync here since
                # the round trip is the same)
                "server_time_ns": time.time_ns(),
            }
            if processes:
                resp["gpids"], allocated = self._gpid_sync_locked(
                    vt.vtap_id, processes)
                dirty = dirty or allocated
            upgrade = self._upgrade_offer_locked(key, vt)
            if upgrade is not None:
                resp["upgrade"] = upgrade
            if dirty:
                self._save_locked()
            return resp

    # -- GPIDSync ----------------------------------------------------------
    def _gpid_sync_locked(self, vtap_id: int,
                          processes: list) -> tuple:
        """(pid -> gprocess_id mapping, any_new_allocations). Keyed
        (vtap, pid, start_time): ids are global across the fleet and
        stable across agent restarts (persisted).

        start_time == 0 means UNKNOWN (the gRPC GPIDSyncEntry carries
        no start_time): an unknown-start entry reuses any existing
        allocation for the same (vtap, pid), and a later concrete
        start_time ADOPTS a pending 0-key rather than allocating a
        second id — so the JSON and gRPC control-plane paths can never
        hand the same live process two different global ids. The cost,
        documented: a pid reused after process exit keeps its old gpid
        when only the gRPC path ever sees it."""
        out: Dict[str, int] = {}
        allocated = False
        # per-(vtap,pid) index for the unknown-start reuse branch —
        # built LAZILY on the first start==0 entry (the common JSON
        # path, all-concrete start_times, must not pay an O(fleet
        # gpids) scan under the registry lock per sync), and kept in
        # lockstep with _gpids mutations below so a processes list
        # mixing concrete and unknown entries for one pid can't read
        # a stale view
        by_pid: Optional[Dict[int, list]] = None

        def _index() -> Dict[int, list]:
            nonlocal by_pid
            if by_pid is None:
                by_pid = {}
                prefix = f"{vtap_id}|"
                for key in self._gpids:
                    if key.startswith(prefix):
                        _, pid_s, start_s = key.split("|")
                        by_pid.setdefault(int(pid_s),
                                          []).append(int(start_s))
            return by_pid

        for p in processes[:4096]:               # bounded: hostile sync
            try:
                pid = int(p["pid"])
                start = int(p.get("start_time", 0))
            except (KeyError, TypeError, ValueError):
                continue
            k = f"{vtap_id}|{pid}|{start}"
            g = self._gpids.get(k)
            if g is None and start == 0:
                starts = _index().get(pid)
                if starts:
                    # unknown start: reuse the newest concrete
                    # allocation (0 can't be in the index here — the
                    # direct get(k) above would have found it, and
                    # adoption removes popped 0-keys from the index)
                    g = self._gpids[f"{vtap_id}|{pid}|{max(starts)}"]
            elif g is None and start != 0:
                k0 = f"{vtap_id}|{pid}|0"
                g0 = self._gpids.pop(k0, None)
                if g0 is not None:       # adopt the pending unknown-key
                    self._gpids[k] = g0
                    g = g0
                    allocated = True     # map changed: persist it
                    if by_pid is not None and pid in by_pid:
                        by_pid[pid] = [s for s in by_pid[pid] if s != 0]
                        by_pid[pid].append(start)
            if g is None:
                g = self._next_gpid
                self._next_gpid += 1
                self._gpids[k] = g
                if by_pid is not None:
                    by_pid.setdefault(pid, []).append(start)
                allocated = True
            out[str(pid)] = g
        return out, allocated

    def gpid_batch(self, vtap_id: int, pids) -> Dict[int, int]:
        """pid -> gprocess id for a whole request at once (the gRPC
        GPIDSync path): ONE lock hold and at most ONE registry save per
        request, not per pid — a first sync carrying N processes must
        not serialize the registry 2N times. pid 0 maps to 0. Requests
        beyond _gpid_sync_locked's per-call bound are chunked, so a
        host with >4096 processes maps every pid instead of KeyErroring
        the rpc."""
        want = sorted({int(p) for p in pids if p})
        got: Dict[int, int] = {0: 0}
        with self._lock:
            any_alloc = False
            for i in range(0, len(want), 4096):
                out, allocated = self._gpid_sync_locked(
                    vtap_id, [{"pid": p, "start_time": 0}
                              for p in want[i:i + 4096]])
                any_alloc = any_alloc or allocated
                got.update((int(k), v) for k, v in out.items())
            if any_alloc:
                self._save_locked()
        return got

    # -- staged upgrade ----------------------------------------------------
    def set_upgrade(self, group: str, revision: str, package_name: str,
                    sha256: str) -> None:
        """Target a group at a new agent package (reference: ctl agent
        upgrade + rpc Upgrade). Agents converge one at a time
        (upgrade_max_concurrent) as they sync. Re-targeting resets the
        attempt/quarantine bookkeeping — a fresh package deserves fresh
        tries."""
        with self._lock:
            self._upgrades[group] = {"revision": revision,
                                     "package": package_name,
                                     "sha256": sha256}
            self._upgrade_attempts.clear()
            self._upgrade_failed.clear()
            self._upgrading.clear()
            self._save_locked()

    def cluster_id_for(self, ca_md5: str,
                       name: str = "") -> str:
        """Stable kubernetes cluster id keyed by the cluster CA's md5
        (reference: trisolaris kubernetes_cluster allocation) —
        persisted so every agent of one cluster converges on one id
        across controller restarts. The reported cluster name is
        recorded alongside (ops listing; latest report wins)."""
        from deepflow_tpu_torch.store.dict_store import fnv1a32
        with self._lock:
            rec = self._cluster_ids.get(ca_md5)
            if rec is None:
                rec = {"id": (f"d-{fnv1a32(ca_md5.encode()):08x}"
                              f"{len(self._cluster_ids):04x}"),
                       "name": name}
                self._cluster_ids[ca_md5] = rec
                self._save_locked()
            elif name and rec.get("name") != name:
                rec["name"] = name
                self._save_locked()
            return rec["id"]

    def upgrade_target(self, group: str) -> Optional[dict]:
        """The group's current upgrade target (revision/package/sha256)
        or None — the public read the gRPC Upgrade stream keys off."""
        with self._lock:
            tgt = self._upgrades.get(group)
            return dict(tgt) if tgt else None

    def clear_upgrade(self, group: str) -> bool:
        with self._lock:
            had = self._upgrades.pop(group, None) is not None
            if had:
                self._save_locked()
            return had

    def upgrade_status(self) -> dict:
        with self._lock:
            per_group: Dict[str, dict] = {}
            for group, tgt in self._upgrades.items():
                vts = [v for v in self._vtaps.values() if v.group == group]
                done = [v.host for v in vts if v.revision == tgt["revision"]]
                pending = [v.host for v in vts
                           if v.revision != tgt["revision"]]
                per_group[group] = {**tgt, "done": done,
                                    "pending": pending}
            return {"targets": per_group,
                    "in_flight": sorted(self._upgrading),
                    "failed": sorted(self._upgrade_failed)}

    def _upgrade_offer_locked(self, key: str,
                              vt: VTap) -> Optional[dict]:
        tgt = self._upgrades.get(vt.group)
        if tgt is None or vt.revision == tgt["revision"]:
            # converged (or no target): release any bookkeeping
            self._upgrading.pop(key, None)
            self._upgrade_attempts.pop(key, None)
            self._upgrade_failed.discard(key)
            return None
        if key in self._upgrade_failed:
            return None          # quarantined: operator sees it in status
        now = time.time()
        # reclaim slots from agents that went quiet mid-upgrade (crash
        # during restart): a wedged agent must not block the fleet.
        # First-offer timestamps are NOT refreshed on re-offer, so an
        # agent that keeps syncing but keeps failing also ages out.
        stale = [k for k, t in self._upgrading.items() if now - t > 600]
        for k in stale:
            del self._upgrading[k]
        if key not in self._upgrading and \
                len(self._upgrading) >= self.upgrade_max_concurrent:
            return None                      # wait: staged, not thundering
        rec = self._upgrade_attempts.setdefault(key, [0, 0.0])
        if now - rec[1] >= self.upgrade_attempt_interval_s:
            rec[0] += 1
            rec[1] = now
        if rec[0] > self.upgrade_max_attempts:
            # an agent that was offered N times and never converged is
            # broken (bad fetch path, checksum, staging dir): quarantine
            # it and FREE the slot so one sick agent can't stall the
            # whole fleet rollout
            self._upgrade_failed.add(key)
            self._upgrading.pop(key, None)
            return None
        self._upgrading.setdefault(key, now)
        return dict(tgt)

    # -- fleet management --------------------------------------------------
    def list(self) -> List[VTap]:
        with self._lock:
            return list(self._vtaps.values())

    def set_group(self, ctrl_ip: str, host: str, group: str) -> None:
        with self._lock:
            vt = self._vtaps[f"{ctrl_ip}|{host}"]
            vt.group = group
            self._save_locked()

    def get_config(self, group: str = "default") -> dict:
        with self._lock:
            return dict(self._configs.get(group, self._configs["default"]))

    def set_config(self, group: str, config: dict) -> int:
        """CRUD for group configs (reference: cli agent-group-config).
        Unknown keys are rejected so typos don't silently no-op."""
        bad = set(config) - set(DEFAULT_CONFIG)
        if bad:
            raise ValueError(f"unknown config keys: {sorted(bad)}")
        for key in ("so_plugins", "wasm_plugins"):
            v = config.get(key)
            if v is None:
                continue
            # a bare string would be iterated character-by-character by
            # the agent's converge loop, unloading every plugin
            if not (isinstance(v, list)
                    and all(isinstance(p, str) for p in v)):
                raise ValueError(
                    f"{key} must be a list of paths (or null)")
        for key in ("http_log_trace_id", "http_log_span_id",
                    "http_log_x_request_id", "http_log_proxy_client"):
            v = config.get(key)
            if v is None:
                continue
            # an int/bool here would raise inside the agent's hot-apply
            # EVERY sync round, wedging the whole config push — reject
            # at the API boundary like the plugin lists
            if not (isinstance(v, str)
                    or (isinstance(v, list)
                        and all(isinstance(s, str) for s in v))):
                raise ValueError(f"{key} must be a string, a list of "
                                 f"strings, or null")
        # round-5 knobs: same boundary discipline — a bad type/value
        # would raise inside the gRPC bridge's proto mapping on EVERY
        # Sync/Push for the group (agents then get an RPC error instead
        # of any config at all)
        for key in ("mtu", "output_vlan", "max_npb_bps",
                    "capture_packet_size", "l7_log_packet_size",
                    "log_threshold", "thread_threshold",
                    "process_threshold", "log_retention_days",
                    "region_id", "epc_id", "pod_cluster_id",
                    "acl_version"):
            v = config.get(key)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 0):
                raise ValueError(f"{key} must be a non-negative "
                                 f"integer or null")
        for key in ("ntp_enabled", "platform_enabled",
                    "kubernetes_api_enabled", "l4_performance_enabled",
                    "l7_metrics_enabled"):
            v = config.get(key)
            if v is not None and not isinstance(v, bool):
                raise ValueError(f"{key} must be a boolean or null")
        for key in ("tap_interface_regex", "extra_netns_regex",
                    "log_level"):
            v = config.get(key)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"{key} must be a string or null")
        v = config.get("tap_mode")
        if v is not None and v not in (0, 1, 2, 3):
            raise ValueError("tap_mode must be 0..3 (LOCAL/MIRROR/"
                             "ANALYZER/DECAP) or null")
        v = config.get("flow_acls")
        if v is not None and not (isinstance(v, list)
                                  and all(isinstance(a, dict)
                                          for a in v)):
            raise ValueError("flow_acls must be a list of acl dicts "
                             "or null")
        with self._lock:
            base = dict(self._configs.get(group, DEFAULT_CONFIG))
            old_acls = base.get("flow_acls")
            old_ver = int(base.get("acl_version") or 0)
            base.update(config)
            # acl_version follows policy content automatically when the
            # caller didn't bump it: an edited rule set with a stale
            # version would be silently ignored by EVERY agent (the
            # labeler and the reference agent both recompile only when
            # the version moves) — fleet-wide stale policy, no error
            if "flow_acls" in config and config["flow_acls"] != old_acls \
                    and int(base.get("acl_version") or 0) <= old_ver:
                base["acl_version"] = old_ver + 1
            self._configs[group] = base
            self.config_version += 1
            self._save_locked()
            return self.config_version

    def groups(self) -> List[str]:
        with self._lock:
            return sorted(self._configs)
