"""Vectorized platform-data lookup tables.

The reference keeps epcID+IP -> Info hash maps with LRU miss caches
(grpc_platformdata.go:136 `PlatformInfoTable`, `QueryIPV4Infos` :233) and a
ServiceTable for (ip, port, protocol) -> service_id, refreshed over gRPC
when the controller bumps the platform-data version. Here the tables are
sorted uint64 key arrays queried with np.searchsorted over whole columns:
one vectorized join enriches a million-row batch in one call. A copy of
the JAX package's enrich/platform_data.py: host numpy, no device work.

Key packing: (epc_id:u32 << 32) | ipv4:u32. IPv6 is folded to u32 by FNV
hashing at decode time (SmartEncoding discipline: strings/wide values become
integers before the columnar domain).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepflow_tpu_torch.runtime.stats import StatsRegistry

# KnowledgeGraph tag columns produced per side (suffix _0 = client/src,
# _1 = server/dst; reference: log_data/l4_flow_log.go KnowledgeGraph :226)
KG_FIELDS = (
    "region_id", "az_id", "host_id", "subnet_id",
    "l3_device_type", "l3_device_id",
    "pod_node_id", "pod_ns_id", "pod_group_id", "pod_id", "pod_cluster_id",
)

# derived per side at stamp time (reference KnowledgeGraph :283-293):
# epc_id, service_id, auto_instance/auto_service — the most-specific
# resource owning the IP, pod > pod_node > l3_device (framework-local
# type enum below; the reference uses tagrecorder device-type codes)
KG_DERIVED_FIELDS = (
    "epc_id", "service_id",
    "auto_instance_id", "auto_instance_type",
    "auto_service_id", "auto_service_type",
    "tag_source",   # where the side's tags came from (TAG_SOURCE_*)
)

# tag_source values (reference: flow_tag TagSource bits — interface
# table vs CIDR fallback vs nothing)
TAG_SOURCE_NONE = 0
TAG_SOURCE_INTERFACE = 1
TAG_SOURCE_CIDR = 2
TAG_SOURCE_WIRE = 3   # wire-carried values (eBPF ground truth) won
AUTO_TYPE_NONE = 0
AUTO_TYPE_POD = 1
AUTO_TYPE_POD_NODE = 2
AUTO_TYPE_L3_DEVICE = 3
AUTO_TYPE_SERVICE = 4


@dataclass(frozen=True)
class InterfaceInfo:
    """One interface/IP record from the controller's platform data."""

    epc_id: int
    ip: int                      # ipv4 as u32 (or folded ipv6 hash)
    region_id: int = 0
    az_id: int = 0
    host_id: int = 0
    subnet_id: int = 0
    l3_device_type: int = 0
    l3_device_id: int = 0
    pod_node_id: int = 0
    pod_ns_id: int = 0
    pod_group_id: int = 0
    pod_id: int = 0
    pod_cluster_id: int = 0


@dataclass(frozen=True)
class CidrInfo:
    """CIDR-scoped fallback info (reference: grpc_platformdata epcCidr)."""

    epc_id: int
    prefix: int                  # network address u32
    mask_len: int
    region_id: int = 0
    az_id: int = 0
    subnet_id: int = 0


@dataclass(frozen=True)
class ServiceEntry:
    """(epc, ip, port, protocol) -> service id; 0 fields are wildcards."""

    epc_id: int
    ip: int
    port: int
    protocol: int
    service_id: int


def _pack(epc: np.ndarray, ip: np.ndarray) -> np.ndarray:
    return (epc.astype(np.uint64) << np.uint64(32)) | ip.astype(np.uint64)


def _epc_pair(cols: Dict[str, np.ndarray], n: int, src_name: str,
              dst_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-side epc columns as u32 images; rows where the dst side is
    unset fall back to the src epc (single-VPC flows, and agents that
    only fill the src peer)."""
    def as_u32(name: str) -> np.ndarray:
        c = cols.get(name)
        if c is None:
            return np.zeros(n, np.uint32)
        return c.view(np.uint32) if c.dtype == np.int32 \
            else c.astype(np.uint32)

    epc0 = as_u32(src_name)
    epc1 = as_u32(dst_name)
    return epc0, np.where(epc1 != 0, epc1, epc0)


class PlatformInfoTable:
    """Sorted-array join table for per-IP KnowledgeGraph tags."""

    def __init__(self, interfaces: Sequence[InterfaceInfo] = (),
                 cidrs: Sequence[CidrInfo] = (), version: int = 0,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.version = version
        self.hits = 0
        self.misses = 0
        self._build(interfaces, cidrs)
        if stats is not None:
            stats.register("platformdata", self.counters)

    def _build(self, interfaces: Sequence[InterfaceInfo],
               cidrs: Sequence[CidrInfo]) -> None:
        """Build the new snapshot off to the side, publish atomically: query
        runs lock-free on decoder threads, so the (keys, vals, cidrs) triple
        must switch as one object."""
        n = len(interfaces)
        keys = np.fromiter(
            ((i.epc_id & 0xFFFFFFFF) << 32 | (i.ip & 0xFFFFFFFF)
             for i in interfaces), dtype=np.uint64, count=n)
        order = np.argsort(keys)
        vals = {
            f: np.fromiter((getattr(interfaces[j], f) for j in order),
                           dtype=np.uint32, count=n)
            for f in KG_FIELDS
        }
        # CIDRs grouped by mask length, longest first (vectorized LPM)
        by_len: Dict[int, List[CidrInfo]] = {}
        for c in cidrs:
            by_len.setdefault(c.mask_len, []).append(c)
        cidr_levels: List[Tuple[int, np.ndarray, Dict[str, np.ndarray]]] = []
        for mlen in sorted(by_len, reverse=True):
            entries = by_len[mlen]
            mask = (0xFFFFFFFF << (32 - mlen)) & 0xFFFFFFFF if mlen else 0
            ck = np.fromiter(
                (((c.epc_id & 0xFFFFFFFF) << 32 | (c.prefix & mask))
                 for c in entries), dtype=np.uint64, count=len(entries))
            corder = np.argsort(ck)
            cvals = {
                f: np.fromiter((getattr(entries[j], f, 0) for j in corder),
                               dtype=np.uint32, count=len(entries))
                for f in ("region_id", "az_id", "subnet_id")
            }
            cidr_levels.append((mlen, ck[corder], cvals))
        self._snapshot = (keys[order], vals, cidr_levels)

    def reload(self, interfaces: Sequence[InterfaceInfo],
               cidrs: Sequence[CidrInfo], version: int) -> bool:
        """Swap in a new snapshot if version advanced (reference: version
        check in PlatformInfoTable.Reload)."""
        if version == self.version:
            return False
        self._build(interfaces, cidrs)
        self.version = version
        return True

    def query(self, epc: np.ndarray, ip: np.ndarray) -> Dict[str, np.ndarray]:
        """Batch lookup: [n] epc + [n] ip -> {kg_field: [n] u32}.
        Exact interface match first; unmatched rows fall back to CIDR LPM."""
        n = len(ip)
        out = {f: np.zeros(n, np.uint32) for f in KG_FIELDS}
        if n == 0:
            return out
        keys, vals, cidr_levels = self._snapshot  # one consistent snapshot
        q = _pack(np.asarray(epc), np.asarray(ip))
        if len(keys):
            pos = np.searchsorted(keys, q)
            pos_c = np.minimum(pos, len(keys) - 1)
            found = keys[pos_c] == q
            for f in KG_FIELDS:
                out[f][found] = vals[f][pos_c[found]]
        else:
            found = np.zeros(n, np.bool_)
        miss = ~found
        ipq = np.asarray(ip).astype(np.uint64)
        epcq = np.asarray(epc).astype(np.uint64)
        for mlen, ckeys, cvals in cidr_levels:
            if not miss.any():
                break
            mask = np.uint64((0xFFFFFFFF << (32 - mlen)) & 0xFFFFFFFF
                             if mlen else 0)
            cq = (epcq << np.uint64(32)) | (ipq & mask)
            pos = np.searchsorted(ckeys, cq)
            pos_c = np.minimum(pos, len(ckeys) - 1)
            hit = miss & (ckeys[pos_c] == cq)
            for f in ("region_id", "az_id", "subnet_id"):
                out[f][hit] = cvals[f][pos_c[hit]]
            miss &= ~hit
        self.hits += int(n - miss.sum())
        self.misses += int(miss.sum())
        # provenance per row: interface hit > cidr hit > none
        out["tag_source"] = np.where(
            found, TAG_SOURCE_INTERFACE,
            np.where(~miss, TAG_SOURCE_CIDR,
                     TAG_SOURCE_NONE)).astype(np.uint32)
        return out

    def counters(self) -> dict:
        return {"version": self.version, "entries": len(self._snapshot[0]),
                "hits": self.hits, "misses": self.misses}


class ServiceTable:
    """(epc, ip, port, protocol) -> service_id with wildcard fallbacks.

    Lookup order (reference: grpc_platformdata.go QueryService): exact
    (epc,ip,port,proto) -> any-port (epc,ip,0,proto) -> any-ip
    (epc,0,port,proto). First match wins per row.
    """

    def __init__(self, entries: Sequence[ServiceEntry] = ()) -> None:
        self._levels: List[Tuple[bool, bool, np.ndarray, np.ndarray]] = []
        groups: Dict[Tuple[bool, bool], List[ServiceEntry]] = {}
        for e in entries:
            groups.setdefault((e.ip != 0, e.port != 0), []).append(e)
        # most-specific first
        for key in ((True, True), (True, False), (False, True)):
            if key not in groups:
                continue
            use_ip, use_port = key
            es = groups[key]
            keys = np.fromiter(
                (self._key(e.epc_id, e.ip if use_ip else 0,
                           e.port if use_port else 0, e.protocol)
                 for e in es), dtype=np.uint64, count=len(es))
            order = np.argsort(keys)
            ids = np.fromiter((es[j].service_id for j in order),
                              dtype=np.uint32, count=len(es))
            self._levels.append((use_ip, use_port, keys[order], ids))

    @staticmethod
    def _key(epc: int, ip: int, port: int, proto: int) -> int:
        # injective 64-bit pack: epc:15 | is_udp:1 | ip:32 | port:16
        # (service protocols are TCP/UDP only, as in the reference's table)
        is_udp = 1 if proto == 17 else 0
        return (((epc & 0x7FFF) << 49) | (is_udp << 48)
                | ((ip & 0xFFFFFFFF) << 16) | (port & 0xFFFF))

    def query(self, epc: np.ndarray, ip: np.ndarray, port: np.ndarray,
              proto: np.ndarray) -> np.ndarray:
        n = len(ip)
        out = np.zeros(n, np.uint32)
        if n == 0 or not self._levels:
            return out
        epc64 = np.asarray(epc).astype(np.uint64) & np.uint64(0x7FFF)
        ip64 = np.asarray(ip).astype(np.uint64)
        port64 = np.asarray(port).astype(np.uint64) & np.uint64(0xFFFF)
        is_udp = (np.asarray(proto).astype(np.uint64) == 17).astype(np.uint64)
        unset = np.ones(n, np.bool_)
        for use_ip, use_port, keys, ids in self._levels:
            if not unset.any():
                break
            k = ((epc64 << np.uint64(49)) | (is_udp << np.uint64(48))
                 | ((ip64 if use_ip else np.uint64(0)) << np.uint64(16))
                 | (port64 if use_port else np.uint64(0)))
            pos = np.searchsorted(keys, k)
            pos_c = np.minimum(pos, len(keys) - 1)
            hit = unset & (keys[pos_c] == k)
            out[hit] = ids[pos_c[hit]]
            unset &= ~hit
        return out


class PlatformDataManager:
    """Owns the shared tables; pipelines grab handles, the controller client
    pushes versioned snapshots (reference: PlatformDataManager :325)."""

    def __init__(self, stats: Optional[StatsRegistry] = None,
                 geo=None) -> None:
        self.info = PlatformInfoTable(stats=stats)
        self.services = ServiceTable()
        # optional enrich.geo.GeoTable: province_0/1 stamping (reference
        # stamps geo.QueryProvince right beside KnowledgeGraph fill,
        # l4_flow_log.go:686); None leaves the columns zero
        self.geo = geo

    def update(self, interfaces: Sequence[InterfaceInfo],
               cidrs: Sequence[CidrInfo],
               services: Sequence[ServiceEntry], version: int) -> bool:
        changed = self.info.reload(interfaces, cidrs, version)
        if changed:
            self.services = ServiceTable(services)
        return changed

    def _stamp_side(self, out: Dict[str, np.ndarray], side: str,
                    epc: np.ndarray, ip: np.ndarray, port: np.ndarray,
                    proto: np.ndarray) -> None:
        """KG lookup + derived columns for one side. Existing nonzero
        values in `out` win (eBPF-sourced pod ids etc. are ground truth;
        reference: grpc_platformdata QueryEpcIDPodInfo precedence)."""
        kg = self.info.query(epc, ip)
        wire_won = None
        for f in KG_FIELDS:
            name = f"{f}_{side}"
            if name in out:
                have = out[name].astype(np.uint32, copy=False)
                won = have != 0
                wire_won = won if wire_won is None else (wire_won | won)
                out[name] = np.where(won, have, kg[f])
            else:
                out[name] = kg[f]
        svc = self.services.query(epc, ip, port, proto)
        out[f"service_id_{side}"] = svc
        # epc_id: the interface's epc when known, else the flow's
        out[f"epc_id_{side}"] = np.ascontiguousarray(epc).view(np.int32)
        # auto_instance: most-specific owner — pod > pod_node > l3_device
        pod = out[f"pod_id_{side}"]
        node = out[f"pod_node_id_{side}"]
        dev = out[f"l3_device_id_{side}"]
        inst_id = np.where(pod != 0, pod, np.where(node != 0, node, dev))
        inst_ty = np.where(
            pod != 0, AUTO_TYPE_POD,
            np.where(node != 0, AUTO_TYPE_POD_NODE,
                     np.where(dev != 0, AUTO_TYPE_L3_DEVICE,
                              AUTO_TYPE_NONE)))
        out[f"auto_instance_id_{side}"] = inst_id.astype(np.uint32)
        out[f"auto_instance_type_{side}"] = inst_ty.astype(np.uint32)
        # auto_service: the service when registered, else the instance
        out[f"auto_service_id_{side}"] = np.where(
            svc != 0, svc, inst_id).astype(np.uint32)
        out[f"auto_service_type_{side}"] = np.where(
            svc != 0, AUTO_TYPE_SERVICE, inst_ty).astype(np.uint32)
        # provenance: wire-carried (eBPF) values that won precedence
        # outrank the table lookups they overrode
        src = kg["tag_source"]
        if wire_won is not None:
            src = np.where(wire_won, TAG_SOURCE_WIRE, src).astype(
                np.uint32)
        out[f"tag_source_{side}"] = src

    def stamp_l4(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Add KnowledgeGraph columns for both sides of an L4 batch, plus
        per-side service/epc/auto_* (reference: decoder.go handleTaggedFlow
        -> fillL4FlowLog KnowledgeGraph stamping)."""
        n = len(cols["ip_src"])
        out = dict(cols)
        epc0, epc1 = _epc_pair(cols, n, "l3_epc_id", "l3_epc_id_1")
        # client side matches any-port service entries (reference queries
        # the ServiceTable with port 0 for side 0)
        self._stamp_side(out, "0", epc0, cols["ip_src"],
                         np.zeros(n, np.uint32), cols["proto"])
        self._stamp_side(out, "1", epc1, cols["ip_dst"],
                         cols["port_dst"], cols["proto"])
        if self.geo is not None:
            p0 = self.geo.query(cols["ip_src"])
            p1 = self.geo.query(cols["ip_dst"])
            if "is_ipv6" in cols:
                # folded-u32 v6 addresses are not order-preserving: a
                # range join on them is meaningless (the reference guards
                # QueryProvince with !isIPv6, l4_flow_log.go:686)
                v6 = np.asarray(cols["is_ipv6"]) != 0
                p0 = np.where(v6, np.uint32(0), p0)
                p1 = np.where(v6, np.uint32(0), p1)
            out["province_0"] = p0
            out["province_1"] = p1
        return out

    def stamp_l7(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """KnowledgeGraph + service enrichment for l7_flow_log / OTel
        columns (reference: decoder.go:310 ProtoLogToL7FlowLog stamps the
        same PlatformInfoTable tags on L7 rows). Wire-carried pod ids
        (eBPF ground truth) take precedence over the IP-table lookup."""
        n = len(cols["ip_src"])
        out = dict(cols)
        proto = cols.get("protocol", np.full(n, 6, np.uint32))
        epc0, epc1 = _epc_pair(cols, n, "l3_epc_id_0", "l3_epc_id_1")
        self._stamp_side(out, "0", epc0, cols["ip_src"],
                         np.zeros(n, np.uint32), proto)
        self._stamp_side(out, "1", epc1, cols["ip_dst"],
                         cols["port_dst"], proto)
        return out
