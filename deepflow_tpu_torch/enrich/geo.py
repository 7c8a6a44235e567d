"""Geo-IP enrichment: province tags for public addresses.

Reference: server/libs/geo/ — a compiled table of (ip_start, ip_end,
country, region, isp) rows queried per packet through a netmask-tree
cache (netmask_tree.go NewNetmaskGeoTree), consumed by the l4 decoder
as `geo.QueryProvince(ip)` into the province_0/1 columns
(log_data/l4_flow_log.go:686). The reference ships its region data
compiled in; the MECHANISM is the framework part and that is what
lives here — deployments load their own data file.

Columnar redesign: the per-packet tree walk becomes one vectorized
range join over the whole batch — ranges sorted by start address,
np.searchsorted per batch column, bound-check against the range end
(the same sorted-prefix discipline the platform-data LPM join uses).
Province names are SmartEncoded through the shared flow_tag TagDict
("province"), so the stored column is a u32 dictionary code and the
querier humanizes/filters it exactly like every other string tag.
"""

from __future__ import annotations

import ipaddress
import json
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deepflow_tpu_torch.store.dict_store import fnv1a32

# RFC 5737 / RFC 3849 documentation prefixes: a deliberately synthetic
# built-in sample so the path is exercised out of the box without
# shipping any real-world region database. Production deployments point
# geo_db_path at their own document (same JSON shape).
SAMPLE_ENTRIES: Tuple[Tuple[str, str], ...] = (
    ("192.0.2.0/24", "TEST-NET-1"),
    ("198.51.100.0/24", "TEST-NET-2"),
    ("203.0.113.0/24", "TEST-NET-3"),
    ("198.18.0.0/15", "BENCHMARK-NET"),
)


class GeoTable:
    """Immutable sorted range table: u32 ip -> province code.

    Entries must be non-overlapping (validated at build — overlapping
    region rows are a data bug that would make the stamped tag depend
    on sort order). `encode` maps a province name to its stored u32
    code; pass a TagDict's encode_one so names land in the shared
    flow_tag dictionary, else a bare FNV code keeps the column stable
    (reverse lookup then needs the data file).
    """

    def __init__(self, entries: Sequence[Tuple[int, int, str]],
                 encode=None) -> None:
        encode = encode if encode is not None else \
            (lambda s: fnv1a32(s.encode()))
        rows = sorted(entries)
        starts, ends, codes = [], [], []
        names: List[str] = []
        prev_end = -1
        for start, end, name in rows:
            if not (0 <= start <= end <= 0xFFFFFFFF):
                raise ValueError(f"bad range {start:#x}-{end:#x}")
            if start <= prev_end:
                raise ValueError(
                    f"overlapping geo ranges at {start:#x} "
                    f"(previous ends {prev_end:#x})")
            prev_end = end
            starts.append(start)
            ends.append(end)
            codes.append(encode(name))
            names.append(name)
        self.starts = np.asarray(starts, np.uint32)
        self.ends = np.asarray(ends, np.uint32)
        self.codes = np.asarray(codes, np.uint32)
        self.names = names

    def __len__(self) -> int:
        return len(self.starts)

    def query(self, ips: np.ndarray) -> np.ndarray:
        """Vectorized province lookup: [n] u32 ips -> [n] u32 codes,
        0 = no region known (private/unlisted — the reference likewise
        returns the zero province for non-public addresses)."""
        ips = np.ascontiguousarray(ips, np.uint32)
        if len(self.starts) == 0:
            return np.zeros(ips.shape, np.uint32)
        idx = np.searchsorted(self.starts, ips, side="right") - 1
        safe = np.maximum(idx, 0)
        hit = (idx >= 0) & (ips <= self.ends[safe])
        return np.where(hit, self.codes[safe], np.uint32(0))

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_cidrs(cls, cidr_names: Iterable[Tuple[str, str]],
                   encode=None) -> "GeoTable":
        entries = []
        for cidr, name in cidr_names:
            net = ipaddress.ip_network(cidr, strict=False)
            if net.version != 4:
                # v6 ranges cannot be expressed over the folded-u32 key
                # space (the fold is not order-preserving); skip, same
                # as the reference's v4-only GEO_ENTRIES
                continue
            entries.append((int(net.network_address),
                            int(net.broadcast_address), name))
        return cls(entries, encode=encode)

    @classmethod
    def from_json(cls, path: str, encode=None) -> "GeoTable":
        """Operator data file: a JSON array of
        {"cidr": "a.b.c.d/len", "province": "..."} and/or
        {"start": "a.b.c.d", "end": "a.b.c.d", "province": "..."}.
        v6 rows of EITHER shape are skipped (the folded-u32 key space
        is not order-preserving), matching from_cidrs."""
        with open(path) as f:
            doc = json.load(f)
        entries = []
        for row in doc:
            name = row["province"]
            if "cidr" in row:
                net = ipaddress.ip_network(row["cidr"], strict=False)
                if net.version != 4:
                    continue
                entries.append((int(net.network_address),
                                int(net.broadcast_address), name))
            else:
                lo = ipaddress.ip_address(row["start"])
                hi = ipaddress.ip_address(row["end"])
                if lo.version != 4 or hi.version != 4:
                    continue
                entries.append((int(lo), int(hi), name))
        return cls(entries, encode=encode)

    @classmethod
    def sample(cls, encode=None) -> "GeoTable":
        return cls.from_cidrs(SAMPLE_ENTRIES, encode=encode)


def load_geo_table(path: Optional[str], tag_dicts=None) -> GeoTable:
    """Build the deployment geo table: operator file when configured,
    the synthetic sample otherwise; names SmartEncoded into the shared
    "province" TagDict when a registry is supplied."""
    encode = None
    if tag_dicts is not None:
        encode = tag_dicts.get("province").encode_one
    if path:
        return GeoTable.from_json(path, encode=encode)
    return GeoTable.sample(encode=encode)
