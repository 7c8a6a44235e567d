"""Persistent string<->u32 dictionaries: the SmartEncoding reverse map.

Strings (metric names, label sets, endpoints, folded stacks) become u32
hashes before entering the columnar/device domain; this dictionary makes
them recoverable at query time. It plays the role of the reference's
flow_tag database (server/ingester/flow_tag/flow_tag.go: per-batch dedup'd
tag name/value writes that the querier joins for display) and of the
tagrecorder dimension tables — but keyed by content hash, so encoding
needs no controller round-trip.

Durability: append-only JSONL journal, replayed on open; entries are
content-addressed so replay order and duplicate appends are harmless.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np


def fnv1a32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def fold_ipv6(addr16: bytes) -> int:
    """THE system-wide IPv6 -> u32 fold: FNV-1a confined to the class-E
    range (240.0.0.0/4, reserved and unrouted), so a folded v6 address
    can never collide with a real v4 interface/CIDR in platform joins or
    policy prefixes while keeping 28 bits of key entropy. Capture
    (agent/packet.py), platform compilation, and enrichment all use this
    one function."""
    return fnv1a32(addr16) | 0xF0000000


class TagDict:
    """One named dictionary (e.g. 'metric_name', 'app_stack')."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._fwd: Dict[str, int] = {}
        self._rev: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        try:
                            e = json.loads(line)
                        except ValueError:
                            continue  # torn tail write from a crash
                        self._fwd[e["s"]] = e["h"]
                        self._rev[e["h"]] = e["s"]
            self._fh = open(path, "a")

    def encode_one(self, s: str) -> int:
        with self._lock:
            h = self._fwd.get(s)
            if h is not None:
                return h
            h = fnv1a32(s.encode())
            # linear-probe past collisions so decode stays unambiguous
            while h in self._rev and self._rev[h] != s:
                h = (h + 1) & 0xFFFFFFFF
            self._fwd[s] = h
            self._rev[h] = s
            if self._fh is not None:
                self._fh.write(json.dumps({"h": h, "s": s}) + "\n")
            return h

    def encode(self, strings: Iterable[str]) -> np.ndarray:
        return np.fromiter((self.encode_one(s) for s in strings),
                           dtype=np.uint32)

    def lookup(self, s: str) -> Optional[int]:
        """Read-only encode: the query path must not grow the dictionary
        (unbounded journal growth from probing WHERE literals)."""
        with self._lock:
            return self._fwd.get(s)

    def values(self) -> List[str]:
        """All known strings (one locked copy) — series/label discovery
        (the Prometheus /api/v1/labels surface)."""
        with self._lock:
            return list(self._fwd)

    def decode(self, h: int) -> Optional[str]:
        return self._rev.get(int(h))

    def decode_many(self, hs: Iterable[int]) -> List[Optional[str]]:
        return [self._rev.get(int(h)) for h in hs]

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __len__(self) -> int:
        return len(self._fwd)


class TagDictRegistry:
    """All dictionaries under <root>/flow_tag/<name>.jsonl."""

    def __init__(self, root: Optional[str]) -> None:
        self.root = root
        self._dicts: Dict[str, TagDict] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> TagDict:
        with self._lock:
            d = self._dicts.get(name)
            if d is None:
                path = None if self.root is None else \
                    os.path.join(self.root, "flow_tag", f"{name}.jsonl")
                d = self._dicts[name] = TagDict(path)
            return d

    def flush(self) -> None:
        with self._lock:
            dicts = list(self._dicts.values())
        for d in dicts:
            d.flush()

    def close(self) -> None:
        with self._lock:
            dicts = list(self._dicts.values())
        for d in dicts:
            d.close()
