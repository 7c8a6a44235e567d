"""The traced slice of a run: torch.profiler over CPU and CUDA, read back
from its Chrome trace into kernel and host intervals.

The slice is marked by a `portbench.traced` annotation on the thread
that opens it; its span is the traced window. The device is busy where
a kernel, copy or memset ran (the union of their intervals); an idle gap
is attributed to the host operation, on any thread, that overlaps it
most.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

MARK = "portbench.traced"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")
GAPS_ATTRIBUTED = 2000      # the longest idle gaps that get a host name


class Trace:
    def __init__(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.device: List[Tuple[str, str, float, float]] = []
        host = []
        span = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            name = e.get("name", "")
            if cat in _DEVICE_CATS:
                self.device.append((cat, name, ts, dur))
            elif cat in _HOST_CATS:
                if name == MARK:
                    span = (ts, ts + dur)
                else:
                    host.append((name, ts, ts + dur))
        if span is None:
            raise ValueError(f"{path}: no {MARK} annotation in the trace")
        self.span = span
        self.device = [d for d in self.device
                       if d[2] < span[1] and d[2] + d[3] > span[0]]
        self.host = host

    # -- device -----------------------------------------------------------
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def _busy_intervals(self) -> np.ndarray:
        lo, hi = self.span
        iv = sorted((max(ts, lo), min(ts + dur, hi))
                    for _, _, ts, dur in self.device)
        merged: List[List[float]] = []
        for s, e in iv:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged, np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self._busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6

    def kernels(self, pattern: Optional[str] = None):
        """(name, start us, duration us) of the kernels whose name
        matches the regular expression `pattern` (all with None)."""
        rx = None if pattern is None else re.compile(pattern)
        return [(n, ts, dur) for cat, n, ts, dur in self.device
                if cat == "kernel" and (rx is None or rx.search(n))]

    # -- breakdown ----------------------------------------------------------
    def device_ops(self, top: int = 10) -> List[list]:
        total = defaultdict(float)
        for _, name, _, dur in self.device:
            total[name] += dur
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), t / 1e6] for n, t in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds by what the host was doing: each of the longest
        gaps between device intervals goes to the host operation that
        overlaps it most (the shorter one on a tie)."""
        lo, hi = self.span
        iv = self._busy_intervals()
        edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        if not len(gaps):
            return []
        order = np.argsort(gaps[:, 0] - gaps[:, 1])[:GAPS_ATTRIBUTED]
        hs = np.array([h[1] for h in self.host] or [0.0])
        he = np.array([h[2] for h in self.host] or [0.0])
        names = [h[0] for h in self.host]
        by = defaultdict(float)
        for gs, ge in gaps[order]:
            ov = np.minimum(he, ge) - np.maximum(hs, gs)
            if names and ov.max() > 0:
                best = ov.max()
                cand = np.nonzero(ov >= best * (1 - 1e-9))[0]
                pick = cand[np.argmin((he - hs)[cand])]
                by[_short(names[pick])] += ge - gs
            else:
                by["(no host operation traced)"] += ge - gs
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e6] for n, t in rows]


def _short(name: str, cap: int = 120) -> str:
    return name if len(name) <= cap else name[:cap - 3] + "..."
