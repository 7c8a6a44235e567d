"""Plain reference of the RED exporter's windows, and the comparison
that decides `correct` for the RED cells.

Per hashed service group (the fold of ip_dst, port_dst and protocol,
modulo the group count) a window counts its requests, its errors (an
HTTP status of 400 or more, or a protocol's non-zero code below 100)
and a log-bucket histogram of its response times: bucket i holds the
values in (min*g^(i-1), min*g^i], g = (1+alpha)/(1-alpha), values below
min counted apart. Counts and buckets are exact and are compared cell
for cell. Each quantile the window reports is held to the guarantee the
configuration states: within alpha of the true order statistic, the
value of rank ceil(q * n) among the group's n values of the window.

Nothing here imports the program.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from reference import hashing as H

CHECK_THREADS = 4


@dataclass
class Window:
    """One closed RED window: [lo, hi) its records in put order, `out`
    the window output's leaves as host numpy (requests, errors,
    rrt_quantiles [len(q), groups], rrt_hist [groups, buckets],
    rrt_zeros)."""

    lo: int
    hi: int
    out: Dict[str, np.ndarray]


class Sizes:
    def __init__(self, suite: dict) -> None:
        self.groups = int(suite["groups"])
        self.buckets = int(suite["dd_buckets"])
        self.alpha = float(suite["dd_alpha"])
        self.min_value = float(suite.get("dd_min_value", 1.0))
        self.quantiles = tuple(float(q) for q in suite["quantiles"])
        g = (1.0 + self.alpha) / (1.0 - self.alpha)
        # upper edges of buckets 0..buckets-2, in float64
        self.bounds = self.min_value * g ** np.arange(self.buckets - 1,
                                                      dtype=np.float64)


def group_of(rec: Dict[str, np.ndarray], sz: Sizes) -> np.ndarray:
    return (H.fold([rec["ip_dst"], rec["port_dst"], rec["protocol"]])
            % np.uint32(sz.groups)).astype(np.int64)


def is_error(status: np.ndarray) -> np.ndarray:
    s = H.as_u32(status).astype(np.int64)
    return (s >= 400) | ((s > 0) & (s < 100))


def values(rec: Dict[str, np.ndarray]) -> np.ndarray:
    """Response times as the sketch reads them: u32 rounded to float32."""
    return H.as_u32(rec["rrt_us"]).astype(np.float32)


class Derived:
    """Each bank record's group, bucket, error flag and value, worked
    out once: an l7 bank has no rows that change between its cycles, so
    global record i is bank record i mod the bank's size."""

    def __init__(self, bank, sz: Sizes) -> None:
        if bank.unique:
            raise ValueError("an l7 bank repeats its records each cycle")
        cols = bank.columns
        self.n = bank.n_records
        self.group = group_of(cols, sz).astype(np.int32)
        self.value = values(cols)
        self.bucket = np.searchsorted(
            sz.bounds, np.maximum(self.value.astype(np.float64),
                                  sz.min_value)).astype(np.int32)
        self.err = is_error(cols["status"])

    def take(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Global records [lo, hi): bank slices, wrapping at its end."""
        parts = []
        while lo < hi:
            s = lo % self.n
            e = min(self.n, s + hi - lo)
            parts.append(slice(s, e))
            lo += e - s
        return {k: np.concatenate([getattr(self, k)[p] for p in parts])
                for k in ("group", "value", "bucket", "err")}


def window_counts(d: Dict[str, np.ndarray], sz: Sizes
                  ) -> Dict[str, np.ndarray]:
    g, v = d["group"].astype(np.int64), d["value"]
    zero = v < sz.min_value
    flat = g * sz.buckets + d["bucket"]
    return {
        "requests": np.bincount(g, minlength=sz.groups),
        "errors": np.bincount(g[d["err"]], minlength=sz.groups),
        "hist": np.bincount(flat[~zero], minlength=sz.groups * sz.buckets
                            ).reshape(sz.groups, sz.buckets),
        "zeros": np.bincount(g[zero], minlength=sz.groups),
        "group": g, "value": v,
    }


def quantile_gap(ref: Dict[str, np.ndarray], qs: np.ndarray,
                 sz: Sizes) -> float:
    """Largest relative gap between a reported quantile and the order
    statistic it stands for, over the groups with values at or above
    min."""
    g, v = ref["group"], ref["value"]
    # values are float32 integers: one sort of (group, value) keys
    key = np.sort((g.astype(np.uint64) << np.uint64(32))
                  | v.astype(np.float32).view(np.uint32).astype(np.uint64))
    gs = (key >> np.uint64(32)).astype(np.int64)
    vs = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32) \
        .astype(np.float64)
    starts = np.searchsorted(gs, np.arange(sz.groups))
    n = ref["requests"]
    worst = 0.0
    for qi, q in enumerate(sz.quantiles):
        # the rank of the first value whose cumulative count reaches
        # q * n, with q * n taken in float32 as the sketch takes it
        target = np.float32(q) * n.astype(np.float32)
        rank = np.maximum(np.ceil(target.astype(np.float64)), 1)
        rank = np.minimum(rank, np.maximum(n, 1)).astype(np.int64)
        live = np.nonzero(n > 0)[0]
        x = vs[starts[live] + rank[live] - 1]
        keep = x >= sz.min_value
        est = qs[qi, live][keep].astype(np.float64)
        x = x[keep]
        if len(x):
            worst = max(worst, float((np.abs(est - x) / x).max()))
    return worst


def _window(w: Window, derived: "Derived", sz: Sizes,
            readout_dtype) -> tuple:
    """(cells off, active groups, requests, quantile gap) of one window."""
    ref = window_counts(derived.take(w.lo, w.hi), sz)
    off = int((w.out["requests"] != ref["requests"]).sum())
    off += int((w.out["errors"] != ref["errors"]).sum())
    off += int((w.out["rrt_hist"] != ref["hist"]).sum())
    off += int((w.out["rrt_zeros"] != ref["zeros"]).sum())
    qs = w.out["rrt_quantiles"].astype(readout_dtype)
    return (off, int((ref["requests"] > 0).sum()),
            int(ref["requests"].sum()), quantile_gap(ref, qs, sz))


def check(windows: List[Window], attempted: int, store: Dict[str, dict],
          bank, sz: Sizes, readout_dtype=np.float32) -> Dict[str, float]:
    """The numbers compared for a RED run, over every window. The
    windows are judged on CHECK_THREADS threads (numpy's sort lets go of
    the interpreter lock), once the program has closed."""
    rows_lost = abs(attempted - sum(int(w.out["requests"].sum())
                                    for w in windows))
    derived = Derived(bank, sz)
    live = [w for w in windows if w.hi > w.lo]
    with ThreadPoolExecutor(CHECK_THREADS) as pool:
        per = list(pool.map(
            lambda w: _window(w, derived, sz, readout_dtype), live))
    counts_off = sum(p[0] for p in per)
    active = sum(p[1] for p in per)
    req_sum = sum(p[2] for p in per)
    gap = max([p[3] for p in per], default=0.0)
    red = store.get("app_red", {})
    got = red.get("requests", np.zeros(0, np.int64)).astype(np.int64)
    unwritten = abs(len(got) - active) + int(int(got.sum()) != req_sum)
    return {"rows_lost": rows_lost, "counts_off": counts_off,
            "unwritten": unwritten, "quantile_gap": gap}


def judge(config: dict, windows: List[Window], attempted: int,
          store: Dict[str, dict], bank, seed: int,
          readout_dtype=np.float32) -> Dict[str, float]:
    """`check` with the configuration's sizes (the seed draws nothing
    here: every window is compared)."""
    return check(windows, attempted, store, bank,
                 Sizes(config["app_suite"]), readout_dtype)
