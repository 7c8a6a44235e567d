"""Plain reference of the l4 sketch exporter's windows, and the
comparison that decides `correct` for the l4 cells.

From a window's raw records it computes, in numpy, what the flow suite
must hold at the window's close (`window_state`): the Count-Min counts
of the 5-tuple flow keys, the per-service HyperLogLog registers of the
client addresses, and the packet-weighted entropy histograms of the four
address and port features. Every cell is exact, so the program's state
on the snapshot bus is compared cell for cell. From that state it reads
what a window's output must say: each top-K entry's count is the
Count-Min estimate of its key, and the entropies and the cardinalities
are computed in float64. From the raw records it counts each window's
flows exactly, as a GROUP BY would: the window's exact top-K is every
flow whose count is above the (K+1)-th count (flows tied at the tail
left out), and the share of those members, over all the run's windows,
that the reported top-K lacks is held to the configuration's recall.

Windows are consecutive ranges of the put order: the exporter's worker
is a single FIFO thread, so window i holds the records after those of
windows 0..i-1, as many as its `rows` says.

The sizes and seeds come from the configuration's `flow_suite` block.
Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from reference import hashing as H

SENTINEL = 0xFFFFFFFF
ENTROPY_FEATURES = ("ip_src", "ip_dst", "port_src", "port_dst")
PKTS_CAP = 0xFFFF       # a record's packet weight saturates here


@dataclass
class Window:
    """One closed window as the benchmark saw it. `out` holds the
    window output's leaves as host numpy (topk_keys as uint32 bits,
    topk_counts, service_cardinality, entropies, rows); `state` the
    leaves published on the snapshot bus for it (None if none was);
    [lo, hi) its records in put order."""

    lo: int
    hi: int
    out: Dict[str, np.ndarray]
    state: Optional[Dict[str, np.ndarray]]


class Sizes:
    def __init__(self, suite: dict) -> None:
        self.depth = int(suite["cms_depth"])
        self.cms_lw = int(suite["cms_log2_width"])
        self.ring = int(suite["ring_size"])
        self.top_k = int(suite["top_k"])
        self.groups = int(suite["hll_groups"])
        self.p = int(suite["hll_precision"])
        self.ent_lw = int(suite["entropy_log2_buckets"])
        seed = int(suite["seed"])
        self.cms_seeds = H.seed_pairs(self.depth, seed)
        self.ent_seeds = H.seed_pairs(len(ENTROPY_FEATURES), seed ^ 0xE27)


def flow_keys(rec: Dict[str, np.ndarray]) -> np.ndarray:
    return H.fold([rec["ip_src"], rec["ip_dst"], rec["port_src"],
                   rec["port_dst"], rec["proto"]])


def cms_index(keys: np.ndarray, sz: Sizes) -> np.ndarray:
    """[depth, n] flat indices into the [depth, 2^lw] counts."""
    w = 1 << sz.cms_lw
    return np.stack([H.bucket(keys, int(sz.cms_seeds[d, 0]),
                              int(sz.cms_seeds[d, 1]), sz.cms_lw) + d * w
                     for d in range(sz.depth)])


def window_state(rec: Dict[str, np.ndarray], sz: Sizes
                 ) -> Dict[str, np.ndarray]:
    """The flow suite's state after these records, from zero."""
    n = len(rec["ip_src"])
    w = 1 << sz.cms_lw
    keys = flow_keys(rec)
    cms = np.bincount(cms_index(keys, sz).ravel(),
                      minlength=sz.depth * w).reshape(sz.depth, w)
    pkts = np.minimum(rec["packet_tx"].astype(np.uint64)
                      + rec["packet_rx"].astype(np.uint64), PKTS_CAP)
    b = 1 << sz.ent_lw
    ent = np.zeros((len(ENTROPY_FEATURES), b), np.int64)
    for f, name in enumerate(ENTROPY_FEATURES):
        idx = H.bucket(rec[name], int(sz.ent_seeds[f, 0]),
                       int(sz.ent_seeds[f, 1]), sz.ent_lw)
        ent[f] = np.bincount(idx, weights=pkts.astype(np.float64),
                             minlength=b).astype(np.int64)
    m = 1 << sz.p
    group = (H.fold([rec["ip_dst"], rec["port_dst"], rec["proto"]])
             % np.uint32(sz.groups)).astype(np.int64)
    h = H.mix32(rec["ip_src"])
    reg = (h >> np.uint32(32 - sz.p)).astype(np.int64)
    with np.errstate(over="ignore"):
        rest = h << np.uint32(sz.p)
    rho = np.minimum(H.clz32(rest), 32 - sz.p) + 1
    hll = np.zeros(sz.groups * m, np.int64)
    np.maximum.at(hll, group * m + reg, rho)
    return {"cms": cms, "hll": hll.reshape(sz.groups, m), "ent": ent,
            "rows": np.int64(n), "keys": keys}


def cms_estimate(cms: np.ndarray, keys: np.ndarray, sz: Sizes) -> np.ndarray:
    idx = cms_index(keys, sz)
    return cms.reshape(-1)[idx].min(axis=0)


def entropies(ent: np.ndarray) -> np.ndarray:
    """Normalized Shannon entropy per feature row, float64 (0 if empty)."""
    h = ent.astype(np.float64)
    total = h.sum(axis=1, keepdims=True)
    p = h / np.maximum(total, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        xlogx = np.where(p > 0, p * np.log(p), 0.0)
    return np.where(total[:, 0] > 0,
                    -xlogx.sum(axis=1) / math.log(h.shape[1]), 0.0)


def _sigma(x: float) -> float:
    if x == 1.0:
        return math.inf
    y, z = 1.0, x
    while True:
        x = x * x
        z_old = z
        z += x * y
        y += y
        if z == z_old:
            return z


def _tau(x: float) -> float:
    if x == 0.0 or x == 1.0:
        return 0.0
    y, z = 1.0, 1.0 - x
    while True:
        x = math.sqrt(x)
        z_old = z
        y *= 0.5
        z -= (1.0 - x) ** 2 * y
        if z == z_old:
            return z / 3.0


def hll_estimates(regs: np.ndarray, p: int) -> np.ndarray:
    """Ertl's improved estimator per group, float64; 0 for an empty
    group."""
    m = 1 << p
    q = 32 - p
    out = np.zeros(regs.shape[0])
    counts = np.stack([np.bincount(np.clip(r, 0, q + 1), minlength=q + 2)
                       for r in regs])
    for g, c in enumerate(counts):
        if c[0] >= m:
            continue
        z = m * _tau(1.0 - c[q + 1] / m)
        for k in range(q, 0, -1):
            z = 0.5 * (z + c[k])
        z += m * _sigma(c[0] / m)
        out[g] = m * m / (2.0 * math.log(2.0)) / z
    return out


def stable_top(counts: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest counts, descending, lower index first
    among equals."""
    return np.argsort(-counts.astype(np.int64), kind="stable")[:k]


def exact_top(keys: np.ndarray, k: int) -> np.ndarray:
    """A window's exact top-k by a GROUP BY of its flow keys: every key
    whose count is above the (k+1)-th largest count, so that no flow tied
    with one outside is in it (all keys when there are k or fewer)."""
    uk, uc = np.unique(keys, return_counts=True)
    if len(uc) <= k:
        return uk
    kth = np.partition(uc, len(uc) - k - 1)[len(uc) - k - 1]
    return uk[uc > kth]


def check(windows: List[Window], attempted: int, store: Dict[str, dict],
          bank, sz: Sizes, readout_dtype=np.float64) -> Dict[str, float]:
    """The numbers compared for an l4 run (see PERF.md for their
    limits). `bank.records(lo, hi)` rebuilds a window's rows; `store` holds
    the columns of tpu_sketch.window_signals and .topk_flows read back
    after the run."""
    rows_lost = abs(attempted - sum(int(w.out["rows"]) for w in windows))
    state_off = topk_off = unwritten = 0
    readout_gap = 0.0
    topk_exact = topk_lost = 0
    live_total = 0
    for w in windows:
        if int(w.out["rows"]) == 0:
            continue
        rec = bank.records(w.lo, w.hi)
        ref = window_state(rec, sz)
        st = w.state
        if st is None:
            unwritten += 1
        else:
            rows_lost += abs(int(st["rows_seen"]) - (w.hi - w.lo))
            state_off += int((st["cms"] != ref["cms"]).sum())
            state_off += int((st["hll"] != ref["hll"]).sum())
            state_off += int((st["ent"] != ref["ent"]).sum())
            # the candidate ring: live keys distinct, each holding its
            # key's Count-Min estimate at the close
            rk = st["ring_keys"].astype(np.uint32)
            rc = st["ring_counts"].astype(np.int64)
            live = rk != np.uint32(SENTINEL)
            topk_off += int(live.sum()) - len(np.unique(rk[live]))
            topk_off += int((rc[live] != cms_estimate(
                ref["cms"], rk[live], sz)).sum())
            # the output's top-K is the ring's
            top = stable_top(rc, sz.top_k)
            topk_off += int((rk[top] != w.out["topk_keys"]).sum())
            topk_off += int((rc[top] != w.out["topk_counts"]).sum())
        ok = w.out["topk_counts"] > 0
        okeys = w.out["topk_keys"][ok]
        live_total += int(ok.sum())
        topk_off += int((w.out["topk_counts"][ok] != cms_estimate(
            ref["cms"], okeys, sz)).sum())
        # float readouts against float64 from the exact state
        ent_ref = entropies(ref["ent"])
        card_ref = hll_estimates(ref["hll"], sz.p)
        ent = w.out["entropies"].astype(readout_dtype).astype(np.float64)
        card = w.out["service_cardinality"].astype(readout_dtype) \
            .astype(np.float64)
        readout_gap = max(readout_gap, float(np.abs(ent - ent_ref).max()),
                          float((np.abs(card - card_ref)
                                 / np.maximum(card_ref, 1.0)).max()))
        exact = exact_top(ref["keys"], sz.top_k)
        topk_exact += len(exact)
        topk_lost += int((~np.isin(exact, okeys)).sum())
    # the store: one window_signals row per window with rows, holding its
    # rows; one topk_flows row per live top-K entry
    ws = store.get("window_signals", {})
    wrows = ws.get("rows", np.zeros(0, np.int64)).astype(np.int64)
    with_rows = [w for w in windows if int(w.out["rows"]) > 0]
    unwritten += abs(int((wrows > 0).sum()) - len(with_rows))
    unwritten += int(int(wrows.sum()) != sum(int(w.out["rows"])
                                              for w in with_rows))
    tk = store.get("topk_flows", {})
    unwritten += abs(len(tk.get("count", [])) - live_total)
    return {"rows_lost": rows_lost, "state_cells_off": state_off,
            "topk_off": topk_off, "unwritten": unwritten,
            "readout_gap": readout_gap,
            "topk_loss": topk_lost / max(1, topk_exact)}


def judge(config: dict, windows: List[Window], attempted: int,
          store: Dict[str, dict], bank, seed: int,
          readout_dtype=np.float64) -> Dict[str, float]:
    """`check` with the configuration's sizes (the seed draws nothing
    here: every window is compared)."""
    return check(windows, attempted, store, bank,
                 Sizes(config["flow_suite"]), readout_dtype)
