"""Accuracy observatory: a hash-sampled exact shadow of the live sketches.

A deterministic flow-hash sample of the stream is mirrored into exact
host-side structures, and at every window close the exact answers are
compared against the device sketch's Count-Min point estimates, HLL
cardinality, top-K membership and entropies: observed error, headroom
against the theoretical epsilon and top-K recall, with an alarm when the
error exceeds its bound for consecutive windows.

Sampling discipline (what makes the shadow exact, not another estimate):

- Admission is by FLOW KEY hash, not by row: a flow is in the shadow iff
  ``mix32(flow_key ^ salt) < rate * 2^32``. The key fold is
  `utils/u32.fold_columns_np`, bit-identical to the device fold, so the
  sampled key space is the device's key space and the same keys are
  sampled after a restart.
- Because admission is per key, the shadow sees every occurrence of an
  admitted key: its counts are exact global counts, compared against the
  sketch's estimates with no sampling error on the truth side.
- Distinct cardinality is sampled the same way on the HLL's own key
  space ((service group, client ip) pairs); the exact distinct count of
  the sampled pairs over the rate estimates it, with relative error
  ~ 1/sqrt(rate * D) carried into the comparison bound.
- Entropy is compared on the device's own definition: the same hashed
  buckets (the device's entropy seeds) over the sampled rows, read with
  the same normalized-entropy formula.

Everything here is host numpy over the decoded chunk, never the device
path: the sketch state is bit-identical with the audit on or off.
`close_window` reads the window output on the host; the exporter hands
it a host copy it made once for the window.

The anomaly plane's entropy-DDoS verdict is audited the same way: the
shadow scores its exact entropies with `detectors.ddos_score_np` over
its own EWMA baseline, and clean windows accumulate a confusion matrix
(device verdict against shadow verdict) into precision and recall.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import numpy as np

from deepflow_tpu_torch.anomaly.detectors import ddos_score_np
from deepflow_tpu_torch.models.flow_suite import ENTROPY_FEATURES
from deepflow_tpu_torch.utils.u32 import (_mix32_np, fold_columns_np,
                                          splitmix32_seeds)

__all__ = ["ShadowAuditor"]

_U32 = np.uint32


def _as_u32_np(x) -> np.ndarray:
    """Host keys as uint32 (the port's int32 bits reinterpreted)."""
    x = np.asarray(x)
    return x.view(_U32) if x.dtype == np.int32 else x.astype(_U32, copy=False)


class ShadowAuditor:
    """The exact-shadow lane for one sketch exporter.

    ``absorb(cols)`` on every decoded chunk (host-side, at the same
    boundary rows_in is counted, so the shadow's window is the sketch's
    window); ``close_window(out, ...)`` at every window flush, after the
    device state settled. Both run under the owner's state lock, plus an
    internal lock so standalone use stays safe. ``shards`` > 1 splits
    each chunk's sampled rows by position, for a caller that shards
    batches by position across devices.
    """

    def __init__(self, cfg, rate: float = 1.0 / 64,
                 salt: int = 0xA0D17E57,
                 max_keys: int = 1 << 16,
                 trip_windows: int = 3,
                 clear_windows: int = 3,
                 min_sampled_rows: int = 128,
                 min_recall_candidates: int = 8,
                 entropy_bound: float = 0.05,
                 shards: int = 1) -> None:
        self.cfg = cfg
        self.rate = float(min(max(rate, 0.0), 1.0))
        # u64 threshold so rate=1.0 admits the full u32 range exactly
        self._threshold = np.uint64(int(self.rate * float(1 << 32)))
        self._salt = _U32(salt & 0xFFFFFFFF)
        self._client_salt = _U32((salt ^ 0x5EED9E37) & 0xFFFFFFFF)
        self.max_keys = int(max_keys)
        self.trip_windows = int(trip_windows)
        self.clear_windows = int(clear_windows)
        self.min_sampled_rows = int(min_sampled_rows)
        self.min_recall_candidates = int(min_recall_candidates)
        self.entropy_bound = float(entropy_bound)
        self.shards = max(1, int(shards))
        # device-identical entropy bucketing: same seed schedule, same
        # multiply-shift bucket hash, same bucket count
        self._features = ENTROPY_FEATURES
        self._log2_buckets = int(cfg.entropy_log2_buckets)
        self._buckets = 1 << self._log2_buckets
        self._ent_seeds = splitmix32_seeds(
            2 * len(ENTROPY_FEATURES),
            (cfg.seed ^ 0xE27) & 0xFFFFFFFF).reshape(-1, 2)
        # theoretical bounds of the sketches under audit
        self.cms_eps_theory = math.e / float(1 << cfg.cms_log2_width)
        self._hll_base_eps = 1.04 / math.sqrt(float(1 << cfg.hll_precision))
        # -- window-scoped shadow state --------------------------------
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}       # flow_key -> exact count
        self._clients: set = set()              # sampled (group, ip) pairs
        self._ent = np.zeros((len(ENTROPY_FEATURES), self._buckets),
                             np.int64)
        self._window_rows = 0                   # all rows this window
        self._window_sampled = 0                # sampled rows this window
        self._clipped = False                   # key cap hit this window
        self._shard_rows = [0] * self.shards    # per-shard sampled rows
        # -- totals + alarm --------------------------------------------
        self.rows_seen_total = 0                # conservation vs rows_in
        self.sampled_rows_total = 0
        self.windows = 0
        self.degraded_windows = 0
        self.lossy_windows = 0
        self.clipped_windows = 0
        self.evicted_keys = 0
        self.alarm = False
        self.alarm_trips = 0
        self._violations = 0                    # consecutive, toward trip
        self._healthy = 0                       # consecutive, toward clear
        self.last_window: Optional[dict] = None
        # -- detection audit -------------------------------------------
        # the shadow scores its exact entropies with ddos_score_np over
        # its own EWMA baseline; clean windows accumulate a confusion
        # matrix (device verdict against shadow verdict). At rate < 1
        # the shadow's entropies are a cluster sample (see _compare), so
        # the numbers are advisory below full rate.
        self.det_tp = 0
        self.det_fp = 0
        self.det_fn = 0
        self.det_tn = 0
        self._det_mean = np.full(len(self._features), 0.5)
        self._det_var = np.full(len(self._features), 0.25)
        self._det_windows = 0                   # busy windows into the EWMA
        self.last_detection: Optional[dict] = None

    # -- ingest (host-side, every chunk) -----------------------------------
    def _admit(self, hashed: np.ndarray) -> np.ndarray:
        """bool mask: hash below the rate threshold (u64 compare so a
        rate of 1.0 admits 0xFFFFFFFF too)."""
        return hashed.astype(np.uint64) < self._threshold

    def absorb(self, cols: Dict[str, np.ndarray]) -> int:
        """Mirror one decoded chunk into the exact shadow. Host numpy
        only; returns sampled rows. Columns must be the SKETCH schema
        subset (5-tuple + packet counts) as host arrays."""
        n = len(next(iter(cols.values()))) if cols else 0
        if n == 0:
            return 0
        ip_src = np.asarray(cols["ip_src"]).astype(_U32, copy=False)
        ip_dst = np.asarray(cols["ip_dst"]).astype(_U32, copy=False)
        port_src = np.asarray(cols["port_src"]).astype(_U32, copy=False)
        port_dst = np.asarray(cols["port_dst"]).astype(_U32, copy=False)
        proto = np.asarray(cols["proto"]).astype(_U32, copy=False)
        fkey = fold_columns_np([ip_src, ip_dst, port_src, port_dst, proto])
        with np.errstate(over="ignore"):
            admit = self._admit(_mix32_np(fkey ^ self._salt))
            # HLL's key space: (service group, client ip) pairs, sampled
            # by their own hash so distinct-count scaling is unbiased
            skey = fold_columns_np([ip_dst, port_dst, proto])
            group = skey % _U32(self.cfg.hll_groups)
            pair_h = _mix32_np(_mix32_np(group) ^ ip_src ^ self._client_salt)
            cadmit = self._admit(pair_h)
        sampled = int(admit.sum())
        with self._lock:
            self.rows_seen_total += n
            self._window_rows += n
            if self.shards > 1:
                # positional shard attribution (batches shard by position
                # on the mesh's data axis): the future merged-sketch path
                # reads which shard contributed the sampled slice
                width = max(1, n // self.shards)
                for s in range(self.shards):
                    lo = s * width
                    hi = n if s == self.shards - 1 else (s + 1) * width
                    self._shard_rows[s] += int(admit[lo:hi].sum())
            if sampled:
                self._window_sampled += sampled
                self.sampled_rows_total += sampled
                uniq, cnt = np.unique(fkey[admit], return_counts=True)
                counts = self._counts
                for k, c in zip(uniq.tolist(), cnt.tolist()):
                    counts[k] = counts.get(k, 0) + c
                if len(counts) > self.max_keys:
                    # keep the heavy half: top-K/CMS comparisons only
                    # need heads; surviving keys stay exact, the clip is
                    # counted and the window excluded from the alarm
                    import heapq
                    keep = heapq.nlargest(self.max_keys // 2,
                                          counts.items(),
                                          key=lambda kv: kv[1])
                    self.evicted_keys += len(counts) - len(keep)
                    self._counts = dict(keep)
                    self._clipped = True
                # entropy shadow: device-identical hashed buckets over
                # the sampled rows, same u16 packet-weight saturation
                pkts = np.minimum(
                    np.asarray(cols["packet_tx"]).astype(np.int64)[admit]
                    + np.asarray(cols["packet_rx"]).astype(np.int64)[admit],
                    0xFFFF)
                feats = (ip_src, ip_dst, port_src, port_dst)
                with np.errstate(over="ignore"):
                    for i in range(len(self._features)):
                        mult, fsalt = self._ent_seeds[i]
                        x = _mix32_np(feats[i][admit] ^ _U32(fsalt))
                        idx = ((_U32(mult) * x)
                               >> _U32(32 - self._log2_buckets))
                        self._ent[i] += np.bincount(
                            idx.astype(np.int64), weights=pkts,
                            minlength=self._buckets).astype(np.int64)
            if cadmit.any():
                pairs = (group[cadmit].astype(np.uint64) << np.uint64(32)) \
                    | ip_src[cadmit].astype(np.uint64)
                self._clients.update(np.unique(pairs).tolist())
        return sampled

    # -- window close ------------------------------------------------------
    def close_window(self, out, degraded: bool = False,
                     lossy: bool = False,
                     detection: Optional[dict] = None) -> Optional[dict]:
        """Compare the settled window output against the exact shadow,
        advance the alarm ladder, reset the shadow. ``out`` is the
        window's output on the host (numpy arrays or CPU tensors), or
        None (an error or empty window): the shadow still resets and the
        window is counted untrusted. ``detection`` is the anomaly plane's
        entropy-DDoS verdict for the window
        (AnomalyPlane.last_entropy_verdict); when present, the shadow
        audits detection precision and recall as it audits sketch
        error."""
        with self._lock:
            snap = self._close_window_locked(out, degraded, lossy,
                                             detection)
        return snap

    def _close_window_locked(self, out, degraded: bool, lossy: bool,
                             detection: Optional[dict] = None
                             ) -> Optional[dict]:
        self.windows += 1
        clipped = self._clipped
        snap = {
            "window": self.windows,
            "rows": self._window_rows,
            "sampled_rows": self._window_sampled,
            "sampled_keys": len(self._counts),
            "degraded": bool(degraded),
            "lossy": bool(lossy),
            "clipped": bool(clipped),
            "shard_sampled_rows": list(self._shard_rows),
        }
        if degraded:
            self.degraded_windows += 1
        if lossy:
            self.lossy_windows += 1
        if clipped:
            self.clipped_windows += 1
        if out is not None and self._window_rows > 0:
            snap.update(self._compare(out))
        if detection is not None:
            snap.update(self._close_detection_locked(
                detection, degraded=degraded, lossy=lossy))
        # alarm ladder: only clean windows (device lane, no counted
        # loss, unclipped shadow, enough sample) advance it — a degraded
        # or lossy window is expected to be wrong and is tagged, not
        # alarmed on
        eligible = (not degraded and not lossy and not clipped
                    and self._window_sampled >= self.min_sampled_rows
                    and "violation" in snap)
        if eligible:
            if snap["violation"]:
                self._violations += 1
                self._healthy = 0
                if not self.alarm and self._violations >= self.trip_windows:
                    self.alarm = True
                    self.alarm_trips += 1
            else:
                self._healthy += 1
                self._violations = 0
                if self.alarm and self._healthy >= self.clear_windows:
                    self.alarm = False
        # reset the window-scoped shadow (window-scoped like the sketches)
        self._counts = {}
        self._clients = set()
        self._ent[:] = 0
        self._window_rows = 0
        self._window_sampled = 0
        self._clipped = False
        self._shard_rows = [0] * self.shards
        self.last_window = snap
        return snap

    def _shadow_entropies(self) -> Optional[np.ndarray]:
        """Normalized Shannon entropies of the shadow's hashed-bucket
        histograms (the same formula _compare reads) — None when the
        window sampled nothing."""
        h = self._ent.astype(np.float64)
        total = h.sum(axis=1, keepdims=True)
        if not (total > 0).any():
            return None
        p = h / np.maximum(total, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            xlogx = np.where(p > 0, p * np.log(p), 0.0)
        return np.where(total[:, 0] > 0,
                        -xlogx.sum(axis=1) / np.log(self._buckets), 0.0)

    def _close_detection_locked(self, detection: dict, degraded: bool,
                                lossy: bool) -> dict:
        """One window of the detection audit: the shadow prices its
        exact entropies with ddos_score_np over its own EWMA baseline
        (same running-average warmup as the device plane), and clean
        windows advance the confusion matrix against the device
        verdict."""
        res: dict = {}
        ent = self._shadow_entropies()
        if ent is None:
            return res
        w = self._det_windows
        z = (ent - self._det_mean) / np.sqrt(
            np.maximum(self._det_var, 1e-4))
        score = ddos_score_np(z)
        threshold = float(detection.get("threshold", 4.0))
        warm = w >= int(detection.get("warmup_windows", 8))
        truth = warm and score >= threshold
        pred = bool(detection.get("alerted"))
        res["detection_shadow_score"] = round(float(score), 4)
        res["detection_truth"] = truth
        res["detection_pred"] = pred
        eligible = (bool(detection.get("eligible")) and warm
                    and not degraded and not lossy and not self._clipped
                    and self._window_sampled >= self.min_sampled_rows)
        if eligible:
            if truth and pred:
                self.det_tp += 1
            elif truth:
                self.det_fn += 1
            elif pred:
                self.det_fp += 1
            else:
                self.det_tn += 1
        # baseline advancement mirrors the device plane: running
        # average while young, EWMA after, and an alerting (truth)
        # window never updates its own baseline
        if not truth:
            a = max(float(detection.get("ewma_alpha", 0.05)),
                    1.0 / (w + 1.0))
            self._det_mean = (1 - a) * self._det_mean + a * ent
            self._det_var = (1 - a) * self._det_var \
                + a * (ent - self._det_mean) ** 2
        self._det_windows += 1
        if self.det_tp + self.det_fp:
            res["detection_precision"] = round(
                self.det_tp / (self.det_tp + self.det_fp), 4)
        if self.det_tp + self.det_fn:
            res["detection_recall"] = round(
                self.det_tp / (self.det_tp + self.det_fn), 4)
        self.last_detection = res
        return res

    def _compare(self, out) -> dict:
        """Exact-vs-sketch comparison for one window (host inputs)."""
        topk_keys = _as_u32_np(out.topk_keys)
        topk_counts = np.asarray(out.topk_counts)
        card = float(np.asarray(out.service_cardinality).sum())
        dev_ent = np.asarray(out.entropies, np.float64)
        rows = int(np.asarray(out.rows))
        res: dict = {"device_rows": rows,
                     "rows_match": rows == self._window_rows}
        live = topk_counts > 0
        dev_top = {int(k): int(c) for k, c
                   in zip(topk_keys[live].tolist(),
                          topk_counts[live].tolist())}
        # -- CMS point-estimate error on the keys both sides know ------
        n_total = max(rows, 1)
        errs = [(dev_top[k] - c) / n_total
                for k, c in self._counts.items() if k in dev_top]
        if errs:
            # CMS overestimates by construction; a degraded window's
            # exact-dict counts can undershoot, hence abs
            res["cms_rel_error"] = max(abs(e) for e in errs)
            res["cms_compared_keys"] = len(errs)
            res["cms_eps_headroom"] = \
                self.cms_eps_theory - res["cms_rel_error"]
        # -- top-K membership recall -----------------------------------
        # exact global counts for sampled keys: the expected number of
        # sampled members of the true top-K is rate*K, so recall is
        # scored over the top ceil(rate*K) sampled keys
        k_s = max(1, int(math.ceil(self.rate * self.cfg.top_k)))
        if self._counts:
            import heapq
            cand = heapq.nlargest(min(k_s, len(self._counts)),
                                  self._counts.items(),
                                  key=lambda kv: kv[1])
            hit = sum(1 for k, _ in cand if k in dev_top)
            res["topk_recall"] = hit / len(cand)
            res["topk_candidates"] = len(cand)
        # -- HLL cardinality error -------------------------------------
        if self.rate > 0:
            est = len(self._clients) / self.rate
            if est > 0:
                res["hll_rel_error"] = abs(card - est) / est
                # the bound covers BOTH estimators: the HLL's 1.04/sqrt(m)
                # and the shadow's distinct-sampling noise ~ 2/sqrt(r*D)
                bound = self._hll_base_eps \
                    + 2.0 / math.sqrt(max(1.0, self.rate * est))
                res["hll_eps_bound"] = bound
                res["hll_eps_headroom"] = bound - res["hll_rel_error"]
        # -- entropy error ---------------------------------------------
        h = self._ent.astype(np.float64)
        total = h.sum(axis=1, keepdims=True)
        if (total > 0).any():
            p = h / np.maximum(total, 1.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                xlogx = np.where(p > 0, p * np.log(p), 0.0)
            ent = np.where(total[:, 0] > 0,
                           -xlogx.sum(axis=1) / np.log(self._buckets), 0.0)
            res["entropy_abs_error"] = float(np.max(np.abs(ent - dev_ent)))
            # plug-in entropy on a sample is biased low ~ (support/2n);
            # widen the bound by the shadow's own convergence term
            res["entropy_bound"] = self.entropy_bound \
                + 1.0 / math.sqrt(max(1.0, float(self._window_sampled)))
        # -- verdict ----------------------------------------------------
        violated = False
        if "cms_rel_error" in res \
                and res["cms_rel_error"] > self.cms_eps_theory:
            violated = True
        if "hll_rel_error" in res \
                and res["hll_rel_error"] > res["hll_eps_bound"]:
            violated = True
        # entropy is alarm-eligible ONLY at full rate: per-KEY admission
        # makes the sampled shadow a CLUSTER sample of the feature
        # distribution — a heavy key hashed out of the sample is missing
        # from EVERY window deterministically, and the shadow's entropy
        # can then sit far from the device's no matter how many rows
        # were sampled (the 1/sqrt(n) term models iid rows, not
        # whole-key exclusion). At rate < 1 the number is advisory.
        if (self.rate >= 1.0 and "entropy_abs_error" in res
                and res["entropy_abs_error"] > res["entropy_bound"]):
            violated = True
        if ("topk_recall" in res
                and res.get("topk_candidates", 0)
                >= self.min_recall_candidates
                and res["topk_recall"] < 0.9):
            violated = True
        res["violation"] = violated
        return res

    # -- observability -----------------------------------------------------
    def counters(self) -> dict:
        """The `tpu_sketch_accuracy` Countable family."""
        with self._lock:
            c = {
                "rate": self.rate,
                "rows_seen": self.rows_seen_total,
                "sampled_rows": self.sampled_rows_total,
                "windows": self.windows,
                "degraded_windows": self.degraded_windows,
                "lossy_windows": self.lossy_windows,
                "clipped_windows": self.clipped_windows,
                "evicted_keys": self.evicted_keys,
                "alarm": 1 if self.alarm else 0,
                "alarm_trips": self.alarm_trips,
                "consecutive_violations": self._violations,
                "shadow_keys": len(self._counts),
                "detection_tp": self.det_tp,
                "detection_fp": self.det_fp,
                "detection_fn": self.det_fn,
                "detection_tn": self.det_tn,
            }
            if self.det_tp + self.det_fp:
                c["detection_precision"] = round(
                    self.det_tp / (self.det_tp + self.det_fp), 4)
            if self.det_tp + self.det_fn:
                c["detection_recall"] = round(
                    self.det_tp / (self.det_tp + self.det_fn), 4)
            last = self.last_window
        if last is not None:
            for key in ("cms_rel_error", "hll_rel_error",
                        "entropy_abs_error", "topk_recall",
                        "cms_eps_headroom", "hll_eps_headroom"):
                if key in last:
                    c[f"last_{key}"] = round(float(last[key]), 6)
            for s, rows in enumerate(last.get("shard_sampled_rows", [])):
                if self.shards > 1:
                    c[f"shard{s}_sampled_rows"] = rows
        return c
