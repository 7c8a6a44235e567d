"""Alert records and the AnomalyPlane: window closes -> durable alerts.

`AlertRecord` is the shape a detection crosses every boundary in: the
exporter fan-out (stream "anomaly", columnar like every exporter put)
and the anomaly snapshot bus (`SnapshotBus(name="anomaly")`, the
sketch lane's pub/sub and fsynced-npz store, in the reference's format,
so the JAX serving stack answers `SELECT * FROM anomaly` and
`anomaly_score{detector=...}` off the files this plane writes).

`AnomalyPlane` is the host side the exporter owns: per-batch
active-flow feeds on the device, the window step at every flush, alert
decisions with excursion latency, and the publish fan-out. Lock
discipline follows the exporter: `close_window` runs under its state
lock, `publish_pending` after the lock is released (bus subscribers and
exporter puts are emissions).

Loss accounting: a window the scorer could not price is
`windows_unscored`; an alert the fan-out could not place is
`alerts_shed`; a feed batch the table could not take is `feed_errors`
(detection quality only: the rows are the sketch lane's ledger).
`rows_seen` mirrors the exporter's `rows_in`.

Every publish sets the tracer gauges `anomaly_score`,
`anomaly_alerts_total`, `anomaly_detect_latency_windows` and
`anomaly_active_flows` (when the process tracer is on); `stats=`
registers the plane's counters as `anomaly`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepflow_tpu_torch import convert
from deepflow_tpu_torch.anomaly import detectors
from deepflow_tpu_torch.anomaly.detectors import DETECTORS, AnomalyConfig
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime.faults import (FAULT_ANOMALY_SCORE,
                                               default_faults)
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.tracing import default_tracer

__all__ = ["AlertRecord", "AlertSnapshot", "AnomalyPlane", "ALERT_COLUMNS",
           "ANOMALY_STREAM"]

_LOG = logging.getLogger(__name__)

# the exporter fan-out stream alerts ride
ANOMALY_STREAM = "anomaly"

# the columnar shape of one alert batch (an exporter put's cols)
ALERT_COLUMNS = ("window", "wall_time", "detector", "score", "threshold",
                 "latency_windows", "top_keys", "top_counts", "lossy",
                 "degraded")


@dataclass(frozen=True)
class AlertRecord:
    """One detection: which detector fired on which window, how hard,
    and the window's top-K flow keys as named suspects. Tags carry the
    window's trust verdicts (`lossy`, `degraded`, pod participation)."""

    window: int
    wall_time: float
    detector: str
    score: float
    threshold: float
    latency_windows: int
    top_keys: Tuple[int, ...] = ()
    top_counts: Tuple[int, ...] = ()
    lossy: bool = False
    degraded: bool = False
    participation: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe form (bus snapshot tags, SQL rows)."""
        return {
            "window": self.window, "wall_time": self.wall_time,
            "detector": self.detector, "score": round(self.score, 4),
            "threshold": self.threshold,
            "latency_windows": self.latency_windows,
            "top_keys": list(self.top_keys),
            "top_counts": list(self.top_counts),
            "lossy": self.lossy, "degraded": self.degraded,
            "participation": dict(self.participation),
        }


class AlertSnapshot:
    """The anomaly bus payload, a fixed-order list of host arrays.

    Leaf order (the serving view reads it by position):
      0 scores [3] f32        1 thresholds [3] f32
      2 z [4] f32             3 feats [9] f32
      4 active_flows [] i32   5 new_flows [] i32
      6 rows [] i32           7 alerts_total [3] i64
    """

    N_LEAVES = 8

    @staticmethod
    def leaves(scores, thresholds, z, feats, active, new, rows,
               alerts_total) -> List[np.ndarray]:
        return [np.asarray(scores, np.float32),
                np.asarray(thresholds, np.float32),
                np.asarray(z, np.float32),
                np.asarray(feats, np.float32),
                np.asarray(active, np.int32),
                np.asarray(new, np.int32),
                np.asarray(rows, np.int32),
                np.asarray(alerts_total, np.int64)]


def _host(t) -> np.ndarray:
    """A window-output leaf as host numpy (a copy off a CUDA device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class AnomalyPlane:
    """The detection lane beside one exporter.

    `feed_*` and `close_window` run wherever the exporter's state
    advances (its feed thread between drain barriers, or a producer
    under its state lock), on the exporter's compute stream: the plane's
    device state rides the sketch state's ownership. `publish_pending`
    is the only method that emits; call it with no lock held."""

    def __init__(self, cfg: Optional[AnomalyConfig] = None,
                 directory: Optional[str] = None, keep_snapshots: int = 8,
                 stats=None, device="cuda") -> None:
        self.cfg = cfg or AnomalyConfig()
        self.device = flow_suite.check_device(device)
        self.state = detectors.init(self.cfg, device=self.device)
        self.bus = SnapshotBus(directory, name="anomaly", keep=keep_snapshots)
        self._exporters = None
        self._faults = default_faults()
        self._tracer = default_tracer()
        # -- ledgers (host ints) -------------------------------------------
        self.rows_seen = 0           # conservation mirror of rows_in
        self.windows = 0             # windows closed (scored or not)
        self.windows_unscored = 0    # scoring failed or shed: counted
        self.feed_errors = 0         # feed batches dropped, device losses
        self.alerts_total = [0] * len(DETECTORS)
        self.alerts_shed = 0         # alerts that reached no sink
        self.score_errors = 0        # injected or real scoring raises
        self.last_scores = [0.0] * len(DETECTORS)
        self.last_latency_windows = 0
        self.active_flows = 0
        self.new_flows = 0
        self.table_offers = 0
        self.table_evictions = 0
        # excursion tracking for detect latency: _onset pins an
        # excursion's first (possibly unscored) window, _onset_latency
        # the latency of its first alert, which later alerts repeat
        self._onset: List[Optional[int]] = [None] * len(DETECTORS)
        self._onset_latency: List[int] = [0] * len(DETECTORS)
        self._unscored_since: Optional[int] = None
        self._pending: Optional[Tuple[list, Optional[List[np.ndarray]],
                                      dict, float, int]] = None
        # the last window's entropy_ddos verdict, for the shadow
        # auditor's detection audit
        self.last_entropy_verdict: Optional[Dict[str, Any]] = None
        if stats is not None:
            stats.register("anomaly", self.counters)

    # -- wiring --------------------------------------------------------------
    def attach_exporters(self, exporters) -> None:
        """The fan-out alerts ride (`put` on stream "anomaly"); None keeps
        bus-only publishing."""
        self._exporters = exporters

    # -- ingest-side accounting (under the exporter's state lock) ------------
    def observe_rows(self, n: int) -> None:
        self.rows_seen += int(n)

    # -- per-batch active-flow feeds (device) --------------------------------
    def _feed(self, fn, *args) -> None:
        """One feed into the active-flow table. A device-classified
        failure (`RuntimeError`) costs detection fidelity, not data: the
        batch's offers are dropped, counted in `feed_errors`, and the
        plane restarts from a fresh state (window counter kept). A
        `KernelError` is not caught."""
        if self.cfg.active_log2 <= 0:
            return
        try:
            self.state = fn(self.state, *args, self.cfg)
        except RuntimeError:
            self.feed_errors += 1
            _LOG.exception("anomaly feed failed; plane reset")
            self.state = detectors.init(self.cfg, window=self.windows,
                                        device=self.device)

    def feed_lanes(self, lanes, mask) -> None:
        self._feed(detectors.feed_lanes, lanes, mask)

    def feed_cols(self, cols, mask) -> None:
        self._feed(detectors.feed_cols, cols, mask)

    def feed_flat(self, flat, k: int, capacity: int) -> None:
        self._feed(detectors.feed_flat, flat, k, capacity)

    def feed_dict_flat(self, table, flat, sig) -> None:
        self._feed(detectors.feed_dict_flat, table, flat, tuple(sig))

    def feed_news(self, plane, n) -> None:
        self._feed(detectors.feed_news, plane, n)

    def feed_hits(self, table, plane, n) -> None:
        self._feed(detectors.feed_hits, table, plane, n)

    # -- window close (under the exporter's state lock) ----------------------
    def _score(self, out):
        """The window step, then ONE device-to-host copy of everything
        the host reads from it: scores, z and feats (float bits) and
        active, new, rows, offers and evictions, packed in one int32
        tensor. Returns (new state, host float32 [16], host int32 [5])."""
        state, s = detectors.window_step(
            self.state, out.entropies, out.topk_counts,
            out.service_cardinality, out.rows, self.cfg)
        floats = torch.cat([s.scores, s.z, s.feats]).view(torch.int32)
        ints = torch.stack([s.active_flows, s.new_flows, s.rows,
                            state.offers, state.evictions])
        host = torch.cat([floats, ints]).cpu().numpy()
        n = floats.shape[0]
        return state, host[:n].view(np.float32), host[n:]

    def close_window(self, out, now: Optional[float] = None,
                     lossy: bool = False, degraded: bool = False,
                     participation: Optional[Dict[str, Any]] = None,
                     host_out=None) -> List[AlertRecord]:
        """Score the settled window and decide alerts. `out` is the
        window's FlowWindowOutput on the plane's device, or None (a
        window the sketch could not read: it closes unscored, counted).
        `host_out` is a host copy of the same output that the caller
        already made; alert windows read their top contributors from it
        (else from `out`). Returns the alerts; the caller must call
        `publish_pending()` after releasing its lock."""
        now = time.time() if now is None else now
        w = self.windows
        self.windows += 1
        scored = None
        if out is None:
            self._mark_unscored(w)
        else:
            try:
                if self._faults.enabled:
                    self._faults.maybe_raise(FAULT_ANOMALY_SCORE,
                                             key=f"window{w}")
                state, floats, ints = self._score(out)
                self.state = state
                scored = (floats, ints)
            except RuntimeError:
                # injected (anomaly.score) or device-classified: the
                # window closes unscored, the excursion state is kept so
                # the next scored window carries the latency
                self.score_errors += 1
                _LOG.exception("anomaly window %d unscored", w)
                self._mark_unscored(w)
        alerts: List[AlertRecord] = []
        leaves = None
        # a merge that excluded a whole host is lossy for the detectors
        # whatever the caller said
        if participation and participation.get("pod_hosts_missing"):
            lossy = True
        tags: Dict[str, Any] = {"window": w, "lossy": bool(lossy),
                                "degraded": bool(degraded),
                                "scored": scored is not None}
        if participation:
            tags.update(participation)
        if scored is not None:
            floats, ints = scored
            scores, z, feats = floats[:3], floats[3:7], floats[7:16]
            self.active_flows, self.new_flows = int(ints[0]), int(ints[1])
            rows = int(ints[2])
            self.table_offers = int(ints[3])
            self.table_evictions = int(ints[4])
            self.last_scores = [float(s) for s in scores]
            contributors = None
            thr = self.cfg.thresholds
            for i, det in enumerate(DETECTORS):
                if float(scores[i]) >= thr[i]:
                    if contributors is None:
                        contributors = self._top_contributors(
                            out if host_out is None else host_out)
                    if self._onset[i] is None:
                        onset = self._unscored_since \
                            if self._unscored_since is not None else w
                        self._onset[i] = onset
                        self._onset_latency[i] = w - onset
                    latency = self._onset_latency[i]
                    self.last_latency_windows = latency
                    self.alerts_total[i] += 1
                    alerts.append(AlertRecord(
                        window=w, wall_time=now, detector=det,
                        score=float(scores[i]), threshold=thr[i],
                        latency_windows=latency,
                        top_keys=contributors[0],
                        top_counts=contributors[1],
                        lossy=bool(lossy), degraded=bool(degraded),
                        participation=dict(participation or {})))
                else:
                    self._onset[i] = None
            self._unscored_since = None
            leaves = AlertSnapshot.leaves(
                scores, np.asarray(thr, np.float32), z, feats,
                self.active_flows, self.new_flows, rows, self.alerts_total)
            tags["z"] = [round(float(v), 4) for v in z]
        if alerts:
            tags["alerts"] = [a.to_dict() for a in alerts]
        self.last_entropy_verdict = {
            "eligible": scored is not None and w >= self.cfg.warmup_windows,
            "alerted": any(a.detector == DETECTORS[0] for a in alerts),
            "score": self.last_scores[0],
            "threshold": self.cfg.entropy_z,
            "warmup_windows": self.cfg.warmup_windows,
            "ewma_alpha": self.cfg.ewma_alpha,
        }
        self._pending = (alerts, leaves, tags, now, w)
        return alerts

    def _mark_unscored(self, w: int) -> None:
        """Count window w unscored and advance the device window counter,
        so the table's LRU epoch stays aligned with the host count; if
        even that fails, restart from a fresh state at the host count."""
        self.windows_unscored += 1
        if self._unscored_since is None:
            self._unscored_since = w
        try:
            self.state = self.state._replace(window=self.state.window + 1)
        except RuntimeError:
            self.state = detectors.init(self.cfg, window=self.windows,
                                        device=self.device)

    def _top_contributors(self, out):
        """The window's top-K heads as (keys, counts): the alert's named
        suspects (keys as u32 values)."""
        k = self.cfg.top_contributors
        keys = _host(out.topk_keys)[:k].astype(np.int64) & 0xFFFFFFFF
        counts = _host(out.topk_counts)[:k]
        live = counts > 0
        return (tuple(int(x) for x in keys[live]),
                tuple(int(x) for x in counts[live]))

    # -- publish (NO lock held) ----------------------------------------------
    def publish_pending(self) -> None:
        """Fan the last closed window out: the anomaly bus (an fsynced
        npz on alert windows, subscribers only otherwise), the exporter
        fan-out and the tracer's gauges. Every failure is counted
        (`alerts_shed`), never raised into the window thread."""
        pending = self._pending
        if pending is None:
            return
        self._pending = None
        alerts, leaves, tags, now, w = pending
        published = False
        if leaves is not None:
            try:
                self.bus.publish(leaves, step=w, wall_time=now, tags=tags,
                                 to_disk=bool(alerts))
                published = True
            except Exception:
                _LOG.exception("anomaly bus publish failed (window %d)", w)
        if alerts and self._exporters is not None:
            # the fan-out contains every exporter failure itself
            self._exporters.put(ANOMALY_STREAM, 0, self._alert_cols(alerts))
            published = True
        if alerts and not published:
            self.alerts_shed += len(alerts)
        self._emit_gauges()

    def _emit_gauges(self) -> None:
        tr = self._tracer
        if not tr.enabled:
            return
        tr.gauge("anomaly_score", max(self.last_scores) if
                 self.last_scores else 0.0)
        tr.gauge("anomaly_alerts_total", float(sum(self.alerts_total)))
        tr.gauge("anomaly_detect_latency_windows",
                 float(self.last_latency_windows))
        tr.gauge("anomaly_active_flows", float(self.active_flows))

    @staticmethod
    def _alert_cols(alerts: List[AlertRecord]) -> Dict[str, np.ndarray]:
        return {
            "window": np.asarray([a.window for a in alerts], np.uint32),
            "wall_time": np.asarray([a.wall_time for a in alerts],
                                    np.float64),
            "detector": np.asarray([a.detector for a in alerts]),
            "score": np.asarray([a.score for a in alerts], np.float32),
            "threshold": np.asarray([a.threshold for a in alerts],
                                    np.float32),
            "latency_windows": np.asarray(
                [a.latency_windows for a in alerts], np.uint32),
            "top_keys": np.asarray(
                [",".join(str(k) for k in a.top_keys) for a in alerts]),
            "top_counts": np.asarray(
                [",".join(str(c) for c in a.top_counts) for a in alerts]),
            "lossy": np.asarray([a.lossy for a in alerts], np.uint8),
            "degraded": np.asarray([a.degraded for a in alerts], np.uint8),
        } if alerts else {}

    # -- degraded-lane hook --------------------------------------------------
    def device_lost(self) -> None:
        """The sketch lane classified a device error, and the plane's
        tensors may sit on the same failed work. Rebuild fresh tensors
        from a host copy (same baselines, subspace and ring); if the copy
        fails, restart from a fresh state. Either way the event is
        counted in `feed_errors` and the window counter is kept."""
        self.feed_errors += 1
        try:
            self.state = convert.anomaly_from_numpy(
                convert.anomaly_to_numpy(self.state), device=self.device)
        except RuntimeError:
            self.state = detectors.init(self.cfg, window=self.windows,
                                        device=self.device)

    # -- observability -------------------------------------------------------
    def counters(self) -> dict:
        c = {
            "rows_seen": self.rows_seen,
            "windows": self.windows,
            "windows_unscored": self.windows_unscored,
            "score_errors": self.score_errors,
            "feed_errors": self.feed_errors,
            "alerts_shed": self.alerts_shed,
            "alerts_total": sum(self.alerts_total),
            "active_flows": self.active_flows,
            "new_flows": self.new_flows,
            "table_offers": self.table_offers,
            "table_evictions": self.table_evictions,
            "detect_latency_windows": self.last_latency_windows,
        }
        for i, det in enumerate(DETECTORS):
            c[f"alerts_{det}"] = self.alerts_total[i]
            c[f"score_{det}"] = round(self.last_scores[i], 4)
        c.update({f"bus_{k}": v for k, v in self.bus.counters().items()})
        return c
