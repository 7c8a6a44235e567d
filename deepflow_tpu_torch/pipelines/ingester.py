"""Ingester assembly: the receiver and every pipeline from one config.

Reference: server/ingester/ingester/ingester.go:67-224 -- loads per-module
configs, builds Receiver + PlatformDataManager, starts all pipelines,
returns closers. Storage can be disabled (`store_path=None`, the
reference's StorageDisabled mode), which leaves decode and export live.

`Ingester(cfg, platform=None, stats=None, device="cuda")` builds what the
JAX package's Ingester builds: the receiver and its six pipelines --
`FlowLogPipeline` (l4 over TAGGEDFLOW and COLUMNAR_FLOW, l7 over
PROTOCOLLOG and OTLP spans, l4_packet over PACKETSEQUENCE),
`FlowMetricsPipeline` (METRICS), `ExtMetricsPipeline` (PROMETHEUS,
TELEGRAF, DFSTATS), `EventPipeline` (PROC_EVENT, ALARM_EVENT),
`ProfilePipeline` (PROFILE) and `DropletPipeline` (SYSLOG, STATSD,
RAW_PCAP) -- so it claims every message type the JAX Ingester claims;
the `Exporters` registry with a circuit breaker per exporter, the sketch
exporter (with its anomaly plane, auditor and autotuner) and the RED
exporter (with its Prometheus `le` buckets when `app_red_prom_buckets`
is set), the store with its disk monitor, the tag dictionaries and geo, and the
operations surface around them: the disk spill on the ingest queues
(`spill_dir`), the self-telemetry timeline with its recording and SLO
rules (`timeline_sample_s`, on at 1.0 s by default), the incident
recorder (`incident_dir`, by default `<store_path>/incidents`), the
Prometheus listener (`prom_port`: /metrics and /healthz) and the UDP
debug server (`debug_port`). `device` is an argument of the builder,
not a config field, so `IngesterConfig` stays field for field the
reference's; it goes to every device-side part, and "cuda" without a
card raises.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from deepflow_tpu_torch.enrich.platform_data import PlatformDataManager
from deepflow_tpu_torch.models.flow_suite import (FlowSuiteConfig,
                                                  check_device)
from deepflow_tpu_torch.pipelines.droplet import DropletPipeline
from deepflow_tpu_torch.pipelines.event import EventPipeline
from deepflow_tpu_torch.pipelines.ext_metrics import ExtMetricsPipeline
from deepflow_tpu_torch.pipelines.flow_log import FlowLogPipeline
from deepflow_tpu_torch.pipelines.flow_metrics import FlowMetricsPipeline
from deepflow_tpu_torch.pipelines.profile import ProfilePipeline
from deepflow_tpu_torch.runtime.breaker import BreakerConfig
from deepflow_tpu_torch.runtime.exporters import Exporters
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.receiver import Receiver
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.store.monitor import DiskMonitor


@dataclass
class IngesterConfig:
    """Mirrors the reference's per-module config blocks
    (flow_log/config/config.go defaults). Field for field, and default
    for default, the JAX package's IngesterConfig, plus
    `tpu_sketch_topk_sample_log2`, which the JAX package's ingester does
    not expose (its FlowSuiteConfig has the same knob)."""

    listen_port: int = 30033
    listen_host: str = "127.0.0.1"
    debug_port: Optional[int] = None     # None disables the UDP debug server
    store_path: Optional[str] = None     # None = StorageDisabled mode
    n_decoders: int = 2
    queue_size: int = 16384
    throttle_per_s: int = 50_000
    store_max_bytes: int = 100 << 30
    rollup_intervals: tuple = (60,)
    # enable the sketch analytics exporter (runtime/tpu_sketch.py);
    # None disables, a float sets window seconds
    tpu_sketch_window_s: Optional[float] = None
    # which wire the sketch lane batches on: "dict" (SmartEncoded
    # news/hits planes, the smallest bytes-per-record) or "lanes"
    # (packed 4-plane batches)
    tpu_sketch_wire: str = "dict"
    # the top-K ring's admission: each batch offers one lane in
    # 2^n to the candidate ring (FlowSuiteConfig.topk_sample_log2).
    # 0 offers every lane, for a stream where most keys never repeat
    # (a spoofed-source flood), whose top-K flows hold few records
    tpu_sketch_topk_sample_log2: int = 4
    # -- overlapped device feed (runtime/feed.py) ----------------------
    # host->device prefetch for the tpu_sketch lane: a supervised feed
    # thread copies and dispatches group N+1 while group N's update runs
    # on the device. 0 = the inline path (bit-identical sketch state
    # either way).
    prefetch_depth: int = 2
    # stage K batches into one group (one copy, one program), amortizing
    # the per-dispatch overhead that dominates at small batch_rows
    coalesce_batches: int = 1
    # -- zero-copy decode->staging (batch/staging.py) -----------------
    # pack decoded chunk columns straight into the recycled staging
    # buffer; the feed path requires it (prefetch_depth > 0 with
    # zero_copy False raises in the exporter)
    zero_copy: bool = True
    # > 0: shard the staging pack across this many supervised worker
    # threads by flow hash, so host packing keeps prefetch_depth full
    # on multi-core hosts; 0 packs on the exporter worker thread
    pack_workers: int = 0
    # -- self-tuning device feed (runtime/autotune.py) ----------------
    # True spawns the feedback controller: a supervised thread that
    # bounded-hill-climbs coalesce_batches / prefetch_depth /
    # pack_workers live from tpu_device_busy_fraction,
    # tpu_feed_stall_seconds and the feed's queue dwell — the static
    # values above become the starting point (and the safe-fallback
    # target on any device error). Bit-invisible to sketch state
    # either way. Requires prefetch_depth > 0.
    autotune: bool = False
    # seconds between control ticks; one knob trial spans two ticks
    # (step, then judge against the occupancy deltas)
    autotune_interval_s: float = 2.0
    # hill-climb bounds: the controller never leaves [1, max]
    autotune_max_coalesce: int = 8
    autotune_max_depth: int = 8
    # -- pod fault domains (parallel/pod.py) --------------------------
    # >= 2 runs the tpu_sketch lane as an epoch-merged pod of
    # single-device shard fault domains (on one card, the shards share
    # it and isolate injected and kernel faults only): each
    # window flush closes a deadline-bounded merge epoch, a straggler
    # past pod_merge_deadline_s is excluded (counted) instead of
    # awaited, a failing shard degrades/rejoins on its own, and the
    # POD-MERGED state is published with shard-participation tags.
    # 0 keeps the single-chip lane.
    tpu_sketch_pod_shards: int = 0
    pod_merge_deadline_s: float = 5.0
    # -- cross-host pod (parallel/multihost.py) -----------------------
    # >= 2 stacks a HOST fault-domain ladder on top of the shard pod:
    # each host runs its own PodFlowSuite, epoch markers and host
    # contributions cross the DCN (torch.distributed collectives in
    # a multiprocess run, an in-process simulated DCN with seeded
    # marker-loss/partition/host-kill injection otherwise), a host past
    # dcn_marker_deadline_s is EXCLUDED (counted) instead of awaited,
    # and a killed host rejoins at an epoch boundary from its snapbus
    # snapshots. 0 keeps the single-host lane.
    pod_hosts: int = 0
    dcn_marker_deadline_s: float = 5.0
    # DCN transport: "auto" picks real collectives when the process
    # joined a torch.distributed run, the simulated DCN otherwise;
    # "sim"/"torch" force one.
    dcn_transport: str = "auto"
    # > 0: a simulated-DCN partition self-heals after this many seconds
    # (chaos runs drive partition + heal without an in-process hook)
    dcn_heal_after_s: float = 0.0
    # -- accuracy observatory (runtime/audit.py) ----------------------
    # deterministic flow-hash sampled exact shadow of the tpu_sketch
    # lane: exact per-key counts / distinct count / entropy for the
    # sampled slice, compared against the device sketch at every window
    # close (the tpu_sketch_accuracy Countable); a sustained bound
    # violation trips the alarm health() reports.
    # Host-side only, bit-invisible to the sketch path. 0 disables.
    audit_sample_rate: float = 1.0 / 64
    # -- anomaly plane (anomaly/) -------------------------------------
    # run the detection lane beside the tpu_sketch lane: per-window
    # entropy-DDoS scoring over a device-resident active-flow working
    # set, streaming-PCA residuals and matrix-profile discords over
    # the golden-signal window series, alert records durable on the
    # anomaly snapshot bus.
    # Requires the tpu_sketch lane; False leaves detection off.
    anomaly_enabled: bool = False
    # entropy-DDoS alert threshold in z units (EWMA-standardized
    # feature-entropy deviation; src dispersion up / dst collapse)
    anomaly_entropy_z: float = 4.0
    # streaming-PCA residual threshold in z units (residual deviation
    # against its own EWMA history)
    anomaly_pca_z: float = 4.0
    # matrix-profile discord threshold (z-normalized subsequence
    # distance of the newest window against all history)
    anomaly_mp_threshold: float = 3.0
    # active-flow working-set size as log2 slots (2^n-entry device
    # table, LRU-by-window eviction); 0 disables the table (the
    # entropy detector still runs off the suite entropies)
    anomaly_active_log2: int = 14
    # windows before any detector may alert (EWMA baselines warm up
    # on a running average over these)
    anomaly_warmup_windows: int = 8
    # per-service RED windows from the l7 stream (runtime/app_red.py);
    # None disables, a float sets window seconds
    app_red_window_s: Optional[float] = None
    # > 0: surface app_red's DDSketch windows as Prometheus `le` bucket
    # counters (every Nth gamma boundary) so histogram_quantile works
    app_red_prom_buckets: int = 0
    # this ingester's id inside a multi-analyzer deployment: the 10
    # analyzer bits of every row _id (l4_flow_log.go genID) — distinct
    # per process or ids collide across ingesters
    analyzer_id: int = 0
    # geo-IP province stamping (enrich/geo.py): a JSON data file path,
    # or None for the built-in synthetic sample ranges; geo_enabled
    # False leaves the province columns zero
    geo_db_path: Optional[str] = None
    geo_enabled: bool = True
    # flight recorder (runtime/tracing.py): span timing through the hot
    # path. True enables the process tracer; False leaves it as it is
    # (another ingester or a test may own it). Tracing costs about one
    # histogram add per batch stage; the device attribution is sampled
    # (every 16th group), so the asynchronous feed keeps its shape
    trace_enabled: bool = True
    # Prometheus text-exposition listener (/metrics, /healthz); None
    # disables it (reference: the :9526 stats/pprof listener)
    prom_port: Optional[int] = None
    # -- resilience (runtime/supervisor.py, breaker.py, faults.py) ----
    # deadman watchdog: a supervised worker whose last heartbeat is
    # older than this is counted stale (detection only). 0 disables.
    supervisor_deadman_s: float = 60.0
    # crash-restart backoff base (doubles per consecutive crash, capped
    # at 100x base, deterministic jitter)
    supervisor_backoff_s: float = 0.05
    # per-exporter circuit breakers around the decode->export fan-out;
    # False runs unwrapped (errors still contained, never quarantined)
    breaker_enabled: bool = True
    breaker_failure_rate: float = 0.5   # window fraction that trips
    breaker_min_calls: int = 4          # outcomes before a trip decision
    breaker_open_s: float = 5.0         # quarantine before half-open
    breaker_half_open_probes: int = 2   # probes that must all succeed
    # a put() slower than this counts as a failure; None disables
    breaker_latency_budget_s: Optional[float] = None
    # deterministic fault injection (runtime/faults.py spec string,
    # e.g. "exporter.raise:p=1,for_s=5;seed=7"); also read from the
    # DEEPFLOW_FAULTS env var — config wins when both are set
    fault_spec: Optional[str] = None
    # -- durability (disk spill for the ingest queues) -----------------
    # None disables (overload falls back to overwrite-oldest); a path
    # arms runtime/spill.py on every ingest queue. The segment knobs
    # below are inert without it.
    spill_dir: Optional[str] = None
    spill_segment_bytes: int = 1 << 20    # roll (fsync) cadence
    spill_budget_bytes: int = 64 << 20    # oldest-segment eviction past this
    spill_watermark: float = 0.75         # ring fraction that starts spilling
    # drain ladder (close()): how long to wait for queues + exporters
    # to flush
    drain_deadline_s: float = 5.0
    # -- self-telemetry timeline (runtime/timeline.py) ----------------
    # sampler cadence of the in-process TSDB over every Countable; the
    # SLO burn-rate rules and the incident recorder ride its tick.
    # 0 disables it
    timeline_sample_s: float = 1.0
    # hot per-series ring capacity (samples); the oldest sample past
    # this either graduates to the coarse tier or is dropped counted
    timeline_hot_samples: int = 600
    # every Nth evicted hot sample joins the coarse tier (same
    # capacity -> Nx the lookback at 1/N resolution); 0 disables it
    timeline_coarse_every: int = 10
    # -- SLO burn-rate rules (on the sampler tick) ---------------------
    # shared objective for the declared SLOs (ingest availability off
    # the conservation-ledger loss counters; serving p99; detection
    # latency); burn rate = error fraction / (1 - objective)
    slo_objective: float = 0.999
    # serving p99 bound (seconds) the querier-read SLO holds against
    slo_serving_p99_s: float = 0.05
    # detection-latency bound (windows behind live) for the anomaly SLO
    slo_detect_latency_windows: float = 2.0
    # fast-window (5m) burn rate that counts as fast-burning — feeds
    # health()["slo_burning"] and the incident trigger (14.4 burns a
    # 0.999 objective's monthly budget in about two days)
    slo_fast_burn: float = 14.4
    # -- incident flight recorder (runtime/incident.py) ---------------
    # bundle directory; None defaults to <store_path>/incidents (off
    # without a store). It rides the timeline: off when that is off
    incident_dir: Optional[str] = None
    incident_budget_bytes: int = 64 << 20  # oldest bundles evicted past
    incident_min_interval_s: float = 30.0  # global capture rate limit
    incident_window_s: float = 120.0       # timeline lookback per bundle



class Ingester:
    """One-call construction of the receive -> decode -> export -> store
    data plane."""

    def __init__(self, cfg: IngesterConfig,
                 platform: Optional[PlatformDataManager] = None,
                 stats: Optional[StatsRegistry] = None,
                 device="cuda") -> None:
        self.device = check_device(device)
        self.cfg = cfg
        self.stats = stats or StatsRegistry()
        self.tracer = default_tracer()
        if cfg.trace_enabled:
            self.tracer.enable()
        self.stats.register("tracer", self.tracer.counters)
        # every worker thread below spawns through the process
        # supervisor: crash capture, backoff restart, deadman watchdog
        self.supervisor = default_supervisor()
        self.supervisor.deadman_s = cfg.supervisor_deadman_s or None
        self.supervisor.backoff_base_s = cfg.supervisor_backoff_s
        self.supervisor.backoff_cap_s = 100 * cfg.supervisor_backoff_s
        self.stats.register("supervisor", self.supervisor.counters)
        # deterministic chaos from config or env; close() disarms
        # exactly what this instance armed
        self.faults = default_faults()
        self._armed_sites: list = []
        spec = cfg.fault_spec or os.environ.get("DEEPFLOW_FAULTS")
        if spec:
            self._armed_sites = self.faults.arm_spec(spec)
            self.stats.register("faults", self.faults.counters)
        breaker_cfg = None
        if cfg.breaker_enabled:
            breaker_cfg = BreakerConfig(
                failure_rate=cfg.breaker_failure_rate,
                min_calls=cfg.breaker_min_calls,
                open_s=cfg.breaker_open_s,
                half_open_probes=cfg.breaker_half_open_probes,
                latency_budget_s=cfg.breaker_latency_budget_s)
        self.platform = platform or PlatformDataManager(stats=self.stats)
        self.exporters = Exporters(stats=self.stats,
                                   breaker_cfg=breaker_cfg)
        self.store: Optional[Store] = None
        self.monitor: Optional[DiskMonitor] = None
        if cfg.store_path is not None:
            os.makedirs(cfg.store_path, exist_ok=True)
            self.store = Store(cfg.store_path)
            self.monitor = DiskMonitor(self.store, cfg.store_max_bytes)
            self.stats.register("ckmonitor", self.monitor.counters)
        self.tag_dicts = TagDictRegistry(cfg.store_path)
        # a caller-supplied PlatformDataManager keeps its own geo choice
        if platform is None and cfg.geo_enabled:
            from deepflow_tpu_torch.enrich.geo import load_geo_table
            self.platform.geo = load_geo_table(cfg.geo_db_path,
                                               self.tag_dicts)
        self.tpu_sketch = None
        self.autotuner = None
        if cfg.tpu_sketch_window_s is not None:
            from deepflow_tpu_torch.runtime.tpu_sketch import \
                TpuSketchExporter
            ckpt_dir = None if cfg.store_path is None else \
                os.path.join(cfg.store_path, "sketch_ckpt")
            anomaly = None
            anomaly_dir = None
            if cfg.anomaly_enabled:
                from deepflow_tpu_torch.anomaly import AnomalyConfig
                anomaly = AnomalyConfig(
                    active_log2=cfg.anomaly_active_log2,
                    entropy_z=cfg.anomaly_entropy_z,
                    pca_z=cfg.anomaly_pca_z,
                    mp_threshold=cfg.anomaly_mp_threshold,
                    warmup_windows=cfg.anomaly_warmup_windows)
                anomaly_dir = None if cfg.store_path is None else \
                    os.path.join(cfg.store_path, "anomaly_ckpt")
            self.tpu_sketch = TpuSketchExporter(
                cfg=FlowSuiteConfig(
                    topk_sample_log2=cfg.tpu_sketch_topk_sample_log2),
                store=self.store, window_seconds=cfg.tpu_sketch_window_s,
                checkpoint_dir=ckpt_dir, stats=self.stats,
                wire=cfg.tpu_sketch_wire,
                prefetch_depth=cfg.prefetch_depth,
                coalesce_batches=cfg.coalesce_batches,
                zero_copy=cfg.zero_copy,
                pack_workers=cfg.pack_workers,
                pod_shards=cfg.tpu_sketch_pod_shards,
                pod_merge_deadline_s=cfg.pod_merge_deadline_s,
                pod_hosts=cfg.pod_hosts,
                dcn_marker_deadline_s=cfg.dcn_marker_deadline_s,
                dcn_transport=cfg.dcn_transport,
                dcn_heal_after_s=cfg.dcn_heal_after_s,
                audit_rate=cfg.audit_sample_rate,
                anomaly=anomaly, anomaly_dir=anomaly_dir,
                device=self.device)
            self.exporters.register(self.tpu_sketch)
            # the controller holds the feed's knobs from here on; cfg's
            # values are its starting point and fallback target
            if cfg.autotune and self.tpu_sketch._feed is not None:
                from deepflow_tpu_torch.runtime.autotune import \
                    FeedAutotuner
                self.autotuner = FeedAutotuner(
                    self.tpu_sketch,
                    interval_s=cfg.autotune_interval_s,
                    max_coalesce=cfg.autotune_max_coalesce,
                    max_depth=cfg.autotune_max_depth)
                self.stats.register("exporter.tpu_autotune",
                                    self.autotuner.counters)
            if self.tpu_sketch.anomaly is not None:
                # alerts ride the breaker-wrapped fan-out on stream
                # "anomaly"
                self.tpu_sketch.anomaly.attach_exporters(self.exporters)
        self.app_red = None
        if cfg.app_red_window_s is not None:
            from deepflow_tpu_torch.runtime.app_red import AppRedExporter
            self.app_red = AppRedExporter(
                store=self.store, window_seconds=cfg.app_red_window_s,
                stats=self.stats, tag_dicts=self.tag_dicts,
                prom_bucket_stride=cfg.app_red_prom_buckets,
                device=self.device)
            self.exporters.register(self.app_red)
        self.receiver = Receiver(port=cfg.listen_port, host=cfg.listen_host,
                                 stats=self.stats)
        self.flow_log = FlowLogPipeline(
            self.receiver, self.store, self.platform, self.exporters,
            n_decoders=cfg.n_decoders, queue_size=cfg.queue_size,
            throttle_per_s=cfg.throttle_per_s, stats=self.stats,
            tag_dicts=self.tag_dicts, analyzer_id=cfg.analyzer_id)
        self.flow_metrics = FlowMetricsPipeline(
            self.store, self.exporters,
            n_unmarshallers=cfg.n_decoders, queue_size=cfg.queue_size,
            rollup_intervals=cfg.rollup_intervals, device=self.device,
            receiver=self.receiver, stats=self.stats)
        self.ext_metrics = ExtMetricsPipeline(
            self.receiver, self.store, self.tag_dicts, stats=self.stats)
        self.event = EventPipeline(
            self.receiver, self.store, self.tag_dicts, stats=self.stats)
        self.profile = ProfilePipeline(
            self.receiver, self.store, self.tag_dicts, stats=self.stats)
        droplet_dir = None if cfg.store_path is None else \
            os.path.join(cfg.store_path, "droplet")
        self.droplet = DropletPipeline(
            self.receiver, self.store, self.tag_dicts, droplet_dir,
            stats=self.stats)
        self._pipelines = (self.flow_log, self.flow_metrics,
                           self.ext_metrics, self.event, self.profile,
                           self.droplet)
        self._drain_state = "running"
        self._janitor = None
        self._janitor_stop = threading.Event()
        # durability: disk spill on every ingest queue; segments a
        # previous process left behind replay once start() runs
        self.spill = None
        if cfg.spill_dir is not None:
            from deepflow_tpu_torch.runtime.spill import SpillGroup
            self.spill = SpillGroup(
                self._own_queues(), cfg.spill_dir,
                segment_bytes=cfg.spill_segment_bytes,
                budget_bytes=cfg.spill_budget_bytes,
                watermark=cfg.spill_watermark)
            self.stats.register("spill", self.spill.counters)
        self.timeline = None
        self.incidents = None
        self._incident_watcher = None
        if cfg.timeline_sample_s > 0:
            self._build_timeline(cfg)
        self.prom = None
        if cfg.prom_port is not None:
            from deepflow_tpu_torch.runtime.promexpo import \
                PrometheusExporter
            self.prom = PrometheusExporter(stats=self.stats,
                                           tracer=self.tracer,
                                           port=cfg.prom_port,
                                           health=self.health,
                                           timeline=self.timeline)
        self.debug = None
        if cfg.debug_port is not None:
            self._build_debug(cfg)

    def _build_timeline(self, cfg: IngesterConfig) -> None:
        """The self-telemetry timeline with the reference's recording
        rules and SLOs, and the incident recorder on its tick. Host-side
        only: the device state is the same with it on or off."""
        from deepflow_tpu_torch.runtime.profiler import default_profiler
        from deepflow_tpu_torch.runtime.timeline import (RecordingRule,
                                                         SloRule, Timeline)
        self.timeline = Timeline(
            sample_s=cfg.timeline_sample_s,
            hot_samples=cfg.timeline_hot_samples,
            coarse_every=cfg.timeline_coarse_every,
            stats=self.stats, tracer=self.tracer,
            profiler=default_profiler(),
            fast_burn_threshold=cfg.slo_fast_burn)
        # derived lane rates over 10 ticks (the staleness horizon)
        rate_win = 10.0 * cfg.timeline_sample_s

        def _per_s(metric):
            def fn(tl, now):
                return tl._window_delta(metric, now - rate_win, now) \
                    / rate_win
            return fn

        self.timeline.add_rule(RecordingRule(
            "ingest_frames_per_s", _per_s("receiver_rx_frames")))
        self.timeline.add_rule(RecordingRule(
            "sketch_rows_per_s", _per_s("tpu_sketch_rows_in")))
        # declared SLOs: availability off the loss counters, serving
        # p99, detection latency
        self.timeline.add_slo(SloRule(
            "ingest_availability", objective=cfg.slo_objective,
            kind="ratio",
            bad=("receiver_rx_dropped", "exporters_put_errors",
                 "exporters_shed"),
            total=("receiver_rx_frames",)))
        self.timeline.add_slo(SloRule(
            "serving_p99", objective=cfg.slo_objective,
            kind="threshold", series="querier_read_p99_s",
            bound=cfg.slo_serving_p99_s))
        self.timeline.add_slo(SloRule(
            "detection_latency", objective=cfg.slo_objective,
            kind="threshold", series="anomaly_detect_latency_windows",
            bound=cfg.slo_detect_latency_windows))
        self.stats.register("timeline", self.timeline.counters)
        incident_dir = cfg.incident_dir
        if incident_dir is None and cfg.store_path is not None:
            incident_dir = os.path.join(cfg.store_path, "incidents")
        if incident_dir is None:
            return
        from deepflow_tpu_torch.runtime.incident import (IncidentRecorder,
                                                         IncidentWatcher)
        buses = {}
        if self.tpu_sketch is not None:
            buses["sketch"] = self.tpu_sketch.snapshot_bus
            if self.tpu_sketch.anomaly is not None:
                buses["anomaly"] = self.tpu_sketch.anomaly.bus
        self.incidents = IncidentRecorder(
            incident_dir, timeline=self.timeline,
            profiler=default_profiler(), stats=self.stats,
            snapbuses=buses, budget_bytes=cfg.incident_budget_bytes,
            min_interval_s=cfg.incident_min_interval_s,
            window_s=cfg.incident_window_s)
        self.stats.register("incidents", self.incidents.counters)
        anomaly = None if self.tpu_sketch is None \
            else self.tpu_sketch.anomaly
        self._incident_watcher = IncidentWatcher(
            self.incidents, health_fn=self.health,
            breakers_fn=self.exporters.breakers,
            alerts_fn=None if anomaly is None else
            (lambda: float(sum(anomaly.alerts_total))),
            timeline=self.timeline)
        self.timeline.add_tick_hook(self._incident_watcher.tick)

    def _build_debug(self, cfg: IngesterConfig) -> None:
        """The UDP debug server with the ingester's commands."""
        from deepflow_tpu_torch.runtime.debug import DebugServer
        self.debug = DebugServer(self.stats, port=cfg.debug_port,
                                 tracer=self.tracer)
        self.debug.register(
            "vtap-status",
            lambda req: {f"{v}:{t}": vars(st) for (v, t), st
                         in self.receiver.status().items()})
        self.debug.register("artifacts", self._artifact_listing)
        self.debug.register("datasource", self._datasource_cmd)
        self.debug.register("queues", self._queues_cmd)
        self.debug.register("queue-tap", self._queue_tap_cmd)
        # `supervisor` is DebugServer's built-in (process-scoped)
        self.debug.register("breakers",
                            lambda req: self.exporters.breakers())
        self.debug.register("spill", self._spill_cmd)

    def health(self) -> dict:
        """Liveness verdict: not ok when a supervised worker is
        deadman-stale, an exporter breaker is open, the sketch lane is
        degraded or its accuracy alarm is tripped, a pod shard or host is
        down, or the drain ladder runs. `drain` is the ladder's rung:
        "running", "draining", "drained"."""
        sup = self.supervisor.counters()
        open_breakers = [n for n, c in self.exporters.breakers().items()
                         if c["state"] == "open"]
        degraded = bool(self.tpu_sketch is not None
                        and self.tpu_sketch.degraded)
        accuracy_alarm = bool(self.tpu_sketch is not None
                              and self.tpu_sketch.audit_alarm)
        draining = self._drain_state != "running"
        out = {
            "ok": not (sup["stale"] or open_breakers or degraded
                       or accuracy_alarm or draining),
            "drain": self._drain_state,
            "stale_threads": sup["stale"],
            "crashes": sup["crashes"],
            "restarts": sup["restarts"],
            "open_breakers": open_breakers,
            "degraded_tpu_sketch": degraded,
            "accuracy_alarm": accuracy_alarm,
        }
        # informational: fast-burning SLOs, not folded into `ok` (burn
        # lags its cause, which already turned a breaker or a counter)
        if self.timeline is not None:
            out["slo_burning"] = self.timeline.fast_burning()
        pod = None if self.tpu_sketch is None else self.tpu_sketch.pod
        if pod is not None:
            status = pod.shard_status()
            out["pod_shards"] = len(status)
            out["pod_shards_active"] = sum(
                1 for s in status if s["status"] == "active")
            out["pod_shards_degraded"] = [
                s["shard"] for s in status if s["status"] == "degraded"]
            out["pod_shards_lost"] = [
                s["shard"] for s in status if s["status"] == "lost"]
            if out["pod_shards_active"] < len(status):
                out["ok"] = False
            if hasattr(pod, "host_status"):
                hosts = pod.host_status()
                out["pod_hosts"] = len(hosts)
                out["pod_hosts_active"] = sum(
                    1 for h in hosts if h["status"] == "active")
                out["pod_hosts_lost"] = [
                    h["host"] for h in hosts if h["status"] == "lost"]
                out["pod_links_down"] = [
                    h["host"] for h in hosts if not h["link_up"]]
                if out["pod_hosts_active"] < len(hosts):
                    out["ok"] = False
        return out

    def _own_queues(self) -> dict:
        """This ingester's inter-stage MultiQueues by name."""
        out = {q.name: q for _, q in self.flow_log._streams}
        for p in (self.flow_metrics, self.ext_metrics, self.event,
                  self.profile, self.droplet):
            q = getattr(p, "queues", None)
            if q is not None:
                out[q.name] = q
        return out

    def _spill_cmd(self, req: dict) -> dict:
        """Per-queue disk-spill accounting (the `spill` debug command)."""
        if self.spill is None:
            return {"enabled": False}
        want = req.get("module") or ""
        return {"enabled": True, "drain": self._drain_state,
                "queues": {name: c for name, c in sorted(
                    self.spill.per_queue().items()) if want in name}}

    def _queues_cmd(self, req: dict) -> dict:
        """Every inter-stage queue's in/out/overwritten/spilled/pending."""
        want = req.get("module") or ""
        return {name: q.counters()
                for name, q in sorted(self._own_queues().items())
                if want in name}

    def _queue_tap_cmd(self, req: dict) -> dict:
        """Sample up to `count` items flowing through a named queue. The
        wait is clamped below the client's 2 s datagram timeout (the
        debug loop answers one request at a time)."""
        name = req.get("module") or ""
        q = self._own_queues().get(name)
        if q is None:
            return {"error": f"unknown queue {name!r} "
                             "(list with the queues command)"}
        count = min(int(req.get("count", 3)), 20)
        wait_s = min(max(float(req.get("wait_s", 1.0)), 0.0), 1.5)
        q.tap(count)
        try:
            deadline = time.time() + wait_s
            items: list = []
            while time.time() < deadline:
                items.extend(q.tap_take())
                if len(items) >= count:
                    break
                time.sleep(0.05)
            items.extend(q.tap_take())
        finally:
            q.untap()
        return {"queue": name, "sampled": items[:count]}

    def _datasource_cmd(self, req: dict) -> dict:
        """Rollup-tier CRUD (`deepflow-ctl domain datasource`). op: list
        | add | del | retention; add/del/retention take interval
        (seconds, whole minutes), add and retention take ttl (seconds,
        0 = keep forever)."""
        rollups = self.flow_metrics.rollups
        if rollups is None:
            return {"error": "storage disabled: no rollup tiers"}
        op = req.get("op", "list")
        if op not in ("list", "add", "del", "retention"):
            return {"error": f"unknown op {op!r}"}
        try:
            if op == "list":
                return {"datasources": rollups.list_datasources()}
            interval = int(req["interval"])
            if op == "add":
                ttl = req.get("ttl")
                from deepflow_tpu_torch.store.rollup import TTL_DERIVE
                return rollups.add_interval(
                    interval, TTL_DERIVE if ttl is None else int(ttl))
            if op == "del":
                ok = rollups.remove_interval(
                    interval, drop_data=bool(req.get("drop", True)))
                return {"deleted": ok, "interval": interval}
            # retention: an explicit ttl is required; 0 = keep forever
            ttl = req.get("ttl")
            if ttl is None:
                return {"error": "retention requires ttl "
                                 "(seconds; 0 = keep forever)"}
            ok = rollups.set_retention(interval,
                                       None if int(ttl) == 0 else int(ttl))
            return {"updated": ok, "interval": interval}
        except KeyError as e:
            return {"error": f"missing field {e}"}
        except ValueError as e:
            return {"error": str(e)}

    def _artifact_listing(self, req: dict) -> dict:
        """Stored droplet artifacts under `<store_path>/droplet`, names
        and sizes, truncated to one datagram's budget."""
        out_dir = self.droplet.out_dir
        if out_dir is None or not os.path.isdir(out_dir):
            return {"dir": out_dir, "files": []}
        want = req.get("module") or ""
        names = [n for n in sorted(os.listdir(out_dir)) if want in n]
        files = []
        for name in names[:500]:
            p = os.path.join(out_dir, name)
            if os.path.isfile(p):
                files.append({"name": name, "bytes": os.path.getsize(p)})
        out = {"dir": out_dir, "files": files}
        if len(names) > 500:
            out["truncated"] = len(names) - 500
        return out

    def start(self) -> None:
        self.exporters.start()
        for p in self._pipelines:
            p.start()
        if self.monitor is not None:
            self.monitor.start()
        if self.debug is not None:
            self.debug.start()
        if self.prom is not None:
            self.prom.start()
        self._janitor_stop.clear()

        def _janitor():
            # throttle-bucket roll on wall clock, so a quiet stream's
            # rows reach the writer within one bucket width
            while not self._janitor_stop.wait(1.0):
                self.supervisor.beat()
                for p in self._pipelines:
                    tick = getattr(p, "tick", None)
                    if tick is not None:
                        tick()
        self._janitor = self.supervisor.spawn(
            "throttle-janitor", _janitor, beat_period_s=1.0)
        if self.spill is not None:
            # replay before receive: the drain threads re-inject what a
            # previous process left while the listener comes up
            self.spill.start()
        if self.timeline is not None:
            self.timeline.register_datasource()
            if self.incidents is not None:
                self.incidents.register_datasource()
            self.timeline.start(self.supervisor)
        if self.autotuner is not None:
            self.autotuner.start()
        self.receiver.start()  # last, like the reference (ingester.go:220)

    def flush(self) -> None:
        """Drain throttlers and writers to disk (tests and shutdown)."""
        for p in self._pipelines:
            p.flush()
        if self.tpu_sketch is not None:
            self.tpu_sketch.flush()
        if self.app_red is not None:
            self.app_red.flush()
        self.tag_dicts.flush()

    def _drain_wait(self, deadline: float) -> bool:
        """Wait (bounded) for the ingest queues, then the exporter
        queues and the feed's groups in flight, to empty; decoders and
        exporter workers still run. True = fully drained."""
        queues = list(self._own_queues().values())

        def drained() -> bool:
            return (all(len(q) == 0 for q in queues)
                    and self.exporters.pending() == 0
                    and (self.spill is None
                         or self.spill.pending_segments() == 0))

        while time.monotonic() < deadline:
            if drained():
                return True
            time.sleep(0.05)
        return drained()

    def close(self) -> None:
        """The drain ladder: stop accepting, let decoders and exporters
        flush under `drain_deadline_s`, take a final sketch checkpoint,
        park what never drained in spill segments for the next start,
        tear down. health() reports the rung through `drain`."""
        self._drain_state = "draining"
        # the sampler first: its tick hooks read health() and the
        # breakers, which are about to be torn down under it
        if self.timeline is not None:
            self.timeline.stop()
            self.timeline.unregister_datasource()
            if self.incidents is not None:
                self.incidents.unregister_datasource()
        # then the controller: knob moves during teardown would race the
        # ladder's own barriers for no benefit
        if self.autotuner is not None:
            self.autotuner.close()
        started = self._janitor is not None
        if started:
            self._janitor_stop.set()
            self._janitor.stop()
            self._janitor.join(timeout=2)
            # rung 1: close the listener, let established connections
            # dispatch their kernel-buffered bytes (bounded)
            self.receiver.quiesce(
                deadline_s=max(0.5, self.cfg.drain_deadline_s / 4))
        self.receiver.close()
        # rung 2: bounded flush while pipelines and exporters still run
        drained = True
        if started:
            drained = self._drain_wait(
                time.monotonic() + self.cfg.drain_deadline_s)
            self.flush()
        # rung 3: the final sketch checkpoint
        if self.tpu_sketch is not None:
            self.tpu_sketch.checkpoint_now()
        # rung 4: park the undrained remainder on disk, counted, for the
        # next start's replay
        if self.spill is not None:
            self.spill.close(spill_remaining=not drained)
        for p in self._pipelines:
            p.close()
        if self.monitor is not None:
            self.monitor.close()
            self.stats.deregister("ckmonitor")
        self.exporters.close()
        self._drain_state = "drained"
        if self.debug is not None:
            self.debug.close()
        if self.prom is not None:
            self.prom.close()
        self.tag_dicts.close()
        self.stats.deregister("tracer")
        self.stats.deregister("supervisor")
        if self.autotuner is not None:
            self.stats.deregister("exporter.tpu_autotune")
        for name, on in (("timeline", self.timeline),
                         ("incidents", self.incidents),
                         ("spill", self.spill)):
            if on is not None:
                self.stats.deregister(name)
        for site in self._armed_sites:
            self.faults.disarm(site)
        if self._armed_sites:
            self.stats.deregister("faults")
            self._armed_sites = []

    @property
    def port(self) -> int:
        return self.receiver.bound_port

    @property
    def prom_port(self) -> Optional[int]:
        """The bound metrics-endpoint port, or None when exposition is
        off."""
        return None if self.prom is None else self.prom.port
