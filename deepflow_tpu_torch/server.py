"""All-in-one server: controller + ingester + querier in one process.

A copy of the JAX package's `server.py` (reference:
server/cmd/server/main.go, one binary that starts the controller
(election -> resource model -> trisolaris), the ingester (receiver +
pipelines) and the querier behind one config file, with a config
watcher that rebuilds on change, ingester/config/watcher.go):
`Server(config_path, device="cuda").start()`, or

    python -m deepflow_tpu_torch.server [-f server.json] [--device cuda]

Config (YAML where PyYAML is installed, else JSON; JSON is a subset of
YAML, so a JSON file reads the same either way; every key optional):

    {"controller": {"enabled": true, "port": 20417,
                    "lease_path": "/tmp/df-lease.json",
                    "grpc_enabled": true, "grpc_port": 30035},
     "ingester": {"port": 30033, "store_path": "/var/lib/deepflow-tpu",
                  "debug_port": 30035, "throttle_per_s": 50000,
                  "tpu_sketch_window_s": 1.0, "app_red_window_s": 1.0,
                  "app_red_prom_buckets": 8},
     "querier": {"enabled": true, "port": 20416},
     "self_telemetry": true}

The controller keeps its state files (`model.json`, `vtaps.json`,
`lease.json`, `tagrecorder/`) under `ingester.store_path`, or
<tmp>/deepflow-tpu without one (the JAX package's server: /tmp, here the
temporary directory, /tmp unless TMPDIR names another); its trident gRPC
bridge is skipped where grpcio is not installed. Its default `grpc_port`
30035 is also the `debug_port` above: a config with both on that port
fails to start.

The `ingester` keys the JAX package's server reads (`port`, `host`,
`store_path`, `debug_port`, `n_decoders`, `throttle_per_s`,
`store_max_bytes`, `tpu_sketch_window_s`, `app_red_window_s`) map as it
maps them, with its defaults; any other key that names an
`IngesterConfig` field (`app_red_prom_buckets`, `prom_port`, ...) is
passed through, where the JAX package's server ignores it. With
`self_telemetry` the ingester's counters ship back into its own socket
as DFSTATS (`runtime/stats.StatsShipper`) and land in deepflow_system.
The querier mounts the sketch lane's and the anomaly plane's snapshot
buses as the `sketch` and `anomaly` datasources when those run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import tempfile
import threading
from typing import Optional

from deepflow_tpu_torch.runtime.supervisor import default_supervisor

# the ingester keys the JAX package's server maps, with its defaults
_INGESTER_KEYS = (
    ("port", "listen_port", 30033),
    ("host", "listen_host", "127.0.0.1"),
    ("store_path", "store_path", None),
    ("debug_port", "debug_port", None),
    ("n_decoders", "n_decoders", 2),
    ("throttle_per_s", "throttle_per_s", 50_000),
    ("store_max_bytes", "store_max_bytes", 100 << 30),
    ("tpu_sketch_window_s", "tpu_sketch_window_s", None),
    ("app_red_window_s", "app_red_window_s", None),
)


def load_config(path: Optional[str]) -> dict:
    """The config file as a dict ({} when there is none): YAML through
    PyYAML where it is installed, else JSON."""
    if path is None or not os.path.exists(path):
        return {}
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        return yaml.safe_load(text) or {}
    if not text.strip():
        return {}
    try:
        return json.loads(text) or {}
    except ValueError as e:
        raise ValueError(
            f"{path}: PyYAML is not installed, so the config must be "
            f"JSON (a subset of YAML), and it is not: {e}") from None


def ingester_config(ing_cfg: dict):
    """The `ingester` block of a config as an IngesterConfig."""
    from deepflow_tpu_torch.pipelines import IngesterConfig

    kw = {field: ing_cfg.get(key, default)
          for key, field, default in _INGESTER_KEYS}
    mapped = {key for key, _, _ in _INGESTER_KEYS}
    fields = {f.name for f in dataclasses.fields(IngesterConfig)}
    kw.update({k: v for k, v in ing_cfg.items()
               if k not in mapped and k in fields})
    return IngesterConfig(**kw)


class Server:
    def __init__(self, config_path: Optional[str] = None,
                 device="cuda") -> None:
        self.config_path = config_path
        self.device = device
        self.cfg = load_config(config_path)
        self._watch_thread = None      # supervisor ThreadHandle
        self.reload_error: Optional[str] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._build()

    # -- construction --------------------------------------------------------
    def _build(self) -> None:
        from deepflow_tpu_torch.controller import (ControllerServer,
                                                   ResourceModel,
                                                   VTapRegistry)
        from deepflow_tpu_torch.controller.election import Election
        from deepflow_tpu_torch.controller.monitor import FleetMonitor
        from deepflow_tpu_torch.controller.platform_compiler import \
            PlatformPusher
        from deepflow_tpu_torch.controller.tagrecorder import TagRecorder
        from deepflow_tpu_torch.pipelines import Ingester
        from deepflow_tpu_torch.querier.server import QuerierServer
        from deepflow_tpu_torch.runtime.stats import StatsShipper

        c = self.cfg
        ing_cfg = c.get("ingester", {})
        store_path = ing_cfg.get("store_path")

        ctl_cfg = c.get("controller", {})
        self.controller = None
        self.election = None
        self.tagrecorder = None
        if ctl_cfg.get("enabled", True):
            state_dir = store_path or os.path.join(tempfile.gettempdir(),
                                                   "deepflow-tpu")
            os.makedirs(state_dir, exist_ok=True)
            self.model = ResourceModel(os.path.join(state_dir, "model.json"))
            self.registry = VTapRegistry(
                os.path.join(state_dir, "vtaps.json"))
            self.monitor = FleetMonitor(self.registry)
            self.election = Election(
                ctl_cfg.get("lease_path",
                            os.path.join(state_dir, "lease.json")))
            self.tagrecorder = TagRecorder(self.model, root=state_dir)
            self.controller = ControllerServer(
                self.model, self.registry, self.monitor,
                election=self.election, tagrecorder=self.tagrecorder,
                port=ctl_cfg.get("port", 20417),
                host=ctl_cfg.get("host", "127.0.0.1"))

        self.ingester = Ingester(ingester_config(ing_cfg),
                                 device=self.device)
        if self.controller is not None:
            # the in-process ingester enriches from this controller's model
            PlatformPusher(self.model, self.ingester.platform)
        # the trident gRPC bridge: the reference agent's control plane
        # (message/trident.proto Synchronizer) over the same registry.
        # grpc_port 0 = ephemeral; no grpcio = skipped
        self.trident_grpc = None
        self._grpc_parts = None
        if self.controller is not None and \
                ctl_cfg.get("grpc_enabled", True):
            try:
                from deepflow_tpu_torch.controller import trident_grpc
                self._grpc_parts = (trident_grpc,
                                    ctl_cfg.get("grpc_port", 30035),
                                    ctl_cfg.get("host", "127.0.0.1"))
            except ImportError:
                pass          # grpcio not installed: JSON sync only

        q_cfg = c.get("querier", {})
        self.querier = None
        self.sketch_tables = None
        self.anomaly_tables = None
        if q_cfg.get("enabled", True) and self.ingester.store is not None:
            # the sketch lane's snapshot bus as the `sketch` datasource
            # (SQL SELECT sketch.*, PromQL sketch_*()): reads come from
            # the in-process cache, never the card or the feed
            if self.ingester.tpu_sketch is not None:
                from deepflow_tpu_torch.serving import (SketchTables,
                                                        SnapshotCache)
                cache = SnapshotCache(
                    self.ingester.tpu_sketch.snapshot_bus,
                    max_staleness_s=q_cfg.get("sketch_max_staleness_s",
                                              5.0))
                self.sketch_tables = SketchTables(cache)
                self.sketch_tables.register_datasource()
                self.ingester.stats.register("serving",
                                             self.sketch_tables.counters)
                # the anomaly plane's alert bus as the `anomaly`
                # datasource (SELECT * FROM anomaly, anomaly_score{...})
                if self.ingester.tpu_sketch.anomaly is not None:
                    from deepflow_tpu_torch.serving import AnomalyTables
                    acache = SnapshotCache(
                        self.ingester.tpu_sketch.anomaly.bus,
                        max_staleness_s=q_cfg.get(
                            "sketch_max_staleness_s", 5.0))
                    self.anomaly_tables = AnomalyTables(acache)
                    self.anomaly_tables.register_datasource()
                    self.ingester.stats.register(
                        "serving_anomaly", self.anomaly_tables.counters)
            self.querier = QuerierServer(
                self.ingester.store, self.ingester.tag_dicts,
                port=q_cfg.get("port", 20416),
                host=q_cfg.get("host", "127.0.0.1"),
                tagrecorder=self.tagrecorder,
                external_apm=q_cfg.get("external_apm", []),
                sketch=self.sketch_tables,
                anomaly=self.anomaly_tables,
                device=self.device)

        self.stats_shipper = None
        if c.get("self_telemetry", True):
            # the server monitors itself through its own firehose
            addr = f"127.0.0.1:{ing_cfg.get('port', 30033)}"
            self.stats_shipper = StatsShipper(self.ingester.stats, addr)
            if self.controller is not None:
                # the controller's self-report rides the same DFSTATS
                # loop (reference: controller statsd -> deepflow_system)
                stats = self.ingester.stats
                stats.register("controller.recorder",
                               self.controller.recorder.counters)
                stats.register("controller.genesis",
                               self.controller.genesis_sync.counters)
                stats.register(
                    "controller.fleet",
                    lambda: {"vtaps": len(self.registry.list()),
                             "ingesters": len(self.monitor.ingesters()),
                             "resources": len(self.model.list()),
                             "model_version": self.model.version,
                             "is_leader": int(self.election.is_leader)
                             if self.election else 1})

    # -- lifecycle -----------------------------------------------------------
    def _start_components(self) -> None:
        """The one start sequence of start() and reload()."""
        if self.election is not None:
            self.election.start()
        if self.controller is not None:
            self.controller.start()
        if self._grpc_parts is not None:
            mod, port, host = self._grpc_parts
            server, bound, svc = mod.serve(
                self.registry, self.controller.package_bytes,
                platform_version=lambda: self.model.version,
                genesis_report=self.controller.genesis_report,
                assign=self.monitor.assign,
                host=host, port=port)
            if bound == 0:
                # grpc's add_insecure_port reports a bind failure as 0,
                # and start() would otherwise go on deaf
                server.stop(grace=0)
                raise OSError(
                    f"trident gRPC bridge failed to bind {host}:{port}")
            self.trident_grpc = (server, bound, svc)
        self.ingester.start()
        if self.stats_shipper is not None:
            # the shipper targets the bound port (the config's may be 0)
            self.stats_shipper.sender.set_target(
                f"127.0.0.1:{self.ingester.port}")
            self.ingester.stats.start(interval_s=10.0)
        if self.querier is not None:
            self.querier.start()

    def start(self) -> None:
        self._start_components()
        if self.config_path is not None:
            # supervised: a reload that raises past its guard restarts
            # the watcher instead of ending config reloads for good
            self._watch_thread = default_supervisor().spawn(
                "config-watcher", self._watch_config, beat_period_s=5.0)

    def close(self) -> None:
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.stop()
            self._watch_thread.join(timeout=2)
        with self._lock:
            self._close_components()

    def _close_components(self) -> None:
        if self.trident_grpc is not None:
            self.trident_grpc[0].stop(grace=1).wait()
            self.trident_grpc = None
        if self.querier is not None:
            self.querier.close()
        if self.anomaly_tables is not None:
            self.anomaly_tables.unregister_datasource()
            self.anomaly_tables.cache.close()
            self.ingester.stats.deregister("serving_anomaly")
            self.anomaly_tables = None
        if self.sketch_tables is not None:
            self.sketch_tables.unregister_datasource()
            self.sketch_tables.cache.close()
            self.ingester.stats.deregister("serving")
            self.sketch_tables = None
        if self.stats_shipper is not None:
            self.ingester.stats.stop()
            self.stats_shipper.close()
        self.ingester.close()
        if self.controller is not None:
            self.controller.close()
        if self.election is not None:
            self.election.close()

    # -- config watcher ------------------------------------------------------
    def _watch_config(self) -> None:
        """Rebuild the components when the config file changes."""
        try:
            last = os.path.getmtime(self.config_path)
        except OSError:
            last = 0.0
        while not self._stop.wait(5.0):
            default_supervisor().beat()
            try:
                cur = os.path.getmtime(self.config_path)
            except OSError:
                continue
            if cur != last:
                last = cur
                self.reload()

    def reload(self) -> None:
        with self._lock:
            new_cfg = load_config(self.config_path)
            if new_cfg == self.cfg:
                return
            self._close_components()
            self.cfg = new_cfg
            self._build()
            # restart everything but the watcher (already running). A
            # start failure (a port the new config picked is taken) must
            # not kill the watcher with the components half stopped:
            # record it and keep watching, so the next edit can recover
            try:
                self._start_components()
                self.reload_error = None
            except Exception as e:
                self.reload_error = repr(e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepflow-tpu-torch-server")
    ap.add_argument("-f", "--config", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the card the ingester and querier run on "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    server = Server(args.config, device=args.device)
    server.start()
    print(f"deepflow-tpu-torch server up: ingester :{server.ingester.port}"
          + (f", controller :{server.controller.port}"
             if server.controller else "")
          + (f", querier :{server.querier.port}" if server.querier else ""),
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
