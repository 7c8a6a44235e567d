"""The server process: the ingester and querier roles in one process.

A copy of the JAX package's `server.py` (reference:
server/cmd/server/main.go, one binary behind one config file, with a
config watcher that rebuilds on change, ingester/config/watcher.go) for
the ingester and querier roles:
`Server(config_path, device="cuda").start()`, or

    python -m deepflow_tpu_torch.server -f server.json [--device cuda]

The controller role (`controller/`, the trident gRPC bridge, the
platform pusher) is control plane and is not ported: a config that
enables it raises NotImplementedError naming `controller.enabled`. The
JAX package's server enables it by default, so a config for this one
says `controller: {enabled: false}`.

Config (YAML where PyYAML is installed, else JSON; JSON is a subset of
YAML, so a JSON file reads the same either way):

    {"controller": {"enabled": false},
     "ingester": {"port": 30033, "store_path": "/var/lib/deepflow-tpu",
                  "debug_port": 30035, "throttle_per_s": 50000,
                  "tpu_sketch_window_s": 1.0, "app_red_window_s": 1.0,
                  "app_red_prom_buckets": 8},
     "querier": {"enabled": true, "port": 20416},
     "self_telemetry": true}

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
        from deepflow_tpu_torch.pipelines import Ingester
        from deepflow_tpu_torch.querier.server import QuerierServer
        from deepflow_tpu_torch.runtime.stats import StatsShipper

        c = self.cfg
        if c.get("controller", {}).get("enabled", True):
            raise NotImplementedError(
                "controller.enabled: the controller role (controller/, "
                "the trident gRPC bridge, the platform pusher) is not "
                "ported to deepflow_tpu_torch; set controller: "
                "{enabled: false}")
        ing_cfg = c.get("ingester", {})
        self.controller = None
        self.ingester = Ingester(ingester_config(ing_cfg),
                                 device=self.device)

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
                tagrecorder=None,
                external_apm=q_cfg.get("external_apm", []),
                sketch=self.sketch_tables,
                anomaly=self.anomaly_tables,
                device=self.device)

        self.stats_shipper = None
        if c.get("self_telemetry", True):
            # the server monitors itself through its own firehose
            addr = f"127.0.0.1:{ing_cfg.get('port', 30033)}"
            self.stats_shipper = StatsShipper(self.ingester.stats, addr)

    # -- lifecycle -----------------------------------------------------------
    def _start_components(self) -> None:
        """The one start sequence of start() and reload()."""
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
