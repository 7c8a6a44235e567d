"""Driver for the RED exporter (`AppRedExporter`).

Builds the exporter as the ingester builds it, with the configuration
file's settings, a `Store` under the run's work directory and a
`window_seconds` past the run's end so that only the harness's clock
closes windows; keeps each window's output and after the run hands them
to the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

STREAM = "l7_flow_log"
REFERENCE = "app_red"


class Driver:
    def __init__(self, config: dict, device: str, workdir: str,
                 window_seconds: float) -> None:
        from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
        from deepflow_tpu_torch.runtime.app_red import AppRedExporter
        from deepflow_tpu_torch.store.db import Store

        ex = config["exporter"]
        suite = dict(config["app_suite"])
        suite["quantiles"] = tuple(suite["quantiles"])
        self.store = Store(os.path.join(workdir, "store")) \
            if ex["store"] else None
        if int(ex["prom_bucket_stride"]):
            raise ValueError("the le buckets need tag dictionaries, which "
                             "this driver does not build")
        self.exporter = AppRedExporter(
            store=self.store, cfg=AppSuiteConfig(**suite),
            batch_rows=int(ex["batch_rows"]),
            window_seconds=window_seconds, device=device)
        self._outs: List = []

    def flush(self) -> None:
        self._outs.append(self.exporter.flush_window())

    def streams(self) -> list:
        """The CUDA streams the exporter allocates on."""
        return [s for s in (self.exporter._stream,) if s is not None]

    def counters(self) -> dict:
        return self.exporter.counters()

    def windows(self):
        from reference.app_red import Window
        out, lo = [], 0
        for o in self._outs:
            host = {k: np.asarray(v.cpu().numpy())
                    for k, v in o._asdict().items()}
            rows = int(host["requests"].astype(np.int64).sum())
            out.append(Window(lo, lo + rows, host))
            lo += rows
        return out

    def store_columns(self) -> Dict[str, dict]:
        if self.store is None:
            return {}
        from deepflow_tpu_torch.runtime.app_red import APP_RED_DB
        if not self.store.has_table(APP_RED_DB, "app_red"):
            return {}
        return {"app_red": self.store.table(APP_RED_DB, "app_red").scan()}
