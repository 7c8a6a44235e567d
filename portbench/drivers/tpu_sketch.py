"""Driver for the l4 sketch exporter (`TpuSketchExporter`).

Builds the exporter as the ingester builds it from `IngesterConfig`,
with the configuration file's settings: a `Store` and a checkpoint
directory under the run's work directory, and a `window_seconds` past
the run's end so that only the harness's clock closes windows. It
subscribes to the exporter's snapshot bus to keep the state published
for each window, keeps each window's output, and after the run hands
both to the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

STREAM = "l4_flow_log"
REFERENCE = "l4_sketch"

# the snapshot leaves in the order the bus publishes them
_LEAVES = ("cms", "cms_seeds", "ring_keys", "ring_counts", "hll", "ent",
           "ent_seeds", "rows_seen", "batches_seen")


class Driver:
    def __init__(self, config: dict, device: str, workdir: str,
                 window_seconds: float) -> None:
        from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
        from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
        from deepflow_tpu_torch.store.db import Store

        ex = config["exporter"]
        root = os.path.join(workdir, "store")
        self.store = Store(root) if ex["store"] else None
        ckpt = os.path.join(root, "sketch_ckpt") \
            if ex["checkpoint"] else None
        self.exporter = TpuSketchExporter(
            cfg=FlowSuiteConfig(**config["flow_suite"]),
            batch_rows=int(ex["batch_rows"]),
            window_seconds=window_seconds,
            checkpoint_dir=ckpt,
            checkpoint_every=int(ex["checkpoint_every"]),
            wire=ex["wire"],
            prefetch_depth=int(ex["prefetch_depth"]),
            coalesce_batches=int(ex["coalesce_batches"]),
            zero_copy=bool(ex["zero_copy"]),
            pack_workers=int(ex["pack_workers"]),
            audit_rate=float(ex["audit_rate"]),
            anomaly=bool(ex["anomaly"]),
            store=self.store, device=device)
        self._snaps: Dict[int, tuple] = {}
        self._outs: List[tuple] = []
        self.exporter.snapshot_bus.subscribe(self._on_snapshot)

    def _on_snapshot(self, snap) -> None:
        # the bus made the host copy; keep its leaves by window step
        self._snaps[int(snap.step)] = snap.leaves

    def flush(self) -> None:
        """One window close, as the exporter's window thread makes it."""
        out = self.exporter.flush_window()
        self._outs.append((self.exporter.windows, out))

    def streams(self) -> list:
        """The CUDA streams the exporter allocates on (its compute and
        copy streams)."""
        return [s for s in (self.exporter._stream, self.exporter._copy_stream)
                if s is not None]

    def counters(self) -> dict:
        return self.exporter.counters()

    def windows(self):
        """The reference's windows: consecutive ranges of the put order,
        each as long as its output's rows."""
        from reference.l4_sketch import Window
        out, lo = [], 0
        for step, o in self._outs:
            if o is None:
                continue
            host = {k: np.asarray(v.cpu().numpy())
                    for k, v in o._asdict().items()}
            host["topk_keys"] = host["topk_keys"].view(np.uint32)
            rows = int(host["rows"])
            leaves = self._snaps.get(step)
            state = None
            if leaves is not None and rows > 0:
                named = dict(zip(_LEAVES, leaves))
                state = {"cms": named["cms"], "hll": named["hll"],
                         "ent": named["ent"],
                         "ring_keys": named["ring_keys"],
                         "ring_counts": named["ring_counts"],
                         "rows_seen": named["rows_seen"]}
            out.append(Window(lo, lo + rows, host, state))
            lo += rows
        return out

    def store_columns(self) -> Dict[str, dict]:
        """What the exporter wrote, read back after it closed."""
        if self.store is None:
            return {}
        from deepflow_tpu_torch.runtime.tpu_sketch import SKETCH_DB
        got = {}
        for name in ("window_signals", "topk_flows"):
            if self.store.has_table(SKETCH_DB, name):
                got[name] = self.store.table(SKETCH_DB, name).scan()
        return got
