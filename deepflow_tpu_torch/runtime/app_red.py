"""AppRedExporter: per-service RED windows from the l7 stream.

The l7_flow_log stream drives `models/app_suite` on the device (request
and error histograms and a DDSketch per hashed service), and each window
writes one row per active service group into `tpu_sketch.app_red`
(requests, errors, one rrt quantile column per configured quantile),
which the querier reads like any other table. The exporter is a
`QueueWorkerExporter`: `put()` queues decoded chunks, its worker thread
cuts them into static batches, and the window thread (`start()`) closes
a window every `window_seconds`.

Device contract. Both threads enter the exporter's own compute stream.
A batch crosses to the card in one copy: its five u32 columns as int32
bits in one page-locked [5, batch_rows] buffer, copied asynchronously
(the caching host allocator keeps the buffer until the copy is done).
A batch is three launches of the hist kernel (requests, errors, the
DDSketch) and no host read. A window with a store reads its requests,
errors and quantiles back in one packed copy; without a store nothing
is read back.

A kernel that cannot be built or launched raises `KernelError`; it is
kept, and every later `process` and `flush_window` raises it.

With `stats=` the exporter's counters register with a `StatsRegistry`
as `exporter.app_red`.

Not ported here (ROADMAP): the Prometheus `le`-bucket surface
(`prom_bucket_stride > 0`), which needs the store's tag dictionaries
and the ext_metrics sample table.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from deepflow_tpu_torch.batch.batcher import Batcher, Schema, TensorBatch
from deepflow_tpu_torch.models import app_suite
from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.runtime.exporters import QueueWorkerExporter
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema
from deepflow_tpu_torch.store.writer import StoreWriter

APP_RED_DB = "tpu_sketch"


def quantile_column(q: float) -> str:
    """0.95 -> rrt_p95_us, 0.995 -> rrt_p99_5_us, 0.999 -> rrt_p99_9_us:
    exact, so no two distinct quantiles share a column name."""
    return "rrt_p" + f"{q * 100:g}".replace(".", "_") + "_us"


def app_red_table(quantiles=(0.5, 0.95, 0.99)) -> TableSchema:
    """The app_red schema, one column per configured quantile."""
    names = [quantile_column(q) for q in quantiles]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate quantile columns: {names}")
    qcols = tuple(ColumnSpec(nm, np.dtype(np.float32), AggKind.MAX)
                  for nm in names)
    return TableSchema(
        name="app_red",
        columns=(
            ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
            ColumnSpec("service_group", np.dtype(np.uint32), AggKind.KEY),
            # counts, not ratios: ratios do not add across windows
            ColumnSpec("requests", np.dtype(np.uint32), AggKind.SUM),
            ColumnSpec("errors", np.dtype(np.uint32), AggKind.SUM),
        ) + qcols,
    )


APP_RED_TABLE = app_red_table()

# the l7 columns the suite reads, batched to static shapes
_RED_SCHEMA = Schema(name="l7_red", columns=(
    ("ip_dst", np.dtype(np.uint32)),
    ("port_dst", np.dtype(np.uint32)),
    ("protocol", np.dtype(np.uint32)),
    ("status", np.dtype(np.uint32)),
    ("rrt_us", np.dtype(np.uint32)),
))


class AppRedExporter(QueueWorkerExporter):
    """l7_flow_log -> AppSuite windows -> app_red rows."""

    def __init__(self, store: Optional[Store] = None,
                 cfg: Optional[app_suite.AppSuiteConfig] = None,
                 batch_rows: int = 1 << 14,
                 window_seconds: float = 1.0,
                 prom_bucket_stride: int = 0,
                 stats: Optional[StatsRegistry] = None,
                 device="cuda") -> None:
        if prom_bucket_stride > 0:
            raise NotImplementedError(
                "prom_bucket_stride > 0 (the Prometheus le-bucket surface) "
                "is not ported: it needs a port of store/dict_store.py "
                "(TagDicts) and of the ext_metrics sample table")
        super().__init__("app_red", ["l7_flow_log"], n_workers=1, batch=64,
                         stats=stats)
        self.device = check_device(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.cfg = cfg or app_suite.AppSuiteConfig()
        self.window_seconds = window_seconds
        self.batcher = Batcher(_RED_SCHEMA, capacity=batch_rows)
        with self._on_stream():
            self.state = app_suite.init(self.cfg, self.device)
            self._lanes = torch.arange(batch_rows, device=self.device)
        self.rows_in = 0
        self.windows = 0
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.last_output: Optional[app_suite.AppWindowOutput] = None
        self.writer = None
        if store is not None:
            self.writer = StoreWriter(
                store.create_table(APP_RED_DB,
                                   app_red_table(self.cfg.quantiles)),
                batch_rows=4096, flush_interval=5.0)
        self._state_lock = threading.Lock()
        self._window_stop = threading.Event()
        self._window_thread = None     # supervisor ThreadHandle
        self._kernel_error: Optional[KernelError] = None

    def _on_stream(self):
        """Enter the exporter's compute stream on the calling thread (a
        no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.writer is not None:
            self.writer.start()
        super().start()
        # deadman off: the loop blocks a whole window between beats
        self._window_thread = default_supervisor().spawn(
            "app-red-window", self._window_loop, deadman_s=None)

    def close(self) -> None:
        self._window_stop.set()
        if self._window_thread is not None:
            self._window_thread.stop()
            self._window_thread.join(timeout=5)
        super().close()
        try:
            self.flush_window()
        finally:
            if self.writer is not None:
                self.writer.close()

    def _window_loop(self) -> None:
        while not self._window_stop.wait(self.window_seconds):
            self.flush_window()

    # -- data path -----------------------------------------------------------
    def process(self, chunks: List[Any]) -> None:
        """Queue worker: decoded (stream, idx, cols, batch_id) chunks ->
        static batches -> device, under the lock the window flush takes."""
        for _stream, _idx, cols, *_rest in chunks:
            schema_cols = self.coerce_to_schema(cols, _RED_SCHEMA)
            n = len(next(iter(schema_cols.values())))
            with self._state_lock:
                self._raise_kernel_error()
                for tb in self.batcher.put(schema_cols):
                    self._run_batch_locked(tb)
                self.rows_in += n

    def _raise_kernel_error(self) -> None:
        if self._kernel_error is not None:
            raise self._kernel_error

    def _run_batch_locked(self, tb: TensorBatch) -> None:
        """One batch: pack its columns, one copy, one update."""
        cuda = self._stream is not None
        host = torch.empty((len(_RED_SCHEMA.columns), tb.capacity),
                           dtype=torch.int32, pin_memory=cuda)
        words = host.numpy()
        for i, name in enumerate(_RED_SCHEMA.names):
            words[i] = tb.columns[name].view(np.int32)
        valid = tb.valid
        self.batcher.recycle(tb)
        with self._on_stream():
            dev = host.to(self.device, non_blocking=True) if cuda else host
            self.h2d_transfers += 1
            cols = dict(zip(_RED_SCHEMA.names, dev))
            try:
                self.state = app_suite.update(self.state, cols,
                                              self._lanes < valid, self.cfg)
            except KernelError as e:
                self._kernel_error = e
                raise

    # -- windows -------------------------------------------------------------
    def flush_window(self, now: Optional[float] = None
                     ) -> app_suite.AppWindowOutput:
        """Ship the buffered rows, read the window out and start a fresh
        state; with a store, write the window's rows."""
        now = time.time() if now is None else now
        with self._state_lock:
            self._raise_kernel_error()
            for tb in self.batcher.flush():
                self._run_batch_locked(tb)
            self.windows += 1
            with self._on_stream():
                self.state, out = app_suite.flush(self.state, self.cfg)
                host = None if self.writer is None else self._readout(out)
        if self._stream is not None:
            # hand the readout to the caller's stream: its work on the
            # outputs waits for the flush, and the allocator keeps their
            # memory until that work is done
            caller = torch.cuda.current_stream(self.device)
            caller.wait_stream(self._stream)
            for t in out:
                t.record_stream(caller)
        self.last_output = out
        if host is not None:
            self._write_output(*host, int(now))
        return out

    def _readout(self, out: app_suite.AppWindowOutput):
        """(requests, errors, quantiles) as numpy, from one packed copy."""
        g = self.cfg.groups
        words = torch.cat([out.requests, out.errors,
                           out.rrt_quantiles.reshape(-1)]).cpu().numpy()
        self.d2h_transfers += 1
        return words[:g], words[g:2 * g], words[2 * g:].reshape(-1, g)

    def _write_output(self, reqs: np.ndarray, errors: np.ndarray,
                      qs: np.ndarray, second: int) -> None:
        active = np.nonzero(reqs > 0)[0]
        if len(active) == 0:
            return
        row = {
            "timestamp": np.full(len(active), second, np.uint32),
            "service_group": active.astype(np.uint32),
            "requests": reqs[active].astype(np.uint32),
            "errors": errors[active].astype(np.uint32),
        }
        for i, q in enumerate(self.cfg.quantiles):
            row[quantile_column(q)] = qs[i, active].astype(np.float32)
        self.writer.put(row)

    def flush(self) -> None:
        """Drain pending RED rows to disk (the ingester's flush hook)."""
        if self.writer is not None:
            self.writer.flush()

    def counters(self) -> dict:
        c = super().counters()   # the queue's observable-loss stats
        c.update({"rows_in": self.rows_in, "windows": self.windows,
                  "batches": self.batcher.emitted_batches,
                  "h2d_transfers": self.h2d_transfers,
                  "d2h_transfers": self.d2h_transfers})
        return c
