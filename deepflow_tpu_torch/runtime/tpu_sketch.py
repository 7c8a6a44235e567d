"""A lean single-device sketch exporter over the port's flow suite.

`TpuSketchExporter.process(cols)` takes decoded l4 column dicts, batches
them at `batch_rows` and applies each batch on the device:

- wire="dict" (default): the valid rows are packed by `FlowDictPacker`
  (news + hits planes, hits flushed every batch), staged into one flat
  buffer (`stage_wire`), copied to the device in one transfer and applied
  by the `make_wire_update` program of that buffer's signature;
- wire="lanes": each batch is packed into a slot of a coalesced buffer
  (`pack_lanes_into`); every `coalesce_batches` slots cross in one
  transfer and `make_coalesced_update` applies them in order.

`flush_window()` ships what is still buffered, closes the window with
`flow_suite.flush` and returns its `FlowWindowOutput`. The JAX package's
exporter adds threads, a device feed, the snapshot bus, checkpoints,
degraded mode, the anomaly plane and audit around the same step; those
are not part of this exporter.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deepflow_tpu_torch.batch.batcher import (SKETCH_L4_SCHEMA, Batcher,
                                              TensorBatch)
from deepflow_tpu_torch.models import flow_dict, flow_suite


class TpuSketchExporter:
    """Decoded l4 columns -> device sketch state -> window outputs."""

    def __init__(self, cfg: Optional[flow_suite.FlowSuiteConfig] = None,
                 batch_rows: int = 1 << 15, wire: str = "dict",
                 coalesce_batches: int = 1, device="cuda") -> None:
        if wire not in ("dict", "lanes"):
            raise ValueError(f"wire must be 'dict' or 'lanes', got {wire!r}")
        self.device = flow_suite.check_device(device)
        self.cfg = cfg or flow_suite.FlowSuiteConfig()
        self.wire = wire
        self.batch_rows = int(batch_rows)
        self.state = flow_suite.init(self.cfg, self.device)
        self.batcher = Batcher(SKETCH_L4_SCHEMA, self.batch_rows)
        self._programs: Dict = {}
        self.coalesce_batches = max(1, int(coalesce_batches))
        self._dict_packer = None
        self._dict_state = None
        if wire == "dict":
            # pairs-packed hits planes hold two records per slot, so the
            # hits batch is even
            self._dict_packer = flow_dict.FlowDictPacker(
                capacity=max(2 * self.batch_rows, 1 << 17),
                hits_batch=max(2, self.batch_rows & ~1))
            self._dict_state = flow_dict.init_dict(
                self._dict_packer.capacity, self.device)
        else:
            self._flat = np.zeros(flow_suite.coalesced_lanes_words(
                self.coalesce_batches, self.batch_rows), np.uint32)
            self._slots = 0
        self.rows_in = 0
        self.windows = 0

    # -- ingest ----------------------------------------------------------

    def process(self, cols: Dict[str, np.ndarray]) -> None:
        """One decoded chunk (column name -> numpy array)."""
        schema_cols = SKETCH_L4_SCHEMA.coerce(cols)
        for tb in self.batcher.put(schema_cols):
            self._run_batch(tb)
        self.rows_in += len(next(iter(schema_cols.values())))

    def _to_device(self, flat: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(flat.view(np.int32)).to(self.device)

    def _program(self, key, build):
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = build()
        return prog

    def _run_batch(self, tb: TensorBatch) -> None:
        if self._dict_packer is not None:
            mask = tb.mask()
            cols = {k: v[mask] for k, v in tb.columns.items()}
            wire = self._dict_packer.pack(cols) + self._dict_packer.flush()
            self.batcher.recycle(tb)
            if not wire:
                return
            sig = flow_dict.wire_signature(wire)
            flat = np.empty(flow_dict.wire_words(sig), np.uint32)
            flow_dict.stage_wire(wire, flat)
            prog = self._program(
                ("dict", sig), lambda: flow_dict.make_wire_update(self.cfg, sig))
            self.state, self._dict_state, _ = prog(
                self.state, self._dict_state, self._to_device(flat))
            return
        C = self.batch_rows
        k = self._slots
        flow_suite.pack_lanes_into(tb.columns,
                                   flow_suite.slot_plane(self._flat, k, C))
        self._flat[k * flow_suite.slot_words(C)] = tb.valid
        self.batcher.recycle(tb)
        self._slots += 1
        if self._slots == self.coalesce_batches:
            self._ship_lanes()

    def _ship_lanes(self) -> None:
        """Apply the filled prefix of the coalesced lane buffer."""
        k = self._slots
        if k == 0:
            return
        C = self.batch_rows
        prog = self._program(
            ("lanes", k), lambda: flow_suite.make_coalesced_update(
                self.cfg, k, C))
        flat = self._flat[:flow_suite.coalesced_lanes_words(k, C)]
        self.state, _ = prog(self.state, self._to_device(flat))
        self._slots = 0

    # -- windows ---------------------------------------------------------

    def drain(self) -> None:
        """Apply every buffered row to the device state (a padded last
        batch, unshipped lane slots) without closing the window."""
        for tb in self.batcher.flush():
            self._run_batch(tb)
        if self._dict_packer is None:
            self._ship_lanes()

    def flush_window(self) -> flow_suite.FlowWindowOutput:
        """Apply every buffered row, then close the window."""
        self.drain()
        self.windows += 1
        self.state, out = flow_suite.flush(self.state, self.cfg)
        return out
