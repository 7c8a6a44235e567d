"""The tpu_sketch exporter: decoded l4 chunks -> device sketch state ->
window outputs, as the ingester runs it.

`TpuSketchExporter` is a `QueueWorkerExporter`: `put()` queues decoded
chunks, its worker thread calls `process(chunks)`, and the window thread
(`start()`) closes a window every `window_seconds`. Data paths:

- inline (`prefetch_depth=0`): chunks are cut into TensorBatches and
  applied on the calling thread, one staged buffer per dispatch (dict
  wire: packer output through `flow_dict.make_wire_update`; lanes wire:
  `coalesce_batches` slots through `flow_suite.make_coalesced_update`).
  It is the bit-identity reference of the other paths.
- feed (`prefetch_depth>0`, `zero_copy=True`): the producer stages
  decoded chunks straight into pinned buffers (`LaneStager`,
  `DictWireStager`), and a supervised feed thread (`DeviceFeed`) copies
  and dispatches each group while the producer stages the next, with up
  to `prefetch_depth` groups in flight behind fences.
- TensorBatch feed (`prefetch_depth>0`, `zero_copy=False`): the producer
  cuts chunks into TensorBatches as the inline path does and hands them
  to the feed, which takes up to `coalesce_batches` of them a group and
  packs the group on the feed thread into one flat staging buffer
  (pinned on a card, recycled after the group's fence): the lanes wire
  as K slots of one coalesced update, the dict wire as the packer's
  wire for each batch in turn (pack + flush per batch, the inline
  emission order) under one signature-keyed program. Its state equals
  the inline path's leaf for leaf, whatever the feed's grouping.

Device contract (CUDA). All device work of the exporter runs on its own
compute stream, entered by every thread that dispatches (the kernels
launch on the calling thread's current stream). Host-to-device copies
of pinned staging buffers run on a copy stream; the compute stream
waits on an event recorded after each copy, and the copied tensor is
`record_stream`-ed onto the compute stream so the allocator cannot hand
its memory out early. A group's fence is a `torch.cuda.Event` recorded
on the compute stream after its program; a staging buffer is recycled
only after its fence retired. Between fences the feed path makes no
device-to-host copy and no synchronization: the programs read each
plane's valid count from the staged buffer on the device. On a CPU
device everything runs synchronously and fences are None.

Window flush (after a drain barrier): the pre-flush state is published
to the `SnapshotBus` -- to disk every `checkpoint_every`-th dirty window
when there is a `checkpoint_dir`, to subscribers on every dirty window
-- and then `flow_suite.flush` reads the window out and starts a fresh
state.

Device errors (a `RuntimeError` from a dispatch or a fence: a CUDA
error surfacing there, an injected `tpu.device_error`): the state is
updated IN PLACE, so a failed program may leave it half-written. The
ladder therefore never keeps it: it rolls back into fresh tensors built
from the newest compatible snapshot (or a fresh init), and after
`degrade_after` consecutive errors degrades the lane until a per-window
probe finds the device healthy. Degraded on a CPU device, a host-numpy
sketch absorbs the rows at reduced rate, as the reference's host
fallback does; degraded on a CUDA device, the rows are shed and counted
lost: work meant for the card never moves to the CPU. Every loss is
counted (`lost_rows`, `lost_windows`, `shed_rows`). A sticky CUDA error
(an illegal address) leaves the process's CUDA context unusable; no
in-process restore mends that.

A kernel that cannot be built, loaded or launched raises `KernelError`,
which is no device error: it is never rolled back or degraded around.
The inline path raises it at once; on the feed thread it is kept, the
groups still queued are shed, and the producer's next `process`,
`flush_window` or `checkpoint_now` raises it.

Detection and accuracy lanes. With `anomaly` (an `AnomalyConfig`, or
True for its defaults) an `AnomalyPlane` runs beside the sketch lane:
every applied group also offers its flow keys to the plane's active-flow
table (on the compute stream, before the group's fence), and every
window close runs one window step, whose alerts are published on the
plane's `anomaly` snapshot bus after the state lock is released. With
`audit_rate` > 0 a `ShadowAuditor` keeps an exact, key-sampled shadow of
the stream on the host and compares it with each window's output. Both
read one host copy of the window output, made once per flush. Neither
touches the sketch state, which is bit-identical with them on or off.
The dict wire's inline path applies a whole staged group and then feeds
it, as the feed path does, so hits gather their keys from the table
after the group (the reference's inline path feeds plane by plane).

Store writers. With a `store`, every window output (the degraded host
window's too) is written as rows of `tpu_sketch.topk_flows` (one per
live top-K entry, its 5-tuple resolved through a sampled host-side
reverse map of flow keys, 0 where the key was never sampled) and one row
of `tpu_sketch.window_signals`, through `StoreWriter`s that `flush()`
drains. The writers read the same host copy of the window output as the
detection lanes: one device-to-host copy per window when any of them is
on, none otherwise.

`staged=True` is accepted for the reference's signature, with its
warnings: it forces the lanes wire and the inline path (no feed). The
reference's staged update exists only for its tunneled TPU runtime; in
eager torch it is `update`, so the inline lanes path computes it.

Pod lanes. `pod_shards >= 2` routes the lane through the epoch-merged
pod (`parallel/pod.py`): one fault domain per shard with its own worker,
stream and device-error ladder, shard i on the mesh's devices[i] (so the
shards may share one card). `pod_hosts >= 2` stacks the cross-host pod
on top (`parallel/multihost.py`): per-host pods, epoch markers over a
DCN transport (`dcn_transport`: "sim", "torch" or "auto"), host deadline
exclusion, kill and rejoin. Either forces the lanes wire and the inline
path (the pod's shard workers own the overlap), packs each TensorBatch
into a (4, batch_rows) lane plane for `put_lanes`, and makes each window
flush one merge-epoch close: the merged output is the window's, the
pod's merged bus is the exporter's `snapshot_bus`, the anomaly plane
scores the merged output with the epoch's participation tags, and the
auditor closes it with the epoch's `lossy`/`degraded` verdicts. There is
no single device state, so there is no exporter checkpoint or restore in
pod mode; the pod's counters join the exporter's.

Flight recorder (runtime/tracing.py, runtime/profiler.py; off unless
the process tracer is enabled or a reader of the busy gauge is attached,
`busy_reader`, which the autotuner sets). Every transfer and program call
adds to the true totals `h2d_bytes`, `h2d_transfers` and `dispatches`.
One group in `_attrib_every` (16) is attributed in detail: its copy
(`kernel.h2d`, the `tpu_h2d_mb_s` gauge), its program's host dispatch
(`kernel.dispatch`: the host's time in the call, which launches every
kernel of the program) and device time (`kernel.device`), each stream
named by its program (`dict:n8192+h16384`, `lanes_x4`); the first
traced call of each program is `kernel.compile` and the gauge
`tpu_compile_s_<program>` instead (the first launch loads the built
kernel library). On a card the card would run the program's kernels as
the host launches them, so events around the call would time the host.
The attributed call is therefore gated (`ops/cuda_gate.py`): a gate
kernel holds the compute stream, the start event is recorded behind it,
the host launches the program, records the end event and opens the
gate; the events then bracket the kernels running back to back, the
card's execution time. A gate the timeout released (the host blocked
while it held: a full launch queue, a sync) is discarded and counted
(`busy_samples_timed_out`), and a program whose gate timed out twice is
no longer gated. On the feed a program's first warm call is gated
whatever the cadence, and on a card the detection lanes' launches after
a program are timed as a program of their own (`anomaly:<program>`). Each gated sample feeds the exporter's
`BusyEstimator`, from which the feed sizes every group's `device` span
(runtime/feed.py).
The copy's events and the program's are read when the group's fence
retires (the feed) or by a synchronize of the sampled group's last event
(the inline path, as the reference's sampled drain): the feed path makes
no sync of its own for the recorder. On the CPU the program runs inside
the call, whose wall time is both its dispatch and its device time. A
window flush is a `window` span and a `window` profiler record; `stats=`
registers the exporter's counters (`exporter.tpu_sketch`), the
auditor's (`tpu_sketch_accuracy`) and the anomaly plane's (`anomaly`)
with a `StatsRegistry`.

Not ported here (ROADMAP): the autotuner.
"""

from __future__ import annotations

import contextlib
import heapq
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepflow_tpu_torch.anomaly import AnomalyConfig, AnomalyPlane
from deepflow_tpu_torch.batch.batcher import (SKETCH_L4_SCHEMA, Batcher,
                                              TensorBatch)
from deepflow_tpu_torch.batch.staging import (DictWireStager, LaneStager,
                                              PackPool, WordPool)
from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.parallel.multihost import (HostPodCoordinator,
                                                   select_transport)
from deepflow_tpu_torch.parallel.pod import PodFlowSuite
from deepflow_tpu_torch.runtime.audit import ShadowAuditor
from deepflow_tpu_torch.runtime.exporters import QueueWorkerExporter
from deepflow_tpu_torch.runtime.faults import (FAULT_DEVICE_ERROR,
                                               default_faults)
from deepflow_tpu_torch.runtime.feed import DeviceFeed, InFlight
from deepflow_tpu_torch.ops.cuda_gate import DeviceGate
from deepflow_tpu_torch.runtime.profiler import BusyEstimator, default_profiler
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.utils.u32 import fold_columns_np

_LOG = logging.getLogger(__name__)

SKETCH_DB = "tpu_sketch"

# how long a gate holds the compute stream at most (ops/cuda_gate.py): a
# program the host takes longer to launch is not timed
GATE_TIMEOUT_S = 0.5

TOPK_TABLE = TableSchema(
    name="topk_flows",
    columns=(
        ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("rank", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("flow_key", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("count", np.dtype(np.uint32), AggKind.MAX),
        # the 5-tuple behind the key, resolved on the host through the
        # sampled reverse map (0 where the key was never sampled)
        ColumnSpec("ip_src", np.dtype(np.uint32), AggKind.MAX),
        ColumnSpec("ip_dst", np.dtype(np.uint32), AggKind.MAX),
        ColumnSpec("port_src", np.dtype(np.uint32), AggKind.MAX),
        ColumnSpec("port_dst", np.dtype(np.uint32), AggKind.MAX),
        ColumnSpec("proto", np.dtype(np.uint32), AggKind.MAX),
    ),
)

WINDOW_TABLE = TableSchema(
    name="window_signals",
    columns=(
        ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("rows", np.dtype(np.uint32), AggKind.SUM),
        ColumnSpec("entropy_ip_src", np.dtype(np.float32), AggKind.MAX),
        ColumnSpec("entropy_ip_dst", np.dtype(np.float32), AggKind.MAX),
        ColumnSpec("entropy_port_src", np.dtype(np.float32), AggKind.MAX),
        ColumnSpec("entropy_port_dst", np.dtype(np.float32), AggKind.MAX),
        ColumnSpec("distinct_clients", np.dtype(np.uint32), AggKind.MAX),
    ),
)

_TUPLE_NAMES = ("ip_src", "ip_dst", "port_src", "port_dst", "proto")
# the epoch tags the anomaly plane reads as a window's participation
_PARTICIPATION = ("pod_shards_participated", "pod_shards", "pod_missing",
                  "pod_hosts_participated", "pod_hosts", "pod_hosts_missing")


class _HostSketch:
    """Host-numpy fallback sketch: the degraded lane of a CPU device.

    A reduced-rate approximation of the flow suite: rows are
    stride-subsampled (1/stride admitted, counts scaled back up), heavy
    hitters accumulate in a bounded exact dict, distinct clients in a
    capped exact set, entropies over modulo-bucketed histograms. flush()
    returns a FlowWindowOutput (CPU tensors) so readers see one shape."""

    DICT_CAP = 1 << 16
    CLIENTS_CAP = 1 << 16

    def __init__(self, cfg: flow_suite.FlowSuiteConfig,
                 stride: int = 4) -> None:
        self.cfg = cfg
        self.stride = max(1, stride)
        self.rows = 0
        self._counts: Dict[int, int] = {}
        self._clients: set = set()
        self._buckets = 1 << cfg.entropy_log2_buckets
        self._ent = np.zeros((len(flow_suite.ENTROPY_FEATURES),
                              self._buckets), np.int64)

    def update(self, cols: Dict[str, np.ndarray]) -> int:
        """Absorb one chunk at 1/stride rate; returns rows admitted."""
        n = len(next(iter(cols.values()))) if cols else 0
        if n == 0:
            return 0
        self.rows += n
        sl = slice(None, None, self.stride)
        sub = {k: np.asarray(v)[sl] for k, v in cols.items()}
        keys = fold_columns_np([sub["ip_src"], sub["ip_dst"],
                                sub["port_src"], sub["port_dst"],
                                sub["proto"]])
        uniq, cnt = np.unique(keys, return_counts=True)
        counts = self._counts
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            counts[k] = counts.get(k, 0) + c * self.stride
        if len(counts) > self.DICT_CAP:
            # keep the heavy half: the top-K readout only needs heads
            self._counts = dict(heapq.nlargest(
                self.DICT_CAP // 2, counts.items(), key=lambda kv: kv[1]))
        if len(self._clients) < self.CLIENTS_CAP:
            self._clients.update(sub["ip_src"].tolist())
        pkts = np.minimum(sub["packet_tx"].astype(np.int64)
                          + sub["packet_rx"].astype(np.int64), 0xFFFF)
        for i, f in enumerate(flow_suite.ENTROPY_FEATURES):
            # float64 weight sums are exact at these magnitudes (< 2^53)
            self._ent[i] += np.bincount(
                np.asarray(sub[f]).astype(np.uint32)
                % np.uint32(self._buckets),
                weights=pkts, minlength=self._buckets).astype(np.int64)
        return len(keys)

    def flush(self, cfg: flow_suite.FlowSuiteConfig
              ) -> flow_suite.FlowWindowOutput:
        """Window readout in FlowWindowOutput shape, then reset."""
        k = cfg.top_k
        top = heapq.nlargest(k, self._counts.items(), key=lambda kv: kv[1])
        keys = np.zeros(k, np.uint32)
        counts = np.zeros(k, np.int32)
        for i, (key, c) in enumerate(top):
            keys[i] = key & 0xFFFFFFFF
            counts[i] = min(c, np.iinfo(np.int32).max)
        h = self._ent.astype(np.float64)
        total = h.sum(axis=1, keepdims=True)
        p = h / np.maximum(total, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            xlogx = np.where(p > 0, p * np.log(p), 0.0)
        ent = np.where(total[:, 0] > 0,
                       -xlogx.sum(axis=1) / np.log(self._buckets), 0.0)
        out = flow_suite.FlowWindowOutput(
            topk_keys=torch.from_numpy(keys.view(np.int32)),
            topk_counts=torch.from_numpy(counts),
            service_cardinality=torch.tensor([float(len(self._clients))],
                                             dtype=torch.float32),
            entropies=torch.from_numpy(ent.astype(np.float32)),
            rows=torch.tensor(self.rows, dtype=torch.int32))
        self.rows = 0
        self._counts = {}
        self._clients = set()
        self._ent[:] = 0
        return out


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


def _host_output(out: flow_suite.FlowWindowOutput
                 ) -> flow_suite.FlowWindowOutput:
    """A host copy of a window output in ONE device-to-host copy: every
    leaf's 32-bit words packed into one int32 tensor, copied, and cut
    back into CPU tensors of the leaves' dtypes and shapes."""
    words = torch.cat([t.reshape(-1).view(torch.int32) for t in out]).cpu()
    leaves, off = [], 0
    for t in out:
        n = t.numel()
        leaves.append(words[off:off + n].view(t.dtype).reshape(t.shape))
        off += n
    return flow_suite.FlowWindowOutput(*leaves)


class TpuSketchExporter(QueueWorkerExporter):
    """Exporter contract (start/close/is_export_data/put) over the flow
    suite on one device."""

    _PROGRAM_CACHE_CAP = 128
    # distinct sampled flow keys the reverse map keeps: well above the
    # ring size, so standing heavy hitters stay resolvable across windows
    _KEY_TUPLES_CAP = 1 << 18

    def __init__(self, cfg: Optional[flow_suite.FlowSuiteConfig] = None,
                 batch_rows: int = 1 << 15,
                 window_seconds: float = 1.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 wire: str = "dict",
                 prefetch_depth: int = 0,
                 coalesce_batches: int = 1,
                 zero_copy: bool = True,
                 pack_workers: int = 0,
                 pod_shards: int = 0,
                 pod_merge_deadline_s: float = 5.0,
                 pod_hosts: int = 0,
                 dcn_marker_deadline_s: float = 5.0,
                 dcn_transport: str = "auto",
                 dcn_heal_after_s: float = 0.0,
                 audit_rate: float = 0.0,
                 anomaly=None,
                 anomaly_dir: Optional[str] = None,
                 store: Optional[Store] = None,
                 staged: bool = False,
                 stats: Optional[StatsRegistry] = None,
                 device="cuda") -> None:
        super().__init__("tpu_sketch", ["l4_flow_log"], n_workers=1,
                         batch=64, stats=stats)
        if wire not in ("dict", "lanes"):
            raise ValueError(f"wire must be 'dict' or 'lanes', got {wire!r}")
        pod_shards, pod_hosts = int(pod_shards), int(pod_hosts)
        pod = pod_shards >= 2 or pod_hosts >= 2
        if pod:
            if wire == "dict":
                _LOG.warning("pod mode runs the lanes wire; wire='dict' "
                             "ignored")
            if staged or prefetch_depth or pack_workers:
                _LOG.info("pod mode: staged/prefetch/zero_copy/pack_workers "
                          "forced off (the pod's shard workers own overlap)")
            wire, staged = "lanes", False
            prefetch_depth = pack_workers = 0
            zero_copy = False
        if staged:
            if wire == "dict":
                _LOG.warning("staged=True forces the packed lane; "
                             "wire='dict' ignored")
            wire = "lanes"
            if prefetch_depth:
                _LOG.warning("staged=True has no coalesced feed; prefetch "
                             "disabled")
                prefetch_depth = 0
        self.device = flow_suite.check_device(device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.cfg = cfg or flow_suite.FlowSuiteConfig()
        self.wire = wire
        self.batch_rows = int(batch_rows)
        self.window_seconds = window_seconds
        self._pod = None
        if pod_hosts >= 2:
            # no divisibility constraint: the coordinator re-packs each
            # host's slice to a width its own shard count divides
            self._pod = HostPodCoordinator(
                self.cfg, n_hosts=pod_hosts,
                shards_per_host=pod_shards or None,
                transport=select_transport(
                    dcn_transport, pod_hosts,
                    heal_after_s=float(dcn_heal_after_s) or None),
                dcn_marker_deadline_s=dcn_marker_deadline_s,
                merge_deadline_s=pod_merge_deadline_s,
                snapshot_dir=checkpoint_dir, device=self.device)
        elif pod:
            # fail before the pod spawns its workers, not at every batch
            if self.batch_rows % pod_shards:
                raise ValueError(
                    f"batch_rows={self.batch_rows} not divisible by the "
                    f"pod's {pod_shards} shard(s); every batch would be "
                    "rejected at put_lanes")
            self._pod = PodFlowSuite(
                self.cfg, n_shards=pod_shards, wire="lanes",
                merge_deadline_s=pod_merge_deadline_s,
                snapshot_dir=checkpoint_dir, device=self.device)
        self.state = None
        if self._pod is None:
            with self._on_stream():
                self.state = flow_suite.init(self.cfg, self.device)
        # the snapshot bus: disk-backed with a checkpoint_dir (restart
        # replay and the rollback read it back), in-process otherwise;
        # `checkpointer` is None when nothing is durable. In pod mode it
        # is the pod's merged bus, and the pod's per-shard snapshots are
        # its own rollback scratch (never restored across a restart)
        self._snapbus = self._pod.bus if self._pod is not None \
            else SnapshotBus(checkpoint_dir)
        self.checkpointer = self._snapbus \
            if checkpoint_dir is not None and self._pod is None else None
        self.checkpoint_every = max(1, checkpoint_every)
        self.windows = 0
        self._rows_at_flush = 0
        if self.checkpointer is not None:
            with self._on_stream():
                restored = self.checkpointer.restore(self.state)
            if restored is not None:
                self.state = restored
                # resume the step counter past the existing snapshots
                self.windows = self.checkpointer.latest_step() or 0
                # the restored accumulation is uncounted live data: dirty
                self._rows_at_flush = -1
        self.topk_writer = self.window_writer = None
        if store is not None:
            self.topk_writer = StoreWriter(
                store.create_table(SKETCH_DB, TOPK_TABLE),
                batch_rows=4096, flush_interval=5.0)
            self.window_writer = StoreWriter(
                store.create_table(SKETCH_DB, WINDOW_TABLE),
                batch_rows=1024, flush_interval=5.0)
        # flow key -> 5-tuple, sampled from the stream for the writers
        self._key_tuples: Dict[int, tuple] = {}
        # dict wire: a flow's 5-tuple crosses once (news), repeats cross
        # as hits against the device key table. The table is not
        # checkpointed: after a restore a fresh packer re-announces
        # flows as news. Pairs-packed hits planes need an even batch.
        self._dict_packer = None
        self._dict_state = None
        if wire == "dict":
            self._packer_capacity = max(2 * self.batch_rows, 1 << 17)
            self._packer_hits_batch = max(2, self.batch_rows & ~1)
            self._dict_packer = self._new_packer()
            with self._on_stream():
                self._dict_state = flow_dict.init_dict(
                    self._packer_capacity, self.device)
        self.rows_in = 0
        self.last_output: Optional[flow_suite.FlowWindowOutput] = None
        self._window_thread = None
        self._window_stop = threading.Event()
        self._state_lock = threading.Lock()
        self.h2d_bytes = 0
        self.h2d_transfers = 0
        self.dispatches = 0
        # -- flight recorder: sampled h2d / dispatch / device attribution,
        # the first traced call of each program split out as its compile
        self._tracer = default_tracer()
        self._prof = default_profiler()
        self._warm: set = set()
        self._attrib_every = 16
        self._batches_traced = 0
        self._detailed = False
        self._h2d_mark = None      # the detailed group's copy, until used
        self._attr_pending: list = []   # records awaiting their fence
        # device time of the programs, from gated samples (a card only);
        # the autotuner sets busy_reader, which gates without the tracer
        self.busy_reader = False
        self._busy = BusyEstimator() if cuda else None
        self._gate = DeviceGate(self.device, timeout_s=GATE_TIMEOUT_S) \
            if cuda else None
        self._gate_timeouts: Dict[str, int] = {}
        self._group_programs: list = []  # program keys of this group
        # -- degraded mode (fault domain: the device) ------------------
        self._faults = default_faults()
        self.degraded = False
        self.device_errors = 0     # device-classified raises
        self.recoveries = 0        # degraded -> device restorations
        self.lost_windows = 0      # window accumulations rolled back
        self.lost_rows = 0         # rows in groups that died on device
        self.host_rows = 0         # rows absorbed by the host fallback
        self.shed_rows = 0         # rows refused (and counted lost)
        self._consecutive_errors = 0
        self.degrade_after = 2
        # the host fallback runs for a CPU device only: degraded on the
        # card, rows are shed rather than computed on the CPU
        self._host_fallback = not cuda
        self.host_stride = 4       # host fallback subsample
        self._host: Optional[_HostSketch] = None
        self._window_lost_counted = False
        self._kernel_error: Optional[KernelError] = None
        # -- overlapped device feed ------------------------------------
        # Between feed.drain() barriers the feed thread is the only
        # writer of state/_dict_state/_host; _state_lock serializes
        # producers against the window flush (feed.py).
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.coalesce_batches = max(1, int(coalesce_batches))
        self._feed: Optional[DeviceFeed] = None
        self._programs: Dict[Any, Any] = {}
        self.zero_copy = (bool(zero_copy) and wire in ("lanes", "dict")
                          and not staged and self.prefetch_depth > 0)
        self._stager = None
        self._pack_pool = None
        self.batcher = None
        # the TensorBatch feed's flat staging buffers, by size, recycled
        # once their group's fence retired (feed thread only)
        self._staging_pool = WordPool(self.prefetch_depth + 2, cuda)
        if self.zero_copy:
            if pack_workers > 0:
                self._pack_pool = PackPool(pack_workers)
            cap = self.prefetch_depth + 2      # free buffers per size
            if wire == "dict":
                # the stager owns the packer (it packs at its own batch
                # cuts to keep the inline partition)
                self._stager = DictWireStager(
                    self.batch_rows, packer_factory=self._new_packer,
                    group_batches=self.coalesce_batches,
                    pool=self._pack_pool, pool_cap=cap, pinned=cuda)
                self._dict_packer = None
            else:
                self._stager = LaneStager(
                    self.batch_rows, group_batches=self.coalesce_batches,
                    pool=self._pack_pool, pool_cap=cap, pinned=cuda)
            self._feed = DeviceFeed(
                "tpu-sketch-feed",
                self._feed_process_dict_staged if wire == "dict"
                else self._feed_process_staged,
                # groups are coalesced at the stager
                depth=self.prefetch_depth, coalesce=1,
                on_fence_error=self._feed_fence_error,
                on_restart=self._feed_crash_restart,
                estimator=self._busy)
        else:
            self.batcher = Batcher(SKETCH_L4_SCHEMA, self.batch_rows)
            if self.prefetch_depth > 0:
                # the feed groups K TensorBatches (the stager does not)
                self._feed = DeviceFeed(
                    "tpu-sketch-feed", self._feed_process_group,
                    depth=self.prefetch_depth,
                    coalesce=self.coalesce_batches,
                    on_fence_error=self._feed_fence_error,
                    on_restart=self._feed_crash_restart,
                    estimator=self._busy)
            elif wire == "lanes" and self._pod is None:
                # inline lanes: one pageable buffer of coalesce slots
                self._flat = np.zeros(flow_suite.coalesced_lanes_words(
                    self.coalesce_batches, self.batch_rows), np.uint32)
                self._slots = 0
        # -- accuracy observatory: host-only exact shadow, 0 disables ----
        self.audit_rate = max(0.0, float(audit_rate))
        self._audit = ShadowAuditor(self.cfg, rate=self.audit_rate) \
            if self.audit_rate > 0 else None
        if self._audit is not None and stats is not None:
            stats.register("tpu_sketch_accuracy", self._audit.counters)
        # -- anomaly plane: its own device state beside the sketch state -
        self._anomaly = None
        if anomaly:
            acfg = anomaly if isinstance(anomaly, AnomalyConfig) \
                else AnomalyConfig()
            with self._on_stream():
                self._anomaly = AnomalyPlane(acfg, directory=anomaly_dir,
                                             stats=stats, device=self.device)

    def _new_packer(self) -> flow_dict.FlowDictPacker:
        return flow_dict.FlowDictPacker(capacity=self._packer_capacity,
                                        hits_batch=self._packer_hits_batch)

    def _on_stream(self):
        """Enter the exporter's compute stream on the calling thread
        (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- exporter lifecycle --------------------------------------------------
    def _writers(self) -> List[StoreWriter]:
        return [w for w in (self.topk_writer, self.window_writer)
                if w is not None]

    def start(self) -> None:
        for w in self._writers():
            w.start()
        super().start()
        # deadman off: the loop blocks a whole window between beats
        self._window_thread = default_supervisor().spawn(
            "tpu-sketch-window", self._window_loop, deadman_s=None)

    def close(self) -> None:
        self._window_stop.set()
        if self._window_thread is not None:
            self._window_thread.stop()
            self._window_thread.join(timeout=5)
        super().close()
        try:
            self.flush_window()  # the final window (drains the feed first)
            if self._pod is not None:
                # one more (normally empty) epoch so late stragglers
                # deliver before the workers stop
                self._pod.close(final_epoch=True)
        finally:
            if self._pod is not None:
                # stops the pod's workers when a final epoch raised
                self._pod.close(final_epoch=False)
            if self._feed is not None:
                self._feed.close()
            if self._pack_pool is not None:
                # after the feed: in-flight groups may wait on pool packs
                self._pack_pool.close()
            for w in self._writers():
                w.close()

    # -- data path -----------------------------------------------------------
    def process(self, chunks: List[Any]) -> None:
        """Queue worker: decoded (stream, idx, cols, batch_id) chunks ->
        static batches -> device. Holds _state_lock across the batcher
        or stager and the state: the window flush takes the same lock."""
        for _stream, _idx, cols, *_rest in chunks:
            schema_cols = self.coerce_to_schema(cols, SKETCH_L4_SCHEMA)
            if self._stager is not None or self._pod is not None:
                # the staged words and the pod's lane planes carry no tuple
                # columns: the reverse map samples the decoded chunk,
                # outside the lock
                self._record_key_tuples(schema_cols)
            with self._state_lock:
                self._raise_kernel_error()
                if self._pod is not None:
                    # put_lanes never blocks (a slow or LOST shard drops
                    # counted on its own queue)
                    for tb in self.batcher.put(schema_cols):
                        self._pod_submit_locked(tb)
                elif self._stager is not None:
                    # the stager is private state guarded by this lock;
                    # a full feed queue is back-pressure, not deadlock
                    for sg in self._stager.put(schema_cols):
                        self._feed.put(sg, self._tracer.current_batch()
                                       if self._tracer.enabled else -1)
                else:
                    for tb in self.batcher.put(schema_cols):
                        self._submit_batch_locked(tb)
                # counted once handed to the device path: a processed
                # watermark (every flush drains the feed first)
                rows = len(next(iter(schema_cols.values())))
                self.rows_in += rows
                # the lanes' mirrors move at the same boundary, so
                # anomaly.rows_seen == rows_in and the audit window is
                # the sketch window
                if self._anomaly is not None:
                    self._anomaly.observe_rows(rows)
                if self._audit is not None:
                    self._audit.absorb(schema_cols)

    def _pod_submit_locked(self, tb: TensorBatch) -> None:
        """One TensorBatch onto the pod lane: pack the (4, batch_rows)
        lane plane (a fresh buffer: the pod keeps views) and fan it across
        the shard queues; the TensorBatch recycles at once."""
        lanes = flow_suite.pack_lanes(tb.columns)
        plane = np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])
        self._pod.put_lanes(plane, int(tb.valid))
        self.batcher.recycle(tb)

    def _submit_batch_locked(self, tb: TensorBatch) -> None:
        """One TensorBatch onto the device path: the TensorBatch feed
        (the feed thread never takes _state_lock, so a full queue is
        back-pressure), or the inline path (a `kernel` span when the
        tracer is on)."""
        tr = self._tracer
        if self._feed is not None:
            self._feed.put(tb, tr.current_batch() if tr.enabled else -1)
            return
        with self._on_stream():
            if not tr.enabled:
                self._run_batch_locked(tb)
                return
            before = self.h2d_transfers
            with tr.span("kernel", stream=self.wire, rows=int(tb.valid)):
                self._run_batch_locked(tb)
            if self._detailed:
                tr.gauge("tpu_transfers_per_batch",
                         float(self.h2d_transfers - before))

    def _raise_kernel_error(self) -> None:
        """A kernel failed to build or launch: every later call raises."""
        if self._kernel_error is not None:
            raise self._kernel_error

    def _to_device(self, flat: np.ndarray, pinned: bool) -> torch.Tensor:
        """One staged uint32 buffer -> an int32 device tensor. A pinned
        buffer is copied asynchronously on the copy stream, which the
        compute stream then waits on; a pageable one synchronously. A
        detailed group's copy is bracketed for `kernel.h2d`."""
        self.h2d_bytes += flat.nbytes
        self.h2d_transfers += 1
        host = torch.from_numpy(flat.view(np.int32))
        timed = self._tracer.enabled and self._detailed
        if self._stream is None:
            t0 = time.perf_counter()
            dev = host.clone()
            if timed:
                self._h2d_mark = (time.perf_counter() - t0, None,
                                  flat.nbytes)
            return dev
        stream = self._copy_stream if pinned else self._stream
        if timed:
            ev = (_timing_event(), _timing_event())
            ev[0].record(stream)
        if not pinned:
            dev = host.to(self.device)
        else:
            with torch.cuda.stream(self._copy_stream):
                dev = host.to(self.device, non_blocking=True)
                copied = self._copy_stream.record_event()
            self._stream.wait_event(copied)
            dev.record_stream(self._stream)
        if timed:
            ev[1].record(stream)
            self._h2d_mark = (None, ev, flat.nbytes)
        return dev

    def _fence(self):
        """A fence after the work just dispatched (None on the CPU)."""
        return None if self._stream is None else self._stream.record_event()

    def _dispatch_begin(self) -> None:
        """Fault injection at every device dispatch, and the tracer's
        every-Nth detailed-attribution cadence."""
        if self._faults.enabled:   # chaos: simulated device loss
            self._faults.maybe_raise(FAULT_DEVICE_ERROR, key=self.wire)
        self._h2d_mark = None
        self._attr_pending = []    # a failed dispatch's, never read
        self._group_programs = []
        if self._tracer.enabled or self.busy_reader:
            self._detailed = self._batches_traced % self._attrib_every == 0
            self._batches_traced += 1

    def _timed_update(self, key: str, run, nrows: int) -> None:
        """Call one program (`run`), attributed when the tracer (or a busy
        reader) is on and this group is a detailed one or the program's
        first traced call. On a card a warm attributed call is gated and
        bracketed by timing events on the compute stream; the inline path
        reads them through a synchronize of the last one (the sampled
        drain), the feed when the group's fence retires
        (`_read_attribution` from its release)."""
        tr = self._tracer
        self._group_programs.append(key)
        first = key not in self._warm
        # on the feed, a program's first warm call is gated whatever the
        # cadence, so every group soon has a sample to be sized from
        unsampled = (self._feed is not None and self._busy is not None
                     and not first and not self._busy.has(key)
                     and self._gate_timeouts.get(key, 0) < 2)
        if not (tr.enabled or self.busy_reader) \
                or not (self._detailed or first or unsampled):
            run()
            return
        self._warm.add(key)
        h2d, self._h2d_mark = self._h2d_mark, None
        if self._stream is None:
            t0 = time.perf_counter()
            run()
            dt = time.perf_counter() - t0
            self._read_attribution([(key, first, nrows, dt, dt, h2d, None)])
            return
        ticket = None
        if not first and self._gate_timeouts.get(key, 0) < 2:
            ticket = self._gate.hold(self._stream.cuda_stream)
        ev = (_timing_event(), _timing_event())
        ev[0].record(self._stream)
        t0 = time.perf_counter()
        try:
            run()
        finally:
            dispatch_s = time.perf_counter() - t0
            ev[1].record(self._stream)
            if ticket is not None:
                self._gate.release(ticket)
        rec = (key, first, nrows, dispatch_s, ev, h2d, ticket)
        if self._feed is None:
            ev[1].synchronize()
            self._read_attribution([rec])
        else:
            self._attr_pending.append(rec)

    def _lanes_update(self, key: str, run, nrows: int) -> None:
        """The detection lanes' launches after a program: on a card timed
        (and gated) as a program of their own, `anomaly:<key>`, so the
        busy estimate counts their kernels too; on the CPU untimed."""
        if self._stream is None:
            run()
        else:
            self._timed_update("anomaly:" + key, run, nrows)

    def _read_attribution(self, recs) -> None:
        """Record attributed calls whose events have completed: stages,
        gauges and profiler spans. A record whose events cannot be read
        (its group died on the device) is dropped. On a card a warm
        call's device time counts only when its gate was opened by the
        host: one the timeout released is discarded and counted, and an
        ungated warm call (its program no longer gated) times nothing."""
        tr, prof = self._tracer, self._prof
        traced = tr.enabled
        for key, first, nrows, dispatch_s, dev, h2d, ticket in recs:
            h2d = h2d if traced else None
            try:
                if h2d is not None:
                    h2d_s, ev, nbytes = h2d
                    if ev is not None:
                        h2d_s = ev[0].elapsed_time(ev[1]) / 1e3
                dev_s = dev if not isinstance(dev, tuple) \
                    else dev[0].elapsed_time(dev[1]) / 1e3
            except RuntimeError:
                continue
            if h2d is not None:
                tr.observe("kernel.h2d", h2d_s, stream=self.wire,
                           rows=nrows)
                prof.record("h2d", self.wire, h2d_s, rows=nrows)
                if h2d_s > 0:
                    tr.gauge("tpu_h2d_mb_s", nbytes / 1e6 / h2d_s)
            if first:
                if traced:
                    compile_s = max(dispatch_s, dev_s)
                    tr.observe("kernel.compile", compile_s, stream=key)
                    tr.gauge(f"tpu_compile_s_{key}", compile_s)
                    if self._feed is None:
                        prof.record("device", f"compile:{key}", compile_s)
                continue
            if isinstance(dev, tuple):
                if ticket is None:
                    continue
                if self._gate.verdict(ticket) is not True:
                    self._busy.timed_out(key)
                    self._gate_timeouts[key] = \
                        self._gate_timeouts.get(key, 0) + 1
                    continue
                self._busy.sample(key, dev_s)
            if not traced:
                continue
            tr.observe("kernel.dispatch", dispatch_s, stream=key)
            tr.observe("kernel.device", dev_s, stream=key)
            # the dispatch ended a device execution ago: the timeline
            # shows it before the device span, not on top of it
            prof.record("dispatch", key, dispatch_s,
                        t_end=time.time() - dev_s)
            if self._feed is None:
                # the feed records every group's device span at its fence
                prof.record("device", key, dev_s)

    def _take_attribution(self):
        """The feed's records of the group just dispatched, for its
        release to read once its fence retired."""
        recs, self._attr_pending = self._attr_pending, []
        return recs

    def _apply_wire(self, flat_d: torch.Tensor, sig, rows: int) -> None:
        prog = self._program(
            ("dict", sig), lambda: flow_dict.make_wire_update(self.cfg, sig))

        def run():
            self.state, self._dict_state, _ = prog(
                self.state, self._dict_state, flat_d)
        key = "dict:" + "+".join(f"{k[0]}{w}" for k, w in sig)
        self._timed_update(key, run, rows)
        self.dispatches += 1
        if self._anomaly is not None:
            self._lanes_update(key, lambda: self._anomaly.feed_dict_flat(
                self._dict_state.table, flat_d, sig), rows)

    def _apply_lanes(self, flat_d: torch.Tensor, k: int, c: int,
                     rows: int) -> None:
        prog = self._program(
            ("lanes", k, c),
            lambda: flow_suite.make_coalesced_update(self.cfg, k, c))

        def run():
            self.state, _ = prog(self.state, flat_d)
        self._timed_update(f"lanes_x{k}", run, rows)
        self.dispatches += 1
        if self._anomaly is not None:
            self._lanes_update(
                f"lanes_x{k}",
                lambda: self._anomaly.feed_flat(flat_d, k, c), rows)

    def _run_batch_locked(self, tb: TensorBatch) -> None:
        """Inline path, on the compute stream."""
        if self.degraded:
            self._host_batch_locked(tb)
            return
        self._record_key_tuples(tb.columns)
        if self._dict_packer is None:
            self._stage_lane_slot_locked(tb)
            return
        try:
            self._dispatch_begin()
            wire = self._batch_wire(tb)
            if not wire:
                return
            sig = flow_dict.wire_signature(wire)
            flat = np.empty(flow_dict.wire_words(sig), np.uint32)
            flow_dict.stage_wire(wire, flat)
            self._apply_wire(self._to_device(flat, pinned=False), sig,
                             int(tb.valid))
        except KernelError as e:
            self._kernel_error = e
            raise
        except RuntimeError:
            # a CUDA error or an injected fault; shape bugs (ValueError,
            # TypeError) reach the worker's counter
            self._on_device_error_locked(int(tb.valid))

    def _batch_wire(self, tb: TensorBatch) -> list:
        """The dict packer's wire for one batch's valid rows (pack, then
        flush: the emission order every dict path keeps)."""
        mask = tb.mask()
        cols = {k: v[mask] for k, v in tb.columns.items()}
        return self._dict_packer.pack(cols) + self._dict_packer.flush()

    def _pack_lane_slot(self, flat: np.ndarray, k: int,
                        tb: TensorBatch) -> None:
        """Pack one batch into slot k of a coalesced lanes buffer (its
        valid count first) and recycle the batch."""
        C = self.batch_rows
        flow_suite.pack_lanes_into(tb.columns,
                                   flow_suite.slot_plane(flat, k, C))
        flat[k * flow_suite.slot_words(C)] = tb.valid
        self.batcher.recycle(tb)

    def _stage_lane_slot_locked(self, tb: TensorBatch) -> None:
        """Inline lanes: pack one batch into the next slot; every
        `coalesce_batches` slots cross in one transfer."""
        self._pack_lane_slot(self._flat, self._slots, tb)
        self._slots += 1
        if self._slots == self.coalesce_batches:
            self._ship_lanes_locked()

    def _ship_lanes_locked(self) -> None:
        """Apply the filled prefix of the inline lane buffer (on the
        host when degraded)."""
        k, self._slots = self._slots, 0
        if k == 0:
            return
        C = self.batch_rows
        flat = self._flat[:flow_suite.coalesced_lanes_words(k, C)]
        rows = int(sum(flat[i * flow_suite.slot_words(C)] for i in range(k)))
        if self.degraded:
            if not self._shed_locked(rows):
                self._absorb_lane_slots(flat, k, C)
            return
        try:
            self._dispatch_begin()
            self._apply_lanes(self._to_device(flat, pinned=False), k, C,
                              rows)
        except KernelError as e:
            self._kernel_error = e
            raise
        except RuntimeError:
            self._on_device_error_locked(rows)

    def _count_lost_locked(self, rows: int) -> None:
        """Rows that will reach no window output; the window's
        accumulation is counted lost once."""
        self.lost_rows += rows
        if not self._window_lost_counted:
            self.lost_windows += 1
            self._window_lost_counted = True

    def _shed_locked(self, rows: int) -> bool:
        """True when the rows are refused and counted lost instead of
        going to the host fallback: after a kernel error, and degraded
        on a CUDA device."""
        if self._kernel_error is None and self._host_fallback:
            return False
        self.shed_rows += rows
        self._count_lost_locked(rows)
        return True

    def _on_device_error_locked(self, rows: int) -> None:
        """A group died on the device: roll the state back into fresh
        tensors (newest snapshot, else a fresh init) and, after
        repeated failures, degrade the lane."""
        self.device_errors += 1
        self._consecutive_errors += 1
        self._count_lost_locked(rows)
        _LOG.exception("tpu_sketch device error #%d (consecutive %d)",
                       self.device_errors, self._consecutive_errors)
        try:
            self._restore_device_state_locked()
        except Exception:
            # the device cannot even hold a fresh state: degrade now
            self._consecutive_errors = self.degrade_after
        if self._consecutive_errors >= self.degrade_after:
            self.degraded = True
            if self._host_fallback:
                _LOG.warning("tpu_sketch degraded: host-numpy fallback at "
                             "1/%d rate", self.host_stride)
            else:
                _LOG.warning("tpu_sketch degraded: rows shed, counted lost, "
                             "until a window's probe recovers the device")
        if self._anomaly is not None:
            # the plane's tensors may sit on the same failed work
            with self._on_stream():
                self._anomaly.device_lost()

    def _restore_device_state_locked(self) -> None:
        """Rebuild the device state in fresh tensors: the newest
        compatible snapshot if there is one, else a fresh init. The dict
        wire's packer and device table restart empty: flows re-announce
        as news."""
        with self._on_stream():
            fresh = flow_suite.init(self.cfg, self.device)
            restored = None
            if self.checkpointer is not None:
                restored = self.checkpointer.restore(fresh)
            if restored is not None:
                _LOG.warning("tpu_sketch state restored from snapshot step "
                             "%d (current window %d)",
                             self.checkpointer.last_restored_step,
                             self.windows)
            self.state = restored if restored is not None else fresh
            if self.wire == "dict":
                if self._stager is not None:
                    # new packer generation: in-flight groups of the old
                    # one are dropped as counted loss at dispatch; the
                    # open group's packed rows are counted here
                    self.lost_rows += self._stager.reset_packer()
                else:
                    self._dict_packer = self._new_packer()
                self._dict_state = flow_dict.init_dict(
                    self._packer_capacity, self.device)

    def _host_batch_locked(self, tb: TensorBatch) -> None:
        if self._shed_locked(int(tb.valid)):
            return
        mask = tb.mask()
        self._host_update({k: v[mask] for k, v in tb.columns.items()})

    def _host_update(self, cols: Dict[str, np.ndarray]) -> None:
        if self._host is None:
            self._host = _HostSketch(self.cfg, stride=self.host_stride)
        self.host_rows += self._host.update(cols)

    def _absorb_lane_slots(self, flat: np.ndarray, k: int, C: int) -> None:
        """The host fallback reads staged lane slots through the unpack
        twin: the lanes are the batch by now."""
        s = flow_suite.slot_words(C)
        for i in range(k):
            n = int(flat[i * s])
            if n:
                self._host_update(flow_suite.unpack_lanes_np(
                    flow_suite.slot_plane(flat, i, C), n))

    def _probe_device_locked(self) -> bool:
        """Degraded-mode recovery probe (once per window): a small
        device round trip; healthy -> restore the state and hand the
        lane back to the device. The host window was already flushed,
        so its tallies are dropped, not merged."""
        try:
            if self._faults.enabled:
                self._faults.maybe_raise(FAULT_DEVICE_ERROR, key="probe")
            with self._on_stream():
                probe = torch.ones(8, dtype=torch.int32, device=self.device)
                if int(probe.sum()) != 8:
                    return False
            self._restore_device_state_locked()
        except Exception:
            return False
        self.degraded = False
        self._consecutive_errors = 0
        self.recoveries += 1
        self._host = None
        return True

    # -- overlapped feed: everything below runs on the FEED THREAD -----------
    # It never takes _state_lock: between drain barriers the feed thread
    # is the only writer of the state (feed.py).

    def _feed_process(self, group, absorb, dispatch) -> Optional[InFlight]:
        """Shared shell for one group: the degraded absorb (host
        fallback or shed), or dispatch on the compute stream with the
        device-error rollback counting the whole group."""
        if self.degraded or self._kernel_error is not None:
            for item, _ in group:
                absorb(item)
            return None
        rows = sum(int(item.valid) for item, _ in group)
        tr = self._tracer
        try:
            with self._on_stream():
                if not tr.enabled:
                    return dispatch(group, rows)
                tr.set_batch(group[0][1])
                with tr.span("kernel", stream=self.wire, rows=rows):
                    return dispatch(group, rows)
        except KernelError as e:
            # no rollback, no fallback: kept for the producer to raise
            self._kernel_error = e
            self._shed_locked(rows)
            return None
        except RuntimeError:
            self._on_device_error_locked(rows)
            return None

    def _feed_process_group(self, group) -> Optional[InFlight]:
        """The TensorBatch feed: a group of up to `coalesce_batches`
        (TensorBatch, batch_id) pairs packed into one staging buffer,
        one copy, one program."""
        return self._feed_process(group, self._absorb_tensorbatch,
                                  self._dispatch_group)

    def _absorb_tensorbatch(self, tb: TensorBatch) -> None:
        """Degraded mode reached a TensorBatch: shed, or the host
        fallback."""
        self._host_batch_locked(tb)
        self.batcher.recycle(tb)

    def _dispatch_group(self, group, rows: int) -> Optional[InFlight]:
        self._dispatch_begin()
        before = self.h2d_transfers
        staged = self._dispatch_dict_group(group, rows) \
            if self.wire == "dict" else self._dispatch_lanes_group(group,
                                                                   rows)
        if staged is None:
            # the packer emitted no wire (no valid row): nothing was
            # copied or dispatched, nothing is owed
            return None
        fence, flat = staged
        tr = self._tracer
        if tr.enabled and self._detailed:
            tr.gauge("tpu_transfers_per_batch",
                     (self.h2d_transfers - before) / len(group))
            tr.gauge("tpu_h2d_coalesced_bytes", float(flat.nbytes))
        recs = self._take_attribution()

        def release():
            if recs:
                self._read_attribution(recs)
            self._staging_pool.put(flat)
        return InFlight(fence, rows, release, self._group_programs)

    def _dispatch_lanes_group(self, group, rows: int):
        """K TensorBatches -> K slots of one flat staging buffer -> one
        coalesced lanes update (flow_suite.make_coalesced_update)."""
        K, C = len(group), self.batch_rows
        pool = self._staging_pool
        flat = pool.get(flow_suite.coalesced_lanes_words(K, C))
        for k, (tb, _) in enumerate(group):
            self._record_key_tuples(tb.columns)
            self._pack_lane_slot(flat, k, tb)
        self._apply_lanes(self._to_device(flat, pool.pinned), K, C, rows)
        return self._fence(), flat

    def _dispatch_dict_group(self, group, rows: int):
        """K TensorBatches through the packer (pack + flush per batch,
        the inline emission order) -> the emitted wire staged flat -> one
        signature-keyed program (flow_dict.make_wire_update)."""
        wire = []
        for tb, _ in group:
            self._record_key_tuples(tb.columns)
            wire += self._batch_wire(tb)
            self.batcher.recycle(tb)
        if not wire:
            return None
        sig = flow_dict.wire_signature(wire)
        pool = self._staging_pool
        flat = pool.get(flow_dict.wire_words(sig))
        flow_dict.stage_wire(wire, flat)
        self._apply_wire(self._to_device(flat, pool.pinned), sig, rows)
        return self._fence(), flat

    def _feed_process_staged(self, group) -> Optional[InFlight]:
        """Zero-copy lanes: items are pre-staged groups; this thread
        waits for their packs, copies and dispatches."""
        return self._feed_process(group, self._absorb_staged_host,
                                  self._dispatch_staged)

    def _group_gauges(self, before: int, groups) -> None:
        """A detailed group's coalescing gauges (transfers per batch,
        bytes of the staged transfer)."""
        if self._tracer.enabled and self._detailed:
            self._tracer.gauge("tpu_transfers_per_batch",
                               (self.h2d_transfers - before)
                               / max(1, sum(sg.k for sg in groups)))
            self._tracer.gauge("tpu_h2d_coalesced_bytes",
                               float(sum(sg.flat.nbytes for sg in groups)))

    def _release(self, groups, recs):
        """A fenced group's release: its attribution read, its staging
        buffers recycled."""
        def release():
            if recs:
                self._read_attribution(recs)
            for sg in groups:
                self._stager.recycle(sg)
        return release

    def _dispatch_staged(self, group, rows: int) -> Optional[InFlight]:
        self._dispatch_begin()
        before = self.h2d_transfers
        fence = None
        for sg, _ in group:        # coalesce=1: normally exactly one
            # a host barrier for the sharded pack (not a device sync): a
            # poisoned group raises StagingPackError, which crashes the
            # feed thread into the supervisor on purpose
            sg.wait_ready(timeout=30.0)
            self._apply_lanes(self._to_device(sg.flat, pinned=True),
                              sg.k, sg.capacity, int(sg.valid))
            fence = sg.fence = self._fence()
        groups = [sg for sg, _ in group]
        self._group_gauges(before, groups)
        return InFlight(fence, rows,
                        self._release(groups, self._take_attribution()),
                        self._group_programs)

    def _absorb_staged_host(self, sg) -> None:
        """Degraded mode reached a staged lane group: shed, or the host
        fallback reads its slots through the unpack twin."""
        sg.wait_ready(timeout=30.0)
        if not self._shed_locked(int(sg.valid)):
            self._absorb_lane_slots(sg.flat, sg.k, sg.capacity)
        self._stager.recycle(sg)

    def _feed_process_dict_staged(self, group) -> Optional[InFlight]:
        """Zero-copy dict wire: items are staged wire groups (packed at
        put() time on the producer). A group staged before a device
        restore (a stale epoch) references a dead table generation and
        is dropped as counted loss."""
        return self._feed_process(group, self._absorb_dict_staged_host,
                                  self._dispatch_dict_staged)

    def _drop_stale(self, sg) -> bool:
        """Count and recycle a group of a dead packer generation."""
        if sg.epoch == self._stager.epoch:
            return False
        self._stager.epoch_drops += 1
        self.lost_rows += int(sg.valid)
        self._stager.recycle(sg)
        return True

    def _dispatch_dict_staged(self, group,
                              rows: int) -> Optional[InFlight]:
        self._dispatch_begin()
        before = self.h2d_transfers
        fence = None
        live = []
        for sg, _ in group:        # coalesce=1: normally exactly one
            sg.wait_ready(timeout=30.0)
            if self._drop_stale(sg):
                continue
            self._apply_wire(self._to_device(sg.flat, pinned=True), sg.sig,
                             int(sg.valid))
            fence = sg.fence = self._fence()
            live.append(sg)
        if not live:
            return None            # every group a counted stale drop
        self._group_gauges(before, live)
        return InFlight(fence, sum(int(sg.valid) for sg in live),
                        self._release(live, self._take_attribution()),
                        self._group_programs)

    def _absorb_dict_staged_host(self, sg) -> None:
        """Degraded mode reached a staged wire group: shed, or the host
        fallback walks the unpack twin (news carry their keys; hits
        gather them from the stager's host mirror of the device table)."""
        sg.wait_ready(timeout=30.0)
        if self._drop_stale(sg):
            return
        if not self._shed_locked(int(sg.valid)):
            for cols, n in flow_dict.unpack_wire_np(sg.flat, sg.sig,
                                                    self._stager.mirror):
                if n:
                    self._host_update(cols)
        self._stager.recycle(sg)

    def _program(self, key, build):
        """Signature -> program cache, bounded: a pathological stream
        degrades to rebuilding, not to unbounded growth."""
        prog = self._programs.get(key)
        if prog is None:
            if len(self._programs) >= self._PROGRAM_CACHE_CAP:
                self._programs.clear()
            prog = self._programs[key] = build()
        return prog

    def _feed_fence_error(self, exc: BaseException, rows: int) -> None:
        """An asynchronous device error at a fence: the failed group and
        every younger one arrive as one loss, through the same ladder
        as a synchronous dispatch error."""
        if isinstance(exc, RuntimeError):
            self._on_device_error_locked(rows)
            return
        self._count_lost_locked(rows)
        try:
            self._restore_device_state_locked()
        except Exception:
            self._consecutive_errors = self.degrade_after
            self.degraded = True

    def _feed_crash_restart(self, rows: int) -> None:
        """The supervisor restarted the crashed feed thread: the
        window's rows are counted lost and the state restored (a crash
        mid-program may have left it half-written)."""
        self._count_lost_locked(rows)
        if self.degraded:
            return
        try:
            self._restore_device_state_locked()
        except Exception:
            self._consecutive_errors = self.degrade_after
            self.degraded = True

    def pending_extra(self) -> int:
        """Items the prefetch window still owes the device; a host's
        `Exporters.pending()` adds this to the queue length."""
        return 0 if self._feed is None else self._feed.pending()

    @property
    def snapshot_bus(self) -> SnapshotBus:
        """The snapshot bus readers subscribe to (in-process only
        without a checkpoint_dir)."""
        return self._snapbus

    def checkpoint_now(self) -> bool:
        """Shutdown hook: persist the current accumulation whatever the
        cadence. No-op while degraded (the host sketch is no device
        state) or when the feed does not settle."""
        with self._state_lock:
            # pod mode has no single device state to park here
            if self.checkpointer is None or self.degraded:
                return False
            if self._feed is not None \
                    and not self._feed.drain(timeout=10.0):
                _LOG.error("feed drain timed out; shutdown checkpoint "
                           "skipped")
                return False
            self._raise_kernel_error()
            with self._on_stream():
                self._snapbus.publish(self.state, self.windows,
                                      tags={"final": True})
            return True

    # -- windows -------------------------------------------------------------
    def flush_window(self, now: Optional[float] = None) -> Optional[
            flow_suite.FlowWindowOutput]:
        """Ship what is buffered, wait for the feed, publish the window
        and read it out. None when no output was made (an idle degraded
        window, or a readout that died on the device)."""
        now = time.time() if now is None else now
        tr = self._tracer
        t0 = time.perf_counter()
        if not tr.enabled:
            out = self._flush_window(now)
        else:
            with tr.span("window", stream=self.wire):
                out = self._flush_window(now)
        self._prof.record("window", "flush", time.perf_counter() - t0)
        return out

    def _flush_window(self, now: float) -> Optional[
            flow_suite.FlowWindowOutput]:
        if self._pod is not None:
            out, host_out = self._flush_pod_window(now)
            if out is None:
                return None
            if self.topk_writer is not None:
                self._write_output(host_out, int(now))
            self._hand_to_caller(out)
            self.last_output = out
            return out
        with self._state_lock:
            if self._stager is not None:
                # the open staging prefix ships as it is
                for sg in self._stager.flush():
                    self._feed.put(sg, self._tracer.current_batch()
                                   if self._tracer.enabled else -1)
                if not self._feed.drain(timeout=60.0):
                    # the feed thread never takes _state_lock, so
                    # waiting under it is safe
                    _LOG.error("feed drain timed out; window flushed "
                               "against a possibly advancing state")
            else:
                for tb in self.batcher.flush():
                    self._submit_batch_locked(tb)
                if self._feed is not None:
                    if not self._feed.drain(timeout=60.0):
                        _LOG.error("feed drain timed out; window flushed "
                                   "against a possibly advancing state")
                elif self._dict_packer is None:
                    with self._on_stream():
                        self._ship_lanes_locked()
            self._raise_kernel_error()
            self.windows += 1
            was_degraded = self.degraded
            with self._on_stream():
                if self.degraded:
                    out = None if self._host is None \
                        else self._host.flush(self.cfg)
                    self._rows_at_flush = self.rows_in
                    self._probe_device_locked()
                else:
                    out = self._publish_and_flush_locked(now)
                host_out = self._host_copy(out)
                self._close_lanes_locked(out, host_out, now, was_degraded,
                                         self._window_lost_counted)
            # the lost-window guard resets at the true window boundary
            self._window_lost_counted = False
        if self._anomaly is not None:
            self._anomaly.publish_pending()     # emissions: no lock held
        if out is None:
            return None
        if self.topk_writer is not None:
            self._write_output(host_out, int(now))
        self._hand_to_caller(out)
        self.last_output = out
        return out

    def _hand_to_caller(self, out: flow_suite.FlowWindowOutput) -> None:
        """Hand a readout made on the compute stream to the caller's
        stream: its work on the outputs waits for the flush, and the
        allocator keeps their memory until that work is done."""
        if self._stream is None:
            return
        caller = torch.cuda.current_stream(self.device)
        caller.wait_stream(self._stream)
        for t in out:
            if t.is_cuda:
                t.record_stream(caller)

    def _flush_pod_window(self, now: float):
        """Pod mode: a window flush IS a merge-epoch close, under the state
        lock so the audit shadow and the epoch see the same rows. The
        merged output lands on the compute stream, where the anomaly plane
        scores it with the epoch's participation tags. Returns (output or
        None, its host copy when a reader needs one)."""
        with self._state_lock:
            for tb in self.batcher.flush():
                self._pod_submit_locked(tb)
            self.windows += 1
            with self._on_stream():
                res = self._pod.close_epoch(now=now)
                host_out = self._host_copy(res.out)
                # an epoch that excluded a shard or counted loss closes the
                # lanes lossy: the accuracy alarm never fires on shard loss
                self._close_lanes_locked(
                    res.out, host_out, now, bool(res.degraded), res.lossy,
                    participation={k: res.tags[k] for k in _PARTICIPATION
                                   if k in res.tags})
        if self._anomaly is not None:
            self._anomaly.publish_pending()     # emissions: no lock held
        return res.out, host_out

    def _publish_and_flush_locked(self, now: float):
        # publish the PRE-flush state (the window's accumulation; a
        # restore replays it at least once): to disk on the cadence when
        # the window is dirty, to subscribers on every dirty window,
        # and not at all otherwise
        dirty = self.rows_in != self._rows_at_flush
        want_disk = (self.checkpointer is not None and dirty
                     and self.windows % self.checkpoint_every == 0)
        if want_disk or (dirty and self._snapbus.has_subscribers()):
            self._snapbus.publish(
                self.state, self.windows, wall_time=now,
                tags={"lossy": self._window_lost_counted},
                to_disk=want_disk)
        self._rows_at_flush = self.rows_in
        try:
            self.state, out = flow_suite.flush(self.state, self.cfg)
        except RuntimeError:
            # the readout itself died on the device: the same ladder
            self._on_device_error_locked(0)
            return None
        return out

    def _host_copy(self, out):
        """One host copy of a window output, shared by every reader (None
        when no reader is on)."""
        if out is None or (self._anomaly is None and self._audit is None
                           and self.topk_writer is None):
            return None
        return _host_output(out)

    def _close_lanes_locked(self, out, host_out, now: float,
                            degraded: bool, lossy: bool,
                            participation: Optional[dict] = None) -> None:
        """Close the window on the detection and accuracy lanes. The
        plane scores the device output (None: the window closes
        unscored) with the pod's participation tags, if any; the auditor,
        and an alert's top contributors, read its host copy. The plane
        closes first, so the audit sees its verdict."""
        if self._anomaly is None and self._audit is None:
            return
        if self._anomaly is not None:
            self._anomaly.close_window(out, now=now, lossy=lossy,
                                       degraded=degraded, host_out=host_out,
                                       participation=participation)
        if self._audit is not None:
            self._audit.close_window(
                host_out, degraded=degraded, lossy=lossy,
                detection=None if self._anomaly is None
                else self._anomaly.last_entropy_verdict)

    def _record_key_tuples(self, cols: Dict[str, np.ndarray]) -> None:
        """The sampled host-side flow key -> 5-tuple map that resolves the
        top-K rows (only with a store: nothing else reads it). Heavy
        hitters recur, so a 1/16 stride sample resolves them with near
        certainty. A key seen again moves to the newest end, and the
        oldest keys go at the cap."""
        if self.topk_writer is None:
            return
        sample = [np.asarray(cols[k][::16]) for k in _TUPLE_NAMES]
        keys = fold_columns_np(sample)
        tuples = np.stack([c.astype(np.uint32) for c in sample], axis=1)
        kt = self._key_tuples
        for key, tup in zip(keys.tolist(), tuples.tolist()):
            kt.pop(key, None)
            kt[key] = tup
        while len(kt) > self._KEY_TUPLES_CAP:
            kt.pop(next(iter(kt)))

    def _write_output(self, out: flow_suite.FlowWindowOutput,
                      second: int) -> None:
        """One window's rows into the writers, from its host copy."""
        keys = out.topk_keys.numpy().view(np.uint32)
        counts = out.topk_counts.numpy()
        live = counts > 0
        k = int(live.sum())
        if k:
            rows = {
                "timestamp": np.full(k, second, np.uint32),
                "rank": np.arange(k, dtype=np.uint32),
                "flow_key": keys[live],
                "count": counts[live].astype(np.uint32),
            }
            tuples = np.zeros((k, len(_TUPLE_NAMES)), np.uint32)
            for i, key in enumerate(keys[live].tolist()):
                t = self._key_tuples.get(key)
                if t is not None:
                    tuples[i] = t
            for j, name in enumerate(_TUPLE_NAMES):
                rows[name] = tuples[:, j]
            self.topk_writer.put(rows)
        ent = out.entropies.numpy().astype(np.float32)
        card = out.service_cardinality.numpy()
        self.window_writer.put({
            "timestamp": np.asarray([second], np.uint32),
            "rows": np.asarray([int(out.rows)], np.uint32),
            "entropy_ip_src": ent[0:1], "entropy_ip_dst": ent[1:2],
            "entropy_port_src": ent[2:3], "entropy_port_dst": ent[3:4],
            "distinct_clients": np.asarray([card.sum()], np.uint32),
        })

    def flush(self) -> None:
        """Drain pending sketch-output rows to disk (the ingester's flush
        hook)."""
        for w in self._writers():
            w.flush()

    def _window_loop(self) -> None:
        while not self._window_stop.wait(self.window_seconds):
            self.flush_window()

    @property
    def pod(self):
        """The pod fault-domain layer (a PodFlowSuite or a
        HostPodCoordinator), or None on the single-device lane."""
        return self._pod

    @property
    def anomaly(self) -> Optional[AnomalyPlane]:
        """The anomaly plane, or None when it is off."""
        return self._anomaly

    @property
    def audit_alarm(self) -> bool:
        """True while the shadow auditor's accuracy alarm is tripped."""
        return self._audit is not None and self._audit.alarm

    def counters(self) -> dict:
        c = super().counters()
        c.update({"rows_in": self.rows_in, "windows": self.windows,
                  "h2d_bytes": self.h2d_bytes,
                  "h2d_transfers": self.h2d_transfers,
                  "dispatches": self.dispatches,
                  "batches": (self._stager.staged_batches
                              if self._stager is not None
                              else self.batcher.emitted_batches),
                  "degraded": 1 if self.degraded else 0,
                  "device_errors": self.device_errors,
                  "recoveries": self.recoveries,
                  "lost_windows": self.lost_windows,
                  "lost_rows": self.lost_rows,
                  "host_rows": self.host_rows,
                  "shed_rows": self.shed_rows})
        if self._feed is not None:
            c.update(self._feed.counters())
        if self._busy is not None:
            c.update(self._busy.counters())
        if self._pod is not None:
            # shard states, epoch merges and the pod-wide conservation
            # terms (sent = delivered + host + lost + pending)
            c.update(self._pod.counters())
        if self._stager is not None:
            c["zero_copy"] = 1
            c.update(self._stager.counters())
        c.update(self._snapbus.counters())
        if self._audit is not None:
            c["audit_alarm"] = 1 if self._audit.alarm else 0
            c["audit_windows"] = self._audit.windows
        if self._anomaly is not None:
            # beside rows_in: the detection lane's conservation in one read
            c["anomaly_rows_seen"] = self._anomaly.rows_seen
            c["anomaly_alerts"] = sum(self._anomaly.alerts_total)
            c["anomaly_windows_unscored"] = self._anomaly.windows_unscored
        return c
