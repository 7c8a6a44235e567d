"""Pod fault domains: epoch-merged mergeable sketches, one fault domain
per shard.

The sharded suite (parallel/sharded.py) advances every shard from one
caller: one device error stops the whole mesh, and a slow shard stalls
every merge. The sketches are mergeable (CMS add, HLL max, histogram
add, ring re-top-k), so nothing forces the shards into one failure
domain. `PodFlowSuite` is the fault-domained form of the same math:

- each shard owns a device (shard i on `make_mesh`'s devices[i], so
  several shards may share one card or the CPU), its own
  `FlowSuiteState`, its own CUDA stream, its own supervised worker
  thread and its own bounded ingest queue: a slow or dead shard drops
  COUNTED on its own queue and never blocks ingest on the others;
- a **merge epoch** closes with whatever shards made
  `merge_deadline_s`: each contribution is a host copy of the shard's
  state (`convert.state_to_numpy`, taken at the epoch marker riding the
  shard's own queue, so epoch membership is exact), the merge builds
  one state per contribution on the merge device (the first shard's)
  and runs the sharded suite's `merge_flush` on a stream of its own. A
  straggler past the deadline is EXCLUDED, counted in
  `pod_merge_missed` / `pod_rows_excluded`, not awaited; its late
  contribution merges into the NEXT epoch, exactly;
- each shard carries the device-error ladder privately: a `RuntimeError`
  (a CUDA error, an injected `shard.device_error`) rolls THAT shard back
  into fresh tensors built from its latest bus snapshot (the kernels add
  into the state in place, so the state a failed update touched is
  never kept); past `degrade_after` consecutive errors the shard
  degrades while the rest of the pod keeps merging. Shards that share
  one card share its CUDA context, so a sticky device error (an illegal
  address) reaches them all: there the ladder isolates injected faults
  and recoverable errors, not a failed context. Degraded on a CPU
  device, a host-numpy sketch absorbs its rows at reduced rate; on a
  CUDA device its rows are shed and counted lost (`pod_rows_shed`, part
  of `pod_rows_lost`): work meant for the card never moves to the CPU.
  An epoch-boundary probe brings the shard back;
- a killed shard (`shard.lost` fault / `kill`) **rejoins by snapshot**
  at the next epoch boundary: its last bus snapshot re-enters as a late
  contribution and the shard restarts with fresh state. Only rows past
  the last snapshot are lost, and they are counted.

A `KernelError` (a kernel that cannot be built, loaded or launched) is
no device error: the worker counts the batch's rows lost and keeps the
error for the pod, and every shard worker sheds (counts lost) whatever
its queue still holds; the next `put_lanes`, `put_wire`, `close_epoch`
or `close` raises it. It is never rolled back, degraded around or
restarted past.

The POD-MERGED pre-flush state is published to a `SnapshotBus` every
epoch with participation tags (`pod_shards_participated`,
`pod_missing`, `pod_degraded`, `lossy`), so readers see a reduced
participation instead of a silently partial sketch.

Conservation, pod-wide, at every instant under the ledger lock::

    rows_sent == rows_delivered + rows_host + rows_lost + pending_rows()

Wires: **lanes** carries the full ladder; **dict** (replicated news with
interleaved count masks, sharded hits) is for fault-free operation, and
its device errors mark the shard LOST with rows counted (the key table
cannot survive a mid-stream reset without the packer rebuild).

Identity: with no faults and every shard on time, the epoch-merged
output equals the sharded suite's merged flush leaf for leaf on both
wires: the per-shard update is the sharded suite's own per-shard body
(`sharded.update_lanes_shard`, `update_news_shard`,
`update_hits_shard`), never the fused lane kernel, and the merge is
`sharded.merge_flush`.

Device contract (CUDA): every device call a shard worker makes (its
slice's host-to-device copy, the update, the cadence snapshot, the
contribution copy, a fresh init, the probe) runs on the shard's stream;
the merge runs on the merge stream, and its output is handed to the
caller's stream. A shard's slice is made contiguous and copied with a
plain synchronous `.to(device)`.

Not ported (ROADMAP): the reference's tracer gauges of the pod
(`pod_shards_active`, `pod_merge_epoch_s`, `pod_merge_missed`).
"""

from __future__ import annotations

import contextlib
import logging
import queue as _queue
import threading
import time
import uuid
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.models.flow_suite import (FlowSuiteConfig,
                                                  FlowWindowOutput)
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.parallel import sharded
from deepflow_tpu_torch.parallel.mesh import make_mesh
from deepflow_tpu_torch.runtime.faults import (FAULT_MERGE_STALL,
                                               FAULT_SHARD_DEVICE_ERROR,
                                               FAULT_SHARD_LOST,
                                               default_faults)
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.supervisor import default_supervisor

__all__ = ["PodFlowSuite", "EpochResult", "ACTIVE", "DEGRADED", "LOST"]

_LOG = logging.getLogger(__name__)

# shard lifecycle: ACTIVE shards ingest on their device; DEGRADED shards
# absorb on the host fallback (CPU, lanes wire) or shed (CUDA) until a
# probe recovers the device; LOST shards accept nothing (drops counted)
# until rejoin
ACTIVE = "active"
DEGRADED = "degraded"
LOST = "lost"

# the contribution row count is the rows_seen leaf
_ROWS_LEAF = [path for path, _ in convert.SUITE_LEAVES].index("rows_seen")


class _Contribution(NamedTuple):
    """One shard's epoch contribution: host state leaves in the
    reference's order (device contributions), or a reduced-fidelity host
    window output (a degraded shard: participation evidence, never
    merged into the sketch)."""

    shard: int
    epoch: int
    rows: int
    leaves: Optional[Tuple[np.ndarray, ...]]     # None = host (degraded)
    host_out: Optional[FlowWindowOutput] = None
    late: bool = False


class EpochResult(NamedTuple):
    """What one closed merge epoch produced."""

    epoch: int
    out: Optional[FlowWindowOutput]   # merged window output (None: empty)
    tags: Dict[str, Any]              # the published participation tags
    participated: List[int]           # shards whose contribution merged
    missed: List[int]                 # expected but past the deadline
    degraded: List[int]               # shards on the host fallback
    lost: List[int]                   # shards currently LOST
    merged_rows: int                  # rows in the merged output
    host_outputs: List[Tuple[int, FlowWindowOutput]]
    lossy: bool                       # exclusion, counted loss, or a
    #                                   late merge this epoch


class _Shard:
    """One pod fault domain: device, stream, state, queue, worker,
    ledger."""

    def __init__(self, idx: int, device: torch.device, bus: SnapshotBus,
                 queue_batches: int) -> None:
        self.idx = idx
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.bus = bus                     # per-shard snapshot bus
        self.q: _queue.Queue = _queue.Queue(maxsize=queue_batches)
        self.status = ACTIVE
        self.handle = None                 # supervisor ThreadHandle
        self.stop_ev: Optional[threading.Event] = None   # per-spawn
        self.state = None                  # device FlowSuiteState
        self.dtable = None                 # dict wire: device key table
        # ledger (ints mutated under the pod ledger lock)
        self.qrows = 0                     # valid rows sitting in q
        self.active_rows = 0               # rows in the worker's hands
        self.rows_epoch = 0                # rows in the current device state
        self.snap_rows = 0                 # rows covered by the last snapshot
        self.gen = 0                       # bumped per contribution taken
        self.contrib_inflight = 0          # copied, not yet posted
        self.restorable_rows = 0           # LOST: rows a rejoin can recover
        self.rows_in = 0
        self.rows_dropped = 0
        self.rows_lost = 0
        self.rows_shed = 0                 # of rows_lost: shed, not computed
        self.host_rows = 0
        self.device_errors = 0
        self.recoveries = 0
        self.consecutive_errors = 0
        self.last_contributed_epoch = -1
        self.marker_rows = 0               # epoch membership at marker post
        self.batches_since_snapshot = 0
        self._host = None                  # _HostSketch when degraded


class PodFlowSuite:
    """The pod fault-domain layer over N single-device shard lanes.

    `put_lanes(plane, n)` / `put_wire(wire)` partition a batch exactly as
    the sharded suite does (contiguous blocks on the batch axis;
    interleaved count masks for dict news), so per-shard states equal
    the sharded suite's per-shard partials. `close_epoch()` runs the
    deadline-bounded merge; with `epoch_s` a supervised merge thread
    closes epochs on a timer. `device` picks the shards' device type
    (None or "cuda": every visible card; "cpu")."""

    def __init__(self, cfg: FlowSuiteConfig,
                 n_shards: Optional[int] = None,
                 wire: str = "lanes", *,
                 dict_capacity: int = 1 << 16,
                 merge_deadline_s: float = 5.0,
                 epoch_s: Optional[float] = None,
                 degrade_after: int = 2,
                 host_stride: int = 4,
                 snapshot_dir: Optional[str] = None,
                 snapshot_batches: int = 8,
                 queue_batches: int = 64,
                 auto_rejoin: bool = True,
                 name: str = "pod",
                 device="cuda") -> None:
        if wire not in ("lanes", "dict"):
            raise ValueError(f"wire must be 'lanes' or 'dict', got {wire!r}")
        if n_shards is not None and int(n_shards) < 1:
            raise ValueError("pod needs at least one shard")
        devices = make_mesh(n_shards, device=device).axis_devices("data")
        self.n_shards = len(devices)
        self.device = devices[0]            # the merge device
        cuda = self.device.type == "cuda"
        self._merge_stream = torch.cuda.Stream(self.device) if cuda else None
        # the host fallback runs for a CPU device only: degraded on the
        # card, a shard's rows are shed rather than computed on the CPU
        self._host_fallback = not cuda
        self.cfg = cfg
        self.wire = wire
        self.merge_deadline_s = float(merge_deadline_s)
        self.degrade_after = int(degrade_after)
        self.host_stride = int(host_stride)
        self.snapshot_batches = max(1, int(snapshot_batches))
        self.auto_rejoin = bool(auto_rejoin)
        self.name = name
        self._dict_capacity = int(dict_capacity)
        # the POD-MERGED bus readers subscribe to, plus one bus per shard
        # for rollback snapshots and rejoin-by-snapshot (one directory,
        # distinct names)
        self.bus = SnapshotBus(snapshot_dir, name=name)
        self._shards: List[_Shard] = [
            _Shard(i, dev, SnapshotBus(snapshot_dir, name=f"{name}-shard{i}"),
                   queue_batches)
            for i, dev in enumerate(devices)]
        # resume the epoch counter past a prior run's merged snapshots
        last = self.bus.latest_step()
        self.epoch = 0 if last is None else last + 1
        # per-incarnation nonce on shard snapshots: a prior process's
        # snapshot is never restored (its rows may already be delivered)
        self._run_id = uuid.uuid4().hex
        self._ledger = threading.Lock()
        # serializes close_epoch against itself (timer thread vs caller)
        self._close_lock = threading.Lock()
        self._pending: List[_Contribution] = []
        self._merge_inflight = 0           # taken-but-unmerged rows
        # pod-level ledger (mutated under _ledger)
        self.rows_sent = 0
        self.rows_delivered = 0
        self.rows_host = 0
        self.rows_lost = 0
        self.rows_excluded = 0
        self.merges = 0
        self.epochs = 0
        self.merge_missed = 0
        self.rejoins = 0
        self.late_merges = 0
        self.last_merge_s = 0.0
        self._faults = default_faults()
        self._auditor = None
        self._lossy_epoch = False          # counted loss since last close
        self._kernel_error: Optional[KernelError] = None
        self._leaf_specs = convert.leaf_specs(flow_suite.init(cfg, "cpu"))
        for sh in self._shards:
            self._init_shard_state(sh)
            self._spawn_worker(sh)
        self._merge_handle = None
        self._merge_stop = threading.Event()
        if epoch_s is not None:
            period = float(epoch_s)

            def _merge_loop() -> None:
                while not self._merge_stop.wait(period):
                    if self._kernel_error is not None:
                        return     # raised once into the supervisor
                    default_supervisor().beat()
                    self.close_epoch()

            self._merge_handle = default_supervisor().spawn(
                f"{name}-merge", _merge_loop, beat_period_s=period)

    # -- construction helpers ----------------------------------------------
    @staticmethod
    def _on_stream(sh: _Shard):
        """Enter the shard's stream (a no-op on the CPU)."""
        if sh.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(sh.stream)

    def _init_shard_state(self, sh: _Shard) -> None:
        with self._on_stream(sh):
            sh.state = flow_suite.init(self.cfg, sh.device)
            if self.wire == "dict":
                sh.dtable = flow_dict.init_dict(self._dict_capacity,
                                                sh.device)

    def _spawn_worker(self, sh: _Shard) -> None:
        # each spawn gets its OWN stop event, captured by the closure: a
        # replacement spawned at rejoin can never be halted by (or race)
        # its predecessor's stop
        ev = threading.Event()
        sh.stop_ev = ev
        sh.handle = default_supervisor().spawn(
            f"{self.name}-shard-{sh.idx}", lambda: self._worker(sh, ev))

    def attach_auditor(self, auditor) -> None:
        """Attach a ShadowAuditor (runtime/audit.py): host batches are
        mirrored at `put_lanes` (the unpack twin of the plane) and the
        audit closes against the MERGED epoch output, tagged lossy or
        degraded whenever the epoch excluded a shard or counted loss.
        Lanes wire only."""
        self._auditor = auditor

    def _raise_kernel_error(self) -> None:
        """A shard's kernel failed to build or launch: every later call
        raises."""
        if self._kernel_error is not None:
            raise self._kernel_error

    # -- ingest (producer side; never blocks on a slow shard) --------------
    def put_lanes(self, plane: np.ndarray, n: int) -> None:
        """One (4, B) packed-lane plane with n valid rows, B divisible by
        n_shards. Shard i consumes columns [i*b, (i+1)*b) with the
        sharded suite's global-position mask. Takes ownership of `plane`
        (shards keep views); pass a freshly packed buffer."""
        if self.wire != "lanes":
            raise ValueError("put_lanes on a dict-wire pod")
        self._raise_kernel_error()
        b = plane.shape[1] // self.n_shards
        if b * self.n_shards != plane.shape[1]:
            raise ValueError(
                f"batch width {plane.shape[1]} not divisible by "
                f"{self.n_shards} shards")
        n = int(n)
        with self._ledger:
            # absorb, booking and enqueue are one atomic step against
            # close_epoch's marker post: a batch is wholly before or
            # wholly after an epoch on every shard and in the shadow
            if self._auditor is not None and n:
                self._auditor.absorb(flow_suite.unpack_lanes_np(plane, n))
            self.rows_sent += n
            for sh in self._shards:
                off = sh.idx * b
                valid = max(0, min(b, n - off))
                if self._book_locked(sh, valid):
                    self._enqueue_locked(
                        sh, ("lanes", plane[:, off:off + b], off, n), valid)

    def put_wire(self, wire: List[Tuple[str, np.ndarray, int]]) -> None:
        """A flow_dict wire sequence [(kind, plane, n), ...] in emission
        order: news planes go to every shard (each record COUNTED by
        exactly one, interleaved as the sharded suite does), hits planes
        split on the pairs axis."""
        if self.wire != "dict":
            raise ValueError("put_wire on a lanes-wire pod")
        self._raise_kernel_error()
        nd = self.n_shards
        for kind, plane, n in wire:
            n = int(n)
            if kind == "news":
                with self._ledger:
                    self.rows_sent += n
                    for sh in self._shards:
                        counted = len(range(sh.idx, n, nd))
                        if self._book_locked(sh, counted):
                            self._enqueue_locked(
                                sh, ("news", plane, n), counted)
            else:
                hp = plane.shape[1] // nd
                if hp * nd != plane.shape[1]:
                    raise ValueError(
                        f"hits width {plane.shape[1]} not divisible by "
                        f"{nd} shards")
                with self._ledger:
                    self.rows_sent += n
                    for sh in self._shards:
                        off = sh.idx * hp
                        valid = max(0, min(hp, n - off)) \
                            + max(0, min(hp, n - (hp * nd + off)))
                        if self._book_locked(sh, valid):
                            self._enqueue_locked(
                                sh, ("hits", plane[:, off:off + hp], off, n),
                                valid)

    def _book_locked(self, sh: _Shard, rows: int) -> bool:
        """Ledger booking of one shard's slice (ledger lock held): True
        when the slice should enqueue, False when the shard is LOST (drop
        counted)."""
        sh.rows_in += rows
        if sh.status == LOST:
            sh.rows_dropped += rows
            self._count_lost_locked(sh, rows)
            return False
        sh.qrows += rows
        return True

    def _enqueue_locked(self, sh: _Shard, item: tuple, rows: int) -> None:
        """Non-blocking enqueue of a booked slice (ledger lock held); a
        full queue (straggler back-pressure) drops COUNTED, so ingest on
        the other shards never blocks on this one."""
        try:
            sh.q.put_nowait(item + (rows,))
        except _queue.Full:
            sh.qrows -= rows
            sh.rows_dropped += rows
            self._count_lost_locked(sh, rows)

    def _count_lost_locked(self, sh: _Shard, rows: int) -> None:
        sh.rows_lost += rows
        self.rows_lost += rows
        self._lossy_epoch = self._lossy_epoch or rows > 0

    # -- shard worker -------------------------------------------------------
    def _worker(self, sh: _Shard, stop_ev: threading.Event) -> None:
        sup = default_supervisor()
        while not stop_ev.is_set():
            try:
                item = sh.q.get(timeout=0.2)
            except _queue.Empty:
                sup.beat()
                continue
            sup.beat()
            if item[0] == "epoch":
                self._contribute(sh, item[1])
                continue
            rows = item[-1]
            with self._ledger:
                # queued -> active, never a gap: pending_rows() must not
                # see a transient undercount while a batch updates
                sh.qrows -= rows
                sh.active_rows = rows
                if sh.status == LOST:
                    # killed while this item sat queued: counted, done
                    sh.active_rows = 0
                    self._count_lost_locked(sh, rows)
                    continue
            if self._faults.enabled and self._faults.should_fire(
                    FAULT_SHARD_LOST, key=f"shard{sh.idx}:lost"):
                # simulated host loss: the worker dies mid-epoch; rows past
                # the last snapshot are lost (counted), snapshotted rows
                # stay restorable for the rejoin
                self._mark_lost(sh, extra_rows=rows)
                return
            if self._kernel_error is not None:
                self._shed(sh, rows)
                continue
            if sh.status == DEGRADED:
                self._absorb_host(sh, item, rows)
                continue
            try:
                self._apply_device(sh, item, rows)
            except KernelError as e:
                # no rollback, no degrade, no restart: kept for the
                # producer's next call to raise
                with self._ledger:
                    sh.active_rows = 0
                    self._count_lost_locked(sh, rows)
                    if self._kernel_error is None:
                        self._kernel_error = e
                _LOG.error("%s shard %d kernel error: %s", self.name,
                           sh.idx, e)
            except RuntimeError:
                # a CUDA error or an injected fault; anything else is a bug
                # that crashes into the supervisor with its rows counted
                self._on_device_error(sh, rows)
            except Exception:
                with self._ledger:
                    sh.active_rows = 0
                    self._count_lost_locked(sh, rows)
                    self._lossy_epoch = True
                raise

    def _apply_device(self, sh: _Shard, item: tuple, rows: int) -> None:
        if self._faults.enabled:
            self._faults.maybe_raise(FAULT_SHARD_DEVICE_ERROR,
                                     key=f"shard{sh.idx}:update")
        kind = item[0]
        with self._on_stream(sh):
            p = sharded._as_tensor(np.ascontiguousarray(item[1])).to(
                sh.device)
            if kind == "lanes":
                _, _, off, n, _ = item
                sh.state = sharded.update_lanes_shard(sh.state, p, off, n,
                                                      self.cfg)
            elif kind == "news":
                _, _, n, _ = item
                sh.state, sh.dtable = sharded.update_news_shard(
                    sh.state, sh.dtable, p, n, sh.idx, self.n_shards,
                    self.cfg)
            else:  # hits
                _, _, off, n, _ = item
                sh.state = sharded.update_hits_shard(
                    sh.state, sh.dtable, p, off, n, self.n_shards, self.cfg)
        with self._ledger:
            sh.active_rows = 0
            if sh.status == LOST:
                # killed mid-update: the state is about to be discarded,
                # so these rows are loss, not accumulation
                self._count_lost_locked(sh, rows)
                return
            sh.rows_epoch += rows
            sh.consecutive_errors = 0
        sh.batches_since_snapshot += 1
        if sh.batches_since_snapshot >= self.snapshot_batches:
            self._snapshot_shard(sh)

    def _snapshot_shard(self, sh: _Shard) -> None:
        """Mid-epoch rollback point: the shard's partial state goes to
        its bus tagged with the epoch, so a device error (or kill) loses
        at most `snapshot_batches` batches of this shard's slice."""
        with self._on_stream(sh):
            sh.bus.publish(sh.state, step=self.epoch,
                           tags={"epoch": self.epoch, "rows": sh.rows_epoch,
                                 "gen": sh.gen, "run": self._run_id},
                           to_disk=sh.bus.directory is not None)
        with self._ledger:
            sh.snap_rows = sh.rows_epoch
        sh.batches_since_snapshot = 0

    def _shed(self, sh: _Shard, rows: int) -> None:
        """Refuse the rows, counted lost (a degraded shard on a CUDA
        device, or after a kernel error)."""
        with self._ledger:
            sh.active_rows = 0
            sh.rows_shed += rows
            self._count_lost_locked(sh, rows)
            self._lossy_epoch = True

    def _absorb_host(self, sh: _Shard, item: tuple, rows: int) -> None:
        """Degraded shard: the reduced-rate host fallback (lanes wire on
        a CPU device; the slice unpacks through the numpy twin), else
        shed."""
        if item[0] != "lanes" or not self._host_fallback:
            self._shed(sh, rows)
            return
        _, plane, off, n, _ = item
        valid = max(0, min(plane.shape[1], int(n) - int(off)))
        if valid:
            if sh._host is None:
                from deepflow_tpu_torch.runtime.tpu_sketch import _HostSketch
                sh._host = _HostSketch(self.cfg, stride=self.host_stride)
            sh._host.update(flow_suite.unpack_lanes_np(plane, valid))
        with self._ledger:
            sh.active_rows = 0
            sh.host_rows += rows
            self.rows_host += rows

    def _on_device_error(self, sh: _Shard, batch_rows: int) -> None:
        """Shard-scoped rollback: rebuild THIS shard in fresh tensors from
        its latest same-generation bus snapshot (else a fresh init); only
        rows past the snapshot (plus the failed batch) are lost. Past
        degrade_after consecutive errors the shard degrades (lanes wire)
        or is LOST (dict wire) while the rest of the pod keeps merging."""
        sh.device_errors += 1
        sh.consecutive_errors += 1
        _LOG.exception("%s shard %d device error #%d (consecutive %d)",
                       self.name, sh.idx, sh.device_errors,
                       sh.consecutive_errors)
        if self.wire == "dict":
            self._mark_lost(sh, extra_rows=batch_rows)
            return
        restored_rows = 0
        try:
            restored = self._restore_from_bus(sh)
            if restored is not None:
                sh.state, restored_rows = restored
            else:
                self._init_shard_state(sh)
        except Exception:
            # the device cannot even hold a state: degrade now
            sh.consecutive_errors = self.degrade_after
            restored_rows = 0
        with self._ledger:
            sh.active_rows = 0
            lost = sh.rows_epoch - restored_rows + batch_rows
            self._count_lost_locked(sh, lost)
            sh.rows_epoch = restored_rows
            sh.snap_rows = restored_rows
            self._lossy_epoch = True
        sh.batches_since_snapshot = 0
        if sh.consecutive_errors >= self.degrade_after:
            with self._ledger:
                sh.status = DEGRADED
            if self._host_fallback:
                _LOG.warning("%s shard %d degraded: host fallback at 1/%d "
                             "rate", self.name, sh.idx, self.host_stride)
            else:
                _LOG.warning("%s shard %d degraded: rows shed, counted lost, "
                             "until an epoch's probe recovers the device",
                             self.name, sh.idx)

    def _snapshot_ok(self, sh: _Shard, snap) -> bool:
        """A snapshot of this run and this contribution generation, with
        the current config's leaves: no contribution was taken since it
        was written, so its rows are not posted for merge yet."""
        return (snap is not None and snap.tags.get("run") == self._run_id
                and snap.tags.get("gen") == sh.gen
                and len(snap.leaves) == len(self._leaf_specs)
                and all(a.shape == s and a.dtype == dt for a, (s, dt)
                        in zip(snap.leaves, self._leaf_specs)))

    def _restore_from_bus(self, sh: _Shard) -> Optional[Tuple[Any, int]]:
        """(fresh device state, rows) from the shard's latest bus
        snapshot, if `_snapshot_ok` (a pre-contribution snapshot's rows
        were already posted for merge: restoring it would double-count
        them)."""
        snap = sh.bus.latest()
        if not self._snapshot_ok(sh, snap):
            return None
        with self._on_stream(sh):
            state, _ = convert.state_from_numpy(list(snap.leaves),
                                                device=sh.device)
            if self.wire == "dict":
                sh.dtable = flow_dict.init_dict(self._dict_capacity,
                                                sh.device)
        return state, int(snap.tags.get("rows", 0))

    def _mark_lost(self, sh: _Shard, extra_rows: int = 0) -> None:
        # trust the BUS for the restorable row count: a kill racing
        # _snapshot_shard between its publish and its ledger update would
        # otherwise count the newest snapshot's rows lost AND deliver them
        snap = sh.bus.latest()
        snap_rows = sh.snap_rows
        if snap is not None and snap.tags.get("run") == self._run_id \
                and snap.tags.get("gen") == sh.gen:
            snap_rows = max(snap_rows, int(snap.tags.get("rows", 0)))
        with self._ledger:
            if extra_rows:               # the item in the worker's hands
                sh.active_rows = 0
            lost = sh.rows_epoch - snap_rows + extra_rows
            self._count_lost_locked(sh, lost)
            sh.restorable_rows = snap_rows
            sh.rows_epoch = 0
            sh.snap_rows = 0
            sh.status = LOST
            self._lossy_epoch = True
        _LOG.warning("%s shard %d LOST (%d rows counted lost, %d "
                     "restorable from its snapshot)", self.name, sh.idx,
                     lost, sh.restorable_rows)

    # -- contribution (worker side of the epoch protocol) -------------------
    def _contribute(self, sh: _Shard, epoch: int) -> None:
        """The shard reached epoch `epoch`'s marker on its own queue: hand
        the coordinator a host copy of its state and reset for the next
        epoch (one device-to-host copy per shard per epoch). The
        `merge.stall` fault fires between the copy and the post."""
        degraded = sh.status == DEGRADED
        host_out = None
        if degraded and sh._host is not None:
            host_out = sh._host.flush(self.cfg)
        # a degraded shard may still hold device rows it restored from its
        # snapshot before the degrade: they contribute too
        leaves = None
        rows = 0
        if not degraded or sh.rows_epoch > 0:
            try:
                with self._on_stream(sh):
                    leaves = tuple(convert.state_to_numpy(sh.state))
            except RuntimeError:
                # device lost at the epoch copy: the same ladder as a
                # failed update; this shard reads as missed and its
                # restored rows contribute next epoch
                self._on_device_error(sh, 0)
                if host_out is None:
                    return
            if leaves is not None:
                rows = int(leaves[_ROWS_LEAF])
                with self._ledger:
                    if sh.status == LOST:
                        # killed while the copy was in flight: _mark_lost
                        # already counted these rows
                        return
                    if rows != sh.rows_epoch:
                        _LOG.error("%s shard %d ledger drift: device "
                                   "rows_seen %d != tracked %d", self.name,
                                   sh.idx, rows, sh.rows_epoch)
                    sh.contrib_inflight = rows
                    sh.rows_epoch = 0
                    sh.snap_rows = 0
                    # invalidate pre-contribution snapshots: their rows are
                    # in this contribution
                    sh.gen += 1
                sh.batches_since_snapshot = 0
                # reset the sketch state only: the dict wire's key table
                # persists across epochs, as the sharded suite's does
                try:
                    with self._on_stream(sh):
                        sh.state = flow_suite.init(self.cfg, sh.device)
                except RuntimeError:
                    # the contribution is intact on the host, but the
                    # device refused a fresh state: degrade NOW so the
                    # stale state is never contributed twice
                    sh.device_errors += 1
                    with self._ledger:
                        sh.consecutive_errors = self.degrade_after
                        sh.status = DEGRADED
                        self._lossy_epoch = True
                    _LOG.exception("%s shard %d degraded: state reset "
                                   "failed after contribution copy",
                                   self.name, sh.idx)
                    degraded = True
        if self._faults.enabled:
            # keys `shardN:<site>`: `match=shardN:` targets one domain even
            # on pods of 10 shards or more
            self._faults.maybe_stall(FAULT_MERGE_STALL,
                                     key=f"shard{sh.idx}:stall")
        with self._ledger:
            self._pending.append(_Contribution(sh.idx, epoch, rows, leaves,
                                               host_out=host_out))
            sh.contrib_inflight = 0
            sh.last_contributed_epoch = epoch
        if degraded:
            self._probe_device(sh)

    def _probe_device(self, sh: _Shard) -> bool:
        """Degraded-shard recovery probe at the epoch boundary: a small
        device round trip on the shard's stream; healthy -> fresh state,
        back to ACTIVE."""
        try:
            if self._faults.enabled:
                self._faults.maybe_raise(FAULT_SHARD_DEVICE_ERROR,
                                         key=f"shard{sh.idx}:probe")
            with self._on_stream(sh):
                probe = torch.ones(8, dtype=torch.int32, device=sh.device)
                if int(probe.sum()) != 8:
                    return False
            self._init_shard_state(sh)
        except Exception:
            return False
        with self._ledger:
            sh.status = ACTIVE
            sh.consecutive_errors = 0
            sh.recoveries += 1
            sh._host = None
        _LOG.warning("%s shard %d recovered: back on device", self.name,
                     sh.idx)
        return True

    # -- the merge epoch (coordinator) --------------------------------------
    def close_epoch(self, now: Optional[float] = None,
                    deadline_s: Optional[float] = None) -> EpochResult:
        """Close the current merge epoch: post the epoch marker on every
        live shard's queue (epoch membership is exactly "rows enqueued
        before this call"), wait up to the deadline, merge whatever
        contributions are in, count the rest. LOST shards rejoin at this
        boundary when auto_rejoin is on."""
        with self._close_lock:
            return self._close_epoch_serialized(now, deadline_s)

    def _close_epoch_serialized(self, now: Optional[float],
                                deadline_s: Optional[float]) -> EpochResult:
        # holds _close_lock, NOT _ledger: marker puts and the deadline
        # wait must not starve the workers
        self._raise_kernel_error()
        t0 = time.perf_counter()
        ep = self.epoch
        with self._ledger:
            # an idle pod (nothing queued, accumulated or pending, every
            # shard healthy, no loss to tag) skips the epoch entirely
            idle = (not self._pending and not self._lossy_epoch
                    and all(sh.status == ACTIVE and sh.qrows == 0
                            and sh.active_rows == 0 and sh.rows_epoch == 0
                            and sh.contrib_inflight == 0
                            for sh in self._shards))
        if idle:
            return EpochResult(ep, None, {}, [], [], [], [], 0, [], False)
        with self._ledger:
            expected = [sh.idx for sh in self._shards
                        if sh.status in (ACTIVE, DEGRADED)]
            lost_now = [sh.idx for sh in self._shards if sh.status == LOST]
            # every marker posts inside ONE ledger section, atomic against
            # put_lanes/put_wire: each marker_rows membership snapshot is
            # exact, and rows arriving during the wait belong to the NEXT
            # epoch
            for sh in self._shards:
                if sh.idx in expected:
                    sh.marker_rows = (sh.qrows + sh.active_rows
                                      + sh.rows_epoch + sh.contrib_inflight)
                    try:
                        sh.q.put_nowait(("epoch", ep))
                    except _queue.Full:
                        # a deep straggler: reads as missed, merges late
                        pass
        deadline = time.monotonic() + (self.merge_deadline_s
                                       if deadline_s is None
                                       else float(deadline_s))
        while time.monotonic() < deadline:
            with self._ledger:
                got = {c.shard for c in self._pending if c.epoch == ep}
            if set(expected) <= got or self._kernel_error is not None:
                break
            time.sleep(0.002)
        self._raise_kernel_error()
        with self._ledger:
            take, self._pending = self._pending, []
            # lossy is snapped at the take: loss counted while shards
            # drained THIS epoch's backlog belongs to this window
            lossy = self._lossy_epoch
            self._lossy_epoch = False
            # taken contributions stay ledger-visible through the merge
            self._merge_inflight = sum(c.rows for c in take
                                       if c.leaves is not None)
            got = {c.shard for c in take if c.epoch == ep}
            missed = [i for i in expected if i not in got]
            for i in missed:
                self.merge_missed += 1
                # rows this epoch's answer lacked at close (the marker's
                # membership snapshot); they merge late, not lost
                self.rows_excluded += self._shards[i].marker_rows
            degraded_now = [sh.idx for sh in self._shards
                            if sh.status == DEGRADED]
        device_contribs = sorted((c for c in take if c.leaves is not None),
                                 key=lambda c: (c.epoch, c.shard))
        host_outputs = [(c.shard, c.host_out) for c in take
                        if c.host_out is not None]
        late = [c for c in device_contribs if c.epoch < ep or c.late]
        # a late merge makes THIS epoch lossy too: its output carries rows
        # its own window never covered
        lossy = lossy or bool(missed) or bool(late)
        out = None
        merged_rows = 0
        if device_contribs:
            try:
                out, merged_rows = self._merge_epoch(
                    device_contribs, ep, now=now, missed=missed,
                    degraded=degraded_now, lost=lost_now, lossy=lossy)
            except Exception:
                # the merge itself died: the taken contributions cannot
                # deliver, so count them LOST before surfacing the crash
                with self._ledger:
                    for c in device_contribs:
                        self._count_lost_locked(self._shards[c.shard],
                                                c.rows)
                    self._merge_inflight = 0
                    self._lossy_epoch = True
                raise
        participated = sorted({c.shard for c in device_contribs})
        tags = self._epoch_tags(ep, participated, missed, degraded_now,
                                lost_now, lossy, merged_rows)
        with self._ledger:
            self._merge_inflight = 0      # no-contribution epochs too
            self.epochs += 1
            self.late_merges += len(late)
            self.last_merge_s = time.perf_counter() - t0
        self.epoch = ep + 1
        if self.auto_rejoin:
            for i in lost_now:
                self.rejoin(i)
        if self._auditor is not None:
            self._auditor.close_window(
                None if out is None else sharded._host_output(out),
                degraded=bool(degraded_now), lossy=lossy or bool(lost_now))
        return EpochResult(ep, out, tags, participated, missed,
                           degraded_now, lost_now, merged_rows,
                           host_outputs, lossy or bool(lost_now))

    def _merge_epoch(self, contribs: List[_Contribution], ep: int,
                     now: Optional[float], missed: List[int],
                     degraded: List[int], lost: List[int],
                     lossy: bool) -> Tuple[FlowWindowOutput, int]:
        """One state per contribution on the merge device, the sharded
        suite's merged flush over them, and the merged pre-flush state
        published to the pod bus (the merge path's device sync)."""
        out, rows, merged = merge_leaves(
            [c.leaves for c in contribs], self.cfg, self.device,
            self._merge_stream)
        participated = sorted({c.shard for c in contribs})
        # subscribers get every epoch; the fsynced file only when the
        # epoch carried rows
        with _stream_ctx(self._merge_stream):
            self.bus.publish(
                merged, step=ep, wall_time=now, to_disk=rows > 0,
                tags=self._epoch_tags(ep, participated, missed, degraded,
                                      lost, lossy, rows))
        with self._ledger:
            self.merges += 1
            self.rows_delivered += sum(c.rows for c in contribs)
            self._merge_inflight = 0
        return out, rows

    def _epoch_tags(self, ep: int, participated: List[int],
                    missed: List[int], degraded: List[int],
                    lost: List[int], lossy: bool, rows: int) -> dict:
        # NOT pod_shards_active: that counter means "shards in ACTIVE
        # status"; this tag means "shards whose contribution made THIS
        # epoch's merge"
        return {"epoch": ep, "pod_shards": self.n_shards,
                "pod_shards_participated": len(participated),
                "pod_participated": participated,
                "pod_missing": sorted(set(missed) | set(lost)),
                "pod_degraded": degraded,
                "lossy": bool(lossy), "rows": rows}

    # -- kill / rejoin -------------------------------------------------------
    def kill(self, idx: int) -> None:
        """Simulate the loss of one shard (the `shard.lost` fault does the
        same from inside the worker). Rows past its last snapshot are
        counted lost; the snapshot stays restorable for the rejoin."""
        sh = self._shards[idx]
        if sh.status == LOST:
            return
        self._mark_lost(sh)
        # an event, not a queue marker: a put could block on a full queue.
        # The worker notices within its 0.2 s get timeout; its queued
        # backlog stays booked in qrows until rejoin() counts it
        if sh.stop_ev is not None:
            sh.stop_ev.set()
        if sh.handle is not None:
            sh.handle.stop()

    def rejoin(self, idx: int) -> bool:
        """Rejoin-by-snapshot at an epoch boundary: the dead shard's last
        bus snapshot (if no contribution was taken after it) re-enters as
        a LATE contribution, and the shard restarts with fresh state."""
        sh = self._shards[idx]
        if sh.status != LOST:
            return False
        if self.wire == "dict":
            # a rejoined shard with a zeroed key table would count every
            # hit under the all-zero key: it stays LOST, drops counted
            return False
        # the predecessor worker MUST be dead before a replacement spawns;
        # a wedged one defers the rejoin to the next epoch boundary
        if sh.stop_ev is not None:
            sh.stop_ev.set()
        if sh.handle is not None:
            sh.handle.stop()
            sh.handle.join(timeout=2.0)
            if sh.handle.is_alive():
                return False
        stale_rows = 0
        while True:          # drain whatever the dead worker left behind
            try:
                item = sh.q.get_nowait()
            except _queue.Empty:
                break
            if item[0] in ("lanes", "news", "hits"):
                stale_rows += item[-1]
        recovered = 0
        snap = sh.bus.latest()
        if self._snapshot_ok(sh, snap):
            recovered = int(snap.tags.get("rows", 0))
            with self._ledger:
                self._pending.append(_Contribution(
                    sh.idx, int(snap.tags["epoch"]), recovered,
                    tuple(snap.leaves), late=True))
        with self._ledger:
            lost_now = stale_rows + max(0, sh.restorable_rows - recovered)
            sh.qrows = max(0, sh.qrows - stale_rows)
            sh.rows_lost += lost_now
            self.rows_lost += lost_now
            sh.restorable_rows = 0
            sh.status = ACTIVE
            sh.consecutive_errors = 0
            sh.rows_epoch = 0
            sh.snap_rows = 0
            # the recovered snapshot is posted for merge now: a later
            # rollback must never restore it again
            sh.gen += 1
            self.rejoins += 1
        self._init_shard_state(sh)
        self._spawn_worker(sh)
        _LOG.warning("%s shard %d rejoined (%d rows recovered from its bus "
                     "snapshot, %d stale rows counted lost)", self.name, idx,
                     recovered, lost_now)
        return True

    # -- lifecycle / observability -------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for every live shard to go QUIET: queue empty, nothing in
        the worker's hands, no due snapshot unpublished (a consistent cut
        for a kill or close right after)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._ledger:
                quiet = all(
                    sh.status == LOST
                    or (sh.q.empty() and sh.active_rows == 0
                        and sh.batches_since_snapshot < self.snapshot_batches)
                    for sh in self._shards)
            if quiet:
                return True
            time.sleep(0.005)
        return False

    def close(self, final_epoch: bool = True) -> Optional[EpochResult]:
        """Final epoch merge (delivering everything still pending), then
        stop the merge thread and every worker. A kept kernel error is
        raised after the workers stop."""
        self._merge_stop.set()
        if self._merge_handle is not None:
            self._merge_handle.stop()
            self._merge_handle.join(timeout=2)
        res = None
        try:
            if final_epoch:
                self.drain(timeout=10.0)
                res = self.close_epoch()
                with self._ledger:
                    leftovers = any(c.leaves is not None
                                    for c in self._pending)
                if leftovers:
                    # late stragglers of the final epoch: one more merge
                    time.sleep(0.01)
                    res = self.close_epoch(deadline_s=self.merge_deadline_s)
        finally:
            for sh in self._shards:
                # per-worker stop events, never a queue put
                if sh.stop_ev is not None:
                    sh.stop_ev.set()
            for sh in self._shards:
                if sh.handle is not None:
                    sh.handle.stop()
                    sh.handle.join(timeout=5)
        return res

    def pending_rows(self) -> int:
        """Rows accepted but not yet delivered or counted lost: queued, in
        shard states, in flight to a contribution, posted but unmerged,
        restorable after a kill."""
        with self._ledger:
            return self._pending_rows_locked()

    def _pending_rows_locked(self) -> int:
        n = sum(sh.qrows + sh.active_rows + sh.rows_epoch
                + sh.contrib_inflight + sh.restorable_rows
                for sh in self._shards)
        n += sum(c.rows for c in self._pending if c.leaves is not None)
        return n + self._merge_inflight

    def shard_status(self) -> List[dict]:
        with self._ledger:
            return [{"shard": sh.idx, "status": sh.status,
                     "rows_in": sh.rows_in, "rows_lost": sh.rows_lost,
                     "rows_dropped": sh.rows_dropped,
                     "rows_shed": sh.rows_shed,
                     "host_rows": sh.host_rows,
                     "device_errors": sh.device_errors,
                     "recoveries": sh.recoveries,
                     "last_contributed_epoch": sh.last_contributed_epoch}
                    for sh in self._shards]

    def counters(self) -> dict:
        with self._ledger:
            status = [sh.status for sh in self._shards]
            # one locked section: the conservation equality holds within
            # one snapshot
            return {"pod_shards": self.n_shards,
                    "pod_shards_active": status.count(ACTIVE),
                    "pod_shards_degraded": status.count(DEGRADED),
                    "pod_shards_lost": status.count(LOST),
                    "pod_epochs": self.epochs,
                    "pod_merges": self.merges,
                    "pod_merge_missed": self.merge_missed,
                    "pod_rows_sent": self.rows_sent,
                    "pod_rows_delivered": self.rows_delivered,
                    "pod_rows_host": self.rows_host,
                    "pod_rows_lost": self.rows_lost,
                    "pod_rows_shed": sum(sh.rows_shed
                                         for sh in self._shards),
                    "pod_rows_excluded": self.rows_excluded,
                    "pod_rejoins": self.rejoins,
                    "pod_late_merges": self.late_merges,
                    "pod_device_errors": sum(sh.device_errors
                                             for sh in self._shards),
                    "pod_merge_epoch_s": round(self.last_merge_s, 6),
                    "pod_rows_pending": self._pending_rows_locked()}


def _stream_ctx(stream):
    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


def merge_leaves(contribs: List[Tuple[np.ndarray, ...]],
                 cfg: FlowSuiteConfig, device: torch.device, stream=None
                 ) -> Tuple[FlowWindowOutput, int, Any]:
    """Merge host contributions (FlowSuiteState leaves in the reference's
    order) on `device`: one fresh state per contribution, then
    `sharded.merge_flush`, on `stream` when given. Returns (window output
    handed to the caller's stream, its row count, merged pre-flush
    state). The pod and the cross-host pod merge through it."""
    with _stream_ctx(stream):
        states = [convert.state_from_numpy(list(leaves), device=device)[0]
                  for leaves in contribs]
        merged, _fresh, out = sharded.merge_flush(states, cfg)
        rows = int(out.rows)
    if stream is not None:
        # the caller's later work on the output waits for the merge, and
        # the allocator keeps the output's memory until that work is done
        caller = torch.cuda.current_stream(device)
        caller.wait_stream(stream)
        for t in out:
            t.record_stream(caller)
    return out, rows, merged
