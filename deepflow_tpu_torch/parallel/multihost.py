"""Multi-process scale-out: the global mesh and the cross-host pod.

The global mesh. Every process runs the same program and joins one
`torch.distributed` process group (`init_distributed`);
`make_global_mesh` forms one mesh over every shard of every process, in
process order, each process feeding only its own rows through
`process_local_batch`, and the sharded suites (parallel/sharded.py)
merge their windows across processes with collectives, so every process
reads the same merged window. `local_shard` reads this process's rows
of a `data`-sharded output back. This is the horizontal ingester
scale-out: a record's work stays on the process that received it, and
only window state crosses between processes.

The cross-host pod. `HostPodCoordinator` stacks a HOST fault domain on
top of the per-shard pod ladder (parallel/pod.py). Each host runs its
own `PodFlowSuite`; epoch markers and per-host epoch contributions cross
the data-center network (DCN) through a pluggable transport:

- `SimulatedDcnTransport`: in-process queues with seeded marker loss
  (`dcn.marker_loss`), partition and heal (`dcn.partition`), where the
  whole fault ladder runs: marker broadcast over a lossy DCN, deadline
  exclusion of a whole host, host kill (`host.lost`) with
  rejoin-by-snapshot off the host's snapshot bus, partition heal with
  the held contribution merged late next epoch;
- `TorchDcnTransport`: separate processes joined by `torch.distributed`
  (`init_distributed`), each one host. Every process closes its local
  host lane, one all-gather moves every host's epoch leaves and row
  count, and every process computes the identical merge (no leader, no
  marker deadline: a dead host is the collective's error). The exchange
  carries host numpy leaves, so it runs over gloo on CPU tensors, also
  beside a card: one card cannot hold two NCCL ranks, and the leaves
  are on the host already.

Rows are routed to hosts by the flow hash the staging pack pool shards
by (`_HASH_COLS`, `utils.u32.fold_columns_np`), so one flow's sketch
state lives on one host. Host contributions merge through the pod's
`merge_leaves` (the sharded suite's `merge_flush` on the merge device),
and the merged pre-flush state is published with host and shard
participation tags.

Conservation, pod-wide, off one `counters()` snapshot::

    pod_rows_sent == pod_rows_delivered + pod_rows_host + pod_rows_lost
                     + pod_rows_pending

With the process tracer on, every global epoch close sets the gauges
`pod_hosts_active`, `pod_hosts_missed` and `pod_merge_epoch_s`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from datetime import timedelta
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime.tracing import default_tracer
from deepflow_tpu_torch.models.flow_suite import (FlowSuiteConfig,
                                                  check_device)
from deepflow_tpu_torch.parallel.mesh import Mesh, _visible, make_mesh
from deepflow_tpu_torch.parallel.pod import (ACTIVE, LOST, EpochResult,
                                             PodFlowSuite, _stream_ctx,
                                             merge_leaves)
from deepflow_tpu_torch.parallel.sharded import _put_sharded
from deepflow_tpu_torch.runtime.faults import (FAULT_DCN_MARKER_LOSS,
                                               FAULT_DCN_PARTITION,
                                               FAULT_HOST_LOST,
                                               default_faults)
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.supervisor import (ThreadHandle,
                                                   default_supervisor)
from deepflow_tpu_torch.utils.u32 import fold_columns_np

__all__ = ["init_distributed", "make_global_mesh", "process_local_batch",
           "local_shard", "HostPodCoordinator", "SimulatedDcnTransport",
           "TorchDcnTransport", "select_transport", "route_hosts"]

_LOG = logging.getLogger(__name__)

# the flow-hash host key reuses the staging pack pool's 5-tuple column
# order: one flow stream lands on one host
_HASH_COLS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto")


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     timeout_s: float = 300.0) -> int:
    """Join (or stand alone in) a multi-host run; returns the process
    count. With no coordinator this is a no-op (the single-host path);
    with one ("host:port"), every process calls it once with the world
    size and its rank, and a gloo process group is formed over
    `tcp://<coordinator>`."""
    if coordinator is None:
        return _world_size()
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size()


def make_global_mesh(axes: Sequence[str] = ("data",),
                     n_local: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh over every shard of every process of the process group
    (`init_distributed`; one process alone without one). Each process
    holds `n_local` shards (default: its visible devices of `device`'s
    type), on its own devices; the processes' counts are exchanged with
    one all-gather.

    1-D (default): one `data` axis over every process's shards in
    process order, made by `make_mesh`, as the reference does: the
    batch-sharded suites' mesh. 2-D ("dcn_data", "data"): rows are the
    processes, columns each process's shards (every process must hold
    as many)."""
    device = check_device(device)
    visible = len(_visible(device))
    mine = (int(n_local or visible), visible)
    world, rank = _world_size(), _rank()
    held = [mine]
    if world > 1:
        import torch.distributed as dist
        got = [torch.zeros(2, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(got, torch.tensor(mine, dtype=torch.int64))
        held = [tuple(int(v) for v in t.tolist()) for t in got]
    if len(axes) not in (1, 2):
        raise ValueError(f"axes must be 1-D or 2-D, got {axes!r}")
    flat = make_mesh(sum(c for c, _ in held), axes[-1:], device,
                     process_shards=held, process=rank)
    if len(axes) == 1:
        return flat
    if len({c for c, _ in held}) != 1:
        raise ValueError(f"a 2-D global mesh needs as many shards in every "
                         f"process: {[c for c, _ in held]}")
    shape = (world, held[0][0])
    return Mesh(flat.devices.reshape(shape), axes,
                flat.process_index.reshape(shape), rank)


def process_local_batch(cols: Dict[str, Any], mask, mesh: Mesh,
                        axis: str = "data") -> Tuple[list, list]:
    """THIS process's rows of a global batch (global rows / processes, a
    contiguous block of it), split over this process's shards of `axis`
    in shard order: the per-shard (column dicts, masks) that `put_batch`
    returns, valid inputs to the sharded suites over the same mesh. No
    row crosses to another process."""
    return _put_sharded(cols, mask, mesh.local_devices(axis))


def local_shard(x) -> np.ndarray:
    """This process's rows of a `data`-sharded output, as a host array.

    A sequence of per-shard tensors (what `process_local_batch` and
    `put_batch` return for one column) comes back concatenated in shard
    order. One tensor is returned whole, once: a replicated output (a
    merged window's scalars, on the first local shard's device) or an
    output the suite already concatenated over this process's shards
    (the metrics suite's `anomaly_scores`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.concatenate([t.detach().cpu().numpy() for t in x])


def route_hosts(plane: np.ndarray, n: int, n_hosts: int) -> np.ndarray:
    """The host of each of a (4, B) lane plane's first n rows: the flow
    hash of its 5-tuple modulo n_hosts."""
    cols = flow_suite.unpack_lanes_np(plane, n)
    return fold_columns_np([cols[c] for c in _HASH_COLS]) % np.uint32(n_hosts)


# ---------------------------------------------------------------------------
# DCN transports
# ---------------------------------------------------------------------------

class _DcnMessage(NamedTuple):
    """One host's epoch contribution crossing the DCN leader-ward.

    `(host, gen, local_epoch)` is the leader's dedup key: a rejoin
    re-ships the dead incarnation's unshipped outbox, and a kill between
    a send and its outbox pop re-ships an already-delivered entry.
    `rows == 0` with `leaves is None` is a participation heartbeat
    (never merged, never deduped)."""

    host: int
    gen: int
    local_epoch: int
    global_epoch: int
    rows: int
    leaves: Optional[Tuple[np.ndarray, ...]]
    late: bool = False


class SimulatedDcnTransport:
    """In-process DCN with the fault surface of a real one.

    A per-host marker link (leader -> host) and one contribution channel
    (hosts -> leader). A partition severs both directions of one host's
    link; severed traffic is HELD BACK, not dropped, and delivered FIFO
    at `heal` (the healed host's contribution then reads as a
    prior-epoch late merge). Marker loss is the only way a message
    vanishes, and the caller counts it from the False return. Fault keys
    are `host{i}`."""

    collective = False

    def __init__(self, n_hosts: int, *,
                 heal_after_s: Optional[float] = None) -> None:
        self.n_hosts = int(n_hosts)
        self.heal_after_s = heal_after_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._marker_q = [collections.deque() for _ in range(n_hosts)]
        self._marker_hold: List[list] = [[] for _ in range(n_hosts)]
        self._contrib_q: collections.deque = collections.deque()
        self._contrib_hold: List[list] = [[] for _ in range(n_hosts)]
        self._link = [True] * n_hosts
        self._severed_at = [0.0] * n_hosts
        self._partitions = 0
        self._heals = 0
        self._closed = False
        self._faults = default_faults()

    # -- link state ---------------------------------------------------------
    def partition(self, host: int) -> None:
        """Sever one host's DCN link (both directions)."""
        with self._cv:
            if not self._link[host]:
                return
            self._link[host] = False
            self._severed_at[host] = time.monotonic()
            self._partitions += 1

    def heal(self, host: Optional[int] = None) -> None:
        """Restore severed links and deliver everything held back, FIFO:
        the healed host sees every missed marker, the leader sees the
        held contributions as prior-epoch arrivals (merged late)."""
        with self._cv:
            hosts = range(self.n_hosts) if host is None else (host,)
            self._heal_hosts_locked(hosts)

    def _heal_hosts_locked(self, hosts) -> None:
        for h in hosts:
            if self._link[h]:
                continue
            self._link[h] = True
            self._heals += 1
            self._marker_q[h].extend(self._marker_hold[h])
            self._marker_hold[h].clear()
            self._contrib_q.extend(self._contrib_hold[h])
            self._contrib_hold[h].clear()
        self._cv.notify_all()

    def _auto_heal_locked(self) -> None:
        if self.heal_after_s is None:
            return
        now = time.monotonic()
        due = [h for h in range(self.n_hosts)
               if not self._link[h]
               and now - self._severed_at[h] >= self.heal_after_s]
        if due:
            self._heal_hosts_locked(due)

    def link_up(self, host: int) -> bool:
        with self._lock:
            return self._link[host]

    # -- marker link (leader -> host) ---------------------------------------
    def send_marker(self, host: int, marker: Dict[str, Any]) -> bool:
        """False when the marker was LOST in transit (`dcn.marker_loss`);
        a severed link holds it back instead (True: held, not lost)."""
        if self._faults.enabled and self._faults.should_fire(
                FAULT_DCN_PARTITION, f"host{host}"):
            self.partition(host)
        with self._cv:
            self._auto_heal_locked()
            if self._link[host] and self._faults.enabled \
                    and self._faults.should_fire(FAULT_DCN_MARKER_LOSS,
                                                 f"host{host}"):
                return False
            if not self._link[host]:
                self._marker_hold[host].append(dict(marker))
            else:
                self._marker_q[host].append(dict(marker))
                self._cv.notify_all()
            return True

    def recv_marker(self, host: int,
                    timeout: float = 0.05) -> Optional[Dict[str, Any]]:
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._marker_q[host] and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cv.wait(left)
            if self._marker_q[host]:
                return self._marker_q[host].popleft()
            return None

    # -- contribution channel (host -> leader) ------------------------------
    def send_contribution(self, host: int, msg: _DcnMessage) -> bool:
        with self._cv:
            self._auto_heal_locked()
            if not self._link[host]:
                self._contrib_hold[host].append(msg)
            else:
                self._contrib_q.append(msg)
                self._cv.notify_all()
            return True

    def recv_contributions(self) -> List[_DcnMessage]:
        with self._cv:
            self._auto_heal_locked()
            out = list(self._contrib_q)
            self._contrib_q.clear()
            return out

    # -- observability / lifecycle ------------------------------------------
    def quiet(self) -> bool:
        """Nothing queued or held anywhere on the DCN."""
        with self._lock:
            return (not self._contrib_q
                    and not any(self._marker_q)
                    and not any(self._marker_hold)
                    and not any(self._contrib_hold))

    def counters(self) -> Dict[str, int]:
        with self._lock:
            held = (sum(len(q) for q in self._marker_hold)
                    + sum(len(q) for q in self._contrib_hold))
            return {"dcn_partitions": self._partitions,
                    "dcn_heals": self._heals,
                    "dcn_held_messages": held,
                    "dcn_links_down": sum(1 for up in self._link if not up)}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def to_words(leaves: List[np.ndarray], rows: int) -> np.ndarray:
    """One host's epoch payload as the collective carries it: every
    leaf's 32-bit words, then the row count as two words."""
    return np.concatenate([np.asarray(a).reshape(-1).view(np.int32)
                           for a in leaves]
                          + [np.asarray([rows], np.int64).view(np.int32)])


def from_words(words: np.ndarray, like: List[np.ndarray]
               ) -> Tuple[Tuple[np.ndarray, ...], int]:
    """(leaves, rows) back from `to_words`' payload, each leaf read with
    the dtype and shape of the matching leaf of `like`."""
    off, host = 0, []
    for a in like:
        host.append(words[off:off + a.size].view(a.dtype).reshape(
            a.shape).copy())
        off += a.size
    return tuple(host), int(words[off:off + 2].view(np.int64)[0])


class TorchDcnTransport:
    """The collective DCN of a multi-process run over torch.distributed.

    `exchange` all-gathers every host's epoch leaves and row count in one
    collective: each process flattens its leaves' 32-bit words and the
    row count into one int32 CPU tensor, and gloo gathers them. Every
    process then merges the same contributions (SPMD). Partition and
    kill are the network's to inject, not ours: the simulated transport
    is where the fault ladder runs."""

    collective = True

    def __init__(self, group=None) -> None:
        import torch.distributed as dist
        if _world_size() <= 1:
            raise ValueError(
                "TorchDcnTransport needs a torch.distributed run with world "
                "size > 1 (init_distributed); use SimulatedDcnTransport")
        self._group = group
        self.n_hosts = dist.get_world_size(group)
        self.local_host = dist.get_rank(group)

    def exchange(self, leaves: Tuple[np.ndarray, ...], rows: int
                 ) -> Tuple[List[Tuple[np.ndarray, ...]], List[int]]:
        """All-gather (leaves, rows) from every host; returns per-host
        lists indexed by rank. Every leaf is 32 bits wide; each host's
        leaves come back with this host's leaf dtypes and shapes (the
        words carry no dtype), so a peer's int32 leaf reads as uint32
        where this host shipped an empty box: the caller views them with
        the dtypes it expects."""
        import torch.distributed as dist
        leaves = [np.asarray(a) for a in leaves]
        mine = torch.from_numpy(to_words(leaves, rows))
        gathered = [torch.empty_like(mine) for _ in range(self.n_hosts)]
        dist.all_gather(gathered, mine, group=self._group)
        per_host = [from_words(t.numpy(), leaves) for t in gathered]
        return [h for h, _ in per_host], [r for _, r in per_host]

    def quiet(self) -> bool:
        return True

    def counters(self) -> Dict[str, int]:
        return {"dcn_partitions": 0, "dcn_heals": 0,
                "dcn_held_messages": 0, "dcn_links_down": 0}

    def close(self) -> None:
        pass


def select_transport(kind: str = "auto", n_hosts: int = 2, *,
                     heal_after_s: Optional[float] = None):
    """'torch' = the collective transport (needs init_distributed with
    world size > 1), 'sim' = the in-process simulated DCN, 'auto' = torch
    when a process group with world size > 1 is up, sim otherwise."""
    if kind not in ("auto", "sim", "torch"):
        raise ValueError(f"transport must be auto|sim|torch, got {kind!r}")
    if kind == "torch" or (kind == "auto" and _world_size() > 1):
        return TorchDcnTransport()
    return SimulatedDcnTransport(n_hosts, heal_after_s=heal_after_s)


# ---------------------------------------------------------------------------
# HostPodCoordinator
# ---------------------------------------------------------------------------

class _HostLane:
    """One HOST fault domain: a whole PodFlowSuite, its DCN agent, and
    its slice of the pod-wide conservation ledger.

    The `base_*` fields fold in dead incarnations' final pod ledgers at
    rejoin (the lane pod is rebuilt from scratch), and `gen` bumps per
    incarnation: it rides every contribution as the leader's dedup
    key."""

    __slots__ = ("idx", "pod", "status", "gen", "outbox", "del_seen",
                 "last_local", "marker_rows", "base_sent",
                 "base_delivered", "base_host", "base_lost", "gmerged",
                 "glost", "drop_rows", "rejoin_lost", "stop_ev",
                 "handle", "close_lock")

    def __init__(self, idx: int, pod: PodFlowSuite) -> None:
        self.idx = idx
        self.pod = pod
        self.status = ACTIVE
        self.gen = 0
        self.outbox: List[_DcnMessage] = []   # closed, not yet shipped
        self.del_seen = 0          # lane pod delivered at last local close
        self.last_local: Optional[EpochResult] = None
        self.marker_rows = 0       # epoch membership at marker send
        self.base_sent = 0
        self.base_delivered = 0
        self.base_host = 0
        self.base_lost = 0
        self.gmerged = 0           # rows globally merged (pod-wide delivered)
        self.glost = 0             # taken-for-merge rows the merge lost
        self.drop_rows = 0         # routed to a LOST host: sent AND lost
        self.rejoin_lost = 0       # dead incarnations' unrecoverable pending
        self.stop_ev: Optional[threading.Event] = None
        self.handle: Optional[ThreadHandle] = None
        self.close_lock = threading.Lock()   # serializes local closes


class HostPodCoordinator:
    """The cross-host pod: N host lanes, each a full `PodFlowSuite`,
    coordinated into pod-wide merge epochs over a DCN transport.

    `put_lanes(plane, n)` routes each row to a host by the flow hash.
    `close_epoch()` broadcasts the epoch marker to every live host, waits
    up to `dcn_marker_deadline_s` for their contributions, merges what
    arrived, and counts the rest: a host past the deadline is EXCLUDED
    (`pod_hosts_missed`, `pod_host_rows_excluded`) and its contribution
    merges LATE next epoch (`pod_host_late_merges`), tagged lossy.
    `device` is the lane pods' device type ("cuda" or "cpu")."""

    def __init__(self, cfg: FlowSuiteConfig,
                 n_hosts: int = 2,
                 shards_per_host: Optional[int] = None, *,
                 transport: Any = "auto",
                 dcn_marker_deadline_s: float = 5.0,
                 merge_deadline_s: float = 5.0,
                 epoch_s: Optional[float] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_batches: int = 8,
                 queue_batches: int = 64,
                 auto_rejoin: bool = True,
                 name: str = "hostpod",
                 device="cuda") -> None:
        if n_hosts < 2:
            raise ValueError("a cross-host pod needs at least 2 hosts")
        self.cfg = cfg
        self.n_hosts = int(n_hosts)
        self.dcn_marker_deadline_s = float(dcn_marker_deadline_s)
        self.merge_deadline_s = float(merge_deadline_s)
        self.auto_rejoin = bool(auto_rejoin)
        self.name = name
        self._device = device
        self._snapshot_dir = snapshot_dir
        self._snapshot_batches = int(snapshot_batches)
        self._queue_batches = int(queue_batches)
        # each lane runs shards_per_host shards (default: one per visible
        # device); the HOST ladder is what this layer adds
        self.shards_per_host = shards_per_host
        self.transport = transport if not isinstance(transport, str) \
            else select_transport(transport, n_hosts)
        self.bus = SnapshotBus(snapshot_dir, name=name)
        last = self.bus.latest_step()
        self._epoch = 0 if last is None else last + 1
        self._lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._lanes = [_HostLane(i, self._make_lane_pod(i, 0))
                       for i in range(self.n_hosts)]
        # the merge device (the first lane's) and its own stream
        self.device = self._lanes[0].pod.device
        self._merge_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # leader dedup: (host, gen, local_epoch) -> global epoch merged,
        # pruned once old enough that no rejoin can re-ship it
        self._merged_keys: Dict[Tuple[int, int, int], int] = {}
        self._lossy_epoch = False
        self._hosts_missed = 0
        self._host_rows_excluded = 0
        self._host_late_merges = 0
        self._host_rejoins = 0
        self._hosts_killed = 0
        self._dup_contribs = 0
        self._markers_sent = 0
        self._markers_lost = 0
        self._marker_errors = 0
        self._epochs = 0
        self._merges = 0
        self._last_merge_s = 0.0
        # (shape, reference dtype) of each FlowSuiteState leaf
        self._leaf_specs = self._lanes[0].pod._leaf_specs
        self._faults = default_faults()
        self._closed = False
        self._epoch_handle: Optional[ThreadHandle] = None
        self._epoch_stop = threading.Event()
        if not getattr(self.transport, "collective", False):
            for ln in self._lanes:
                self._spawn_agent(ln)
        if epoch_s is not None:
            period = float(epoch_s)
            self._epoch_handle = default_supervisor().spawn(
                f"{name}-epochs", lambda: self._epoch_timer(period),
                beat_period_s=period)

    # -- construction helpers -----------------------------------------------
    def _make_lane_pod(self, idx: int, gen: int) -> PodFlowSuite:
        return PodFlowSuite(
            self.cfg, n_shards=self.shards_per_host, wire="lanes",
            merge_deadline_s=self.merge_deadline_s,
            snapshot_dir=self._snapshot_dir,
            snapshot_batches=self._snapshot_batches,
            queue_batches=self._queue_batches, auto_rejoin=True,
            name=f"{self.name}-host{idx}g{gen}", device=self._device)

    def _spawn_agent(self, ln: _HostLane) -> None:
        # each spawn gets its OWN stop event (the pod worker idiom)
        ev = threading.Event()
        ln.stop_ev = ev
        ln.handle = default_supervisor().spawn(
            f"{self.name}-agent{ln.idx}",
            lambda: self._agent_loop(ln, ev), beat_period_s=0.05)

    def _epoch_timer(self, period_s: float) -> None:
        while not self._epoch_stop.wait(period_s):
            default_supervisor().beat()
            try:
                self.close_epoch()
            except Exception:
                _LOG.exception("%s timed epoch close failed", self.name)

    @property
    def n_shards(self) -> int:
        return sum(ln.pod.n_shards for ln in self._lanes)

    @property
    def epoch(self) -> int:
        return self._epoch

    # -- ingest ------------------------------------------------------------
    def put_lanes(self, plane: np.ndarray, n: int) -> None:
        """Route one (4, B) packed-lane plane with n valid rows across
        hosts by the flow hash. Each host's slice re-packs into a fresh
        host-local plane padded to that lane's shard width. A LOST host's
        slice drops COUNTED (`pod_rows_lost`, lossy epoch): ingest never
        blocks on a dead host."""
        n = int(n)
        if n <= 0:
            return
        key = route_hosts(plane, n, self.n_hosts)
        for ln in self._lanes:
            sel = np.nonzero(key == np.uint32(ln.idx))[0]
            ni = int(sel.size)
            if ni == 0:
                continue
            with self._lock:
                dead = ln.status != ACTIVE
                if dead:
                    ln.drop_rows += ni
                    self._lossy_epoch = True
            if dead:
                continue
            ns = ln.pod.n_shards
            width = max(ns, -(-ni // ns) * ns)
            sub = np.zeros((plane.shape[0], width), dtype=plane.dtype)
            sub[:, :ni] = plane[:, sel]
            ln.pod.put_lanes(sub, ni)

    # -- host agent --------------------------------------------------------
    def _agent_loop(self, ln: _HostLane, stop_ev: threading.Event) -> None:
        while not stop_ev.is_set():
            default_supervisor().beat()
            marker = self.transport.recv_marker(ln.idx, timeout=0.05)
            if marker is None:
                continue
            if self._faults.enabled and self._faults.should_fire(
                    FAULT_HOST_LOST, f"host{ln.idx}"):
                # the host dies holding the marker: no contribution, no
                # heartbeat; the leader's deadline excludes it and the
                # epoch boundary rejoins it from its snapshot bus
                self.kill_host(ln.idx)
                return
            self._pump_host(ln, marker)

    def _pump_host(self, ln: _HostLane, marker: Dict[str, Any]) -> None:
        """One marker taken off the host's link: contribute for the epoch
        it names."""
        try:
            self._host_contribute(ln.idx, int(marker["epoch"]))
        except Exception:
            # counted: the host stays un-responded for this epoch and the
            # leader's deadline excludes it
            with self._lock:
                self._marker_errors += 1
            _LOG.exception("%s host %d contribution failed", self.name,
                           ln.idx)

    def _host_contribute(self, idx: int, ep: int) -> None:
        """Close the host's LOCAL epoch, ship every outbox entry
        leader-ward (oldest first), then a participation heartbeat.
        Entries stay in the outbox until the transport takes them: a kill
        mid-ship re-ships at rejoin, and the leader dedups."""
        ln = self._lanes[idx]
        if ln.status != ACTIVE:
            return
        self._local_close(ln)
        while True:
            with self._lock:
                if not ln.outbox or ln.status != ACTIVE:
                    break
                c = ln.outbox[0]
            msg = c._replace(global_epoch=ep,
                             late=c.late or c.global_epoch < ep)
            self.transport.send_contribution(idx, msg)
            with self._lock:
                if ln.outbox and ln.outbox[0] is c:
                    ln.outbox.pop(0)
        self.transport.send_contribution(idx, _DcnMessage(
            host=idx, gen=ln.gen, local_epoch=-1, global_epoch=ep,
            rows=0, leaves=None))

    def _local_close(self, ln: _HostLane) -> int:
        """Close one local pod epoch and capture its merged bus snapshot
        into the outbox; returns the rows captured. The bus leaves ARE
        the contribution (host numpy, what a rejoin restores)."""
        with ln.close_lock:
            ln.last_local = ln.pod.close_epoch(now=time.time())
            pc = ln.pod.counters()
            rows = pc["pod_rows_delivered"] - ln.del_seen
            if rows <= 0:
                return 0
            snap = ln.pod.bus.latest()
            if snap is None:
                # delivered rows with no published snapshot: counted lost
                # rather than stranded pending
                with self._lock:
                    ln.glost += rows
                    ln.del_seen = pc["pod_rows_delivered"]
                    self._lossy_epoch = True
                return 0
            msg = _DcnMessage(host=ln.idx, gen=ln.gen,
                              local_epoch=int(snap.step),
                              global_epoch=self._epoch, rows=rows,
                              leaves=tuple(snap.leaves))
            with self._lock:
                ln.del_seen = pc["pod_rows_delivered"]
                ln.outbox.append(msg)
            return rows

    def snapshot_host(self, idx: int) -> int:
        """Force one local epoch close on a host mid-global-epoch: its
        accumulation lands on the host's bus AND the outbox, so a kill
        right after loses none of it."""
        ln = self._lanes[idx]
        if ln.status != ACTIVE:
            return 0
        return self._local_close(ln)

    # -- leader ------------------------------------------------------------
    def close_epoch(self, now: Optional[float] = None,
                    deadline_s: Optional[float] = None) -> EpochResult:
        """Broadcast the epoch marker over the DCN, collect host
        contributions up to the marker deadline, merge, count the rest.
        LOST hosts rejoin at this boundary when auto_rejoin is on."""
        with self._close_lock:
            if getattr(self.transport, "collective", False):
                return self._close_epoch_collective(now)
            return self._close_epoch_serialized(now, deadline_s)

    def _close_epoch_serialized(self, now: Optional[float],
                                deadline_s: Optional[float]) -> EpochResult:
        t0 = time.perf_counter()
        ep = self._epoch
        with self._lock:
            live = [ln for ln in self._lanes if ln.status == ACTIVE]
            lost_now = [ln.idx for ln in self._lanes if ln.status == LOST]
            lossy0 = self._lossy_epoch
        idle = (not lossy0 and not lost_now
                and len(live) == self.n_hosts
                and self.transport.quiet()
                and all(not ln.outbox and ln.pod.pending_rows() == 0
                        for ln in live))
        if idle:
            return EpochResult(ep, None, {}, [], [], [], [], 0, [], False)
        for ln in live:
            with self._lock:
                ln.marker_rows = (ln.pod.pending_rows()
                                  + sum(c.rows for c in ln.outbox))
                self._markers_sent += 1
            if not self.transport.send_marker(ln.idx,
                                              {"epoch": ep, "host": ln.idx}):
                with self._lock:
                    self._markers_lost += 1
                    self._lossy_epoch = True
        deadline = time.monotonic() + (self.dcn_marker_deadline_s
                                       if deadline_s is None
                                       else float(deadline_s))
        want = {ln.idx for ln in live}
        arrived: List[_DcnMessage] = []
        while time.monotonic() < deadline:
            arrived.extend(self.transport.recv_contributions())
            if want <= {m.host for m in arrived if m.global_epoch == ep}:
                break
            time.sleep(0.002)
        arrived.extend(self.transport.recv_contributions())
        res = self._merge_global(ep, arrived, live, lost_now, now, t0)
        self._epoch = ep + 1
        if self.auto_rejoin:
            for i in lost_now:
                self.rejoin_host(i)
        tr = default_tracer()
        if tr.enabled:
            tr.gauge("pod_hosts_active",
                     float(sum(1 for ln in self._lanes
                               if ln.status == ACTIVE)))
            tr.gauge("pod_hosts_missed", float(self._hosts_missed))
            tr.gauge("pod_merge_epoch_s", self._last_merge_s)
        return res

    def _merge_global(self, ep: int, arrived: List[_DcnMessage],
                      live: List[_HostLane], lost_now: List[int],
                      now: Optional[float], t0: float) -> EpochResult:
        """Merge the epoch's host contributions and settle the pod-wide
        ledger: dedup'd re-ships skipped, missed live hosts excluded (not
        awaited), prior-epoch arrivals merged LATE, a merge crash counting
        its taken rows LOST before it surfaces."""
        with self._lock:
            lossy = self._lossy_epoch
            self._lossy_epoch = False
            take: List[_DcnMessage] = []
            for m in arrived:
                if m.leaves is None or m.rows <= 0:
                    continue
                if (m.host, m.gen, m.local_epoch) in self._merged_keys:
                    self._dup_contribs += 1
                    continue
                take.append(m)
            responded = {m.host for m in arrived if m.global_epoch == ep}
            missed = sorted(ln.idx for ln in live
                            if ln.idx not in responded)
            for i in missed:
                self._hosts_missed += 1
                self._host_rows_excluded += self._lanes[i].marker_rows
            late = [m for m in take if m.global_epoch < ep or m.late]
            lossy = lossy or bool(missed) or bool(late) or bool(lost_now)
        out = None
        rows = 0
        merged_state = None
        if take:
            try:
                out, rows, merged_state = merge_leaves(
                    [m.leaves for m in take], self.cfg, self.device,
                    self._merge_stream)
            except Exception:
                # the cross-host merge died: the taken contributions cannot
                # deliver; count them LOST (and dedup them, so a rejoin
                # re-ship cannot resurrect them) before surfacing
                with self._lock:
                    for m in take:
                        self._lanes[m.host].glost += m.rows
                        self._merged_keys[(m.host, m.gen, m.local_epoch)] = ep
                    self._lossy_epoch = True
                raise
        participated = sorted({m.host for m in take}
                              | {i for i in responded
                                 if self._lanes[i].status == ACTIVE})
        tags = self._epoch_tags(ep, participated, missed, lost_now, lossy,
                                rows, live)
        if merged_state is not None:
            self._publish(merged_state, ep, now, rows, tags)
        with self._lock:
            for m in take:
                self._lanes[m.host].gmerged += m.rows
                self._merged_keys[(m.host, m.gen, m.local_epoch)] = ep
                if m.global_epoch < ep or m.late:
                    self._host_late_merges += 1
            if take:
                self._merges += 1
            self._epochs += 1
            self._last_merge_s = time.perf_counter() - t0
            # prune dedup keys no rejoin can re-ship any more
            if len(self._merged_keys) > 4096:
                self._merged_keys = {k: e for k, e in
                                     self._merged_keys.items()
                                     if ep - e < 64}
        return EpochResult(ep, out, tags, participated, missed, [],
                           lost_now, rows, [], lossy)

    def _publish(self, merged_state, ep: int, now: Optional[float],
                 rows: int, tags: dict) -> None:
        # subscribers get every merge; the fsynced file only with rows
        with _stream_ctx(self._merge_stream):
            self.bus.publish(merged_state, step=ep, wall_time=now,
                             to_disk=rows > 0, tags=tags)

    def _epoch_tags(self, ep: int, participated: List[int],
                    missed: List[int], lost: List[int], lossy: bool,
                    rows: int, live: List[_HostLane]) -> dict:
        # host-level participation beside the aggregated shard-level tags
        # the single-host pod publishes: readers see both ladders
        missing = sorted(set(missed) | set(lost))
        shard_part = sum(len(ln.last_local.participated) for ln in live
                         if ln.idx in participated
                         and ln.last_local is not None)
        return {"epoch": ep,
                "pod_hosts": self.n_hosts,
                "pod_hosts_participated": len(participated),
                "pod_hosts_missing": missing,
                "pod_shards": self.n_shards,
                "pod_shards_participated": shard_part,
                "pod_participated": participated,
                "pod_missing": missing,
                "pod_degraded": [],
                "lossy": bool(lossy), "rows": rows}

    def _close_epoch_collective(self, now: Optional[float]) -> EpochResult:
        """Collective epoch close: every process closes its LOCAL host
        lane, all-gathers (leaves, rows), and computes the identical
        merge.

        As in the reference: an outbox of more than one entry (a
        `snapshot_host` of the local host before this close) is summed
        leaf by leaf, seeds, HLL registers and ring included, wrapping to
        the leaf's 32 bits; an empty box ships uint32 zeros whatever the
        leaf's dtype (never merged: its host's row count is 0). Every
        merged leaf is read with the reference's dtype, whatever dtype
        the transport decoded it with."""
        t0 = time.perf_counter()
        ep = self._epoch
        ln = self._lanes[self.transport.local_host % self.n_hosts]
        self._local_close(ln)
        with self._lock:
            box, ln.outbox = ln.outbox, []
        rows_local = sum(m.rows for m in box)
        if box:
            leaves = [np.stack([m.leaves[j] for m in box]).sum(axis=0)
                      .astype(box[0].leaves[j].dtype)
                      if len(box) > 1 else np.asarray(box[0].leaves[j])
                      for j in range(len(self._leaf_specs))]
        else:
            leaves = [np.zeros(s, np.uint32) for s, _ in self._leaf_specs]
        per_host_leaves, per_host_rows = self.transport.exchange(
            tuple(leaves), rows_local)
        take = [h for h, r in enumerate(per_host_rows) if r > 0]
        out = None
        rows = 0
        if take:
            # a wire of 32-bit words decodes a peer's leaves with this
            # process's dtypes, which are uint32 where its own box was
            # empty: read every leaf with the reference's dtype
            out, rows, merged_state = merge_leaves(
                [tuple(np.asarray(a).view(dt).reshape(s) for a, (s, dt)
                       in zip(per_host_leaves[h], self._leaf_specs))
                 for h in take], self.cfg, self.device, self._merge_stream)
            with self._lock:
                ln.gmerged += rows_local
            tags = self._epoch_tags(ep, take, [], [], False, rows, [ln])
            self._publish(merged_state, ep, now, rows, tags)
        else:
            tags = {}
        with self._lock:
            self._epochs += 1
            if take:
                self._merges += 1
            self._last_merge_s = time.perf_counter() - t0
        self._epoch = ep + 1
        return EpochResult(ep, out, tags, take, [], [], [], rows, [], False)

    # -- kill / rejoin -------------------------------------------------------
    def kill_host(self, idx: int) -> None:
        """Lose a whole host: its lane pod freezes (workers stopped, no
        final merge), its DCN agent exits, and everything in its pipeline
        past the last local close stays in the dead pod's ledger until
        `rejoin_host` settles it."""
        ln = self._lanes[idx]
        with self._lock:
            if ln.status != ACTIVE:
                return
            ln.status = LOST
            self._hosts_killed += 1
            self._lossy_epoch = True
        if ln.stop_ev is not None:
            ln.stop_ev.set()
        if ln.handle is not None:
            ln.handle.stop()
        ln.pod.close(final_epoch=False)
        _LOG.warning("%s host %d LOST (outbox=%d entries held for rejoin)",
                     self.name, idx, len(ln.outbox))

    def rejoin_host(self, idx: int) -> bool:
        """Rejoin-by-snapshot at an epoch boundary: the dead incarnation's
        final ledger folds into the lane's base counters (its un-closed
        pipeline counted LOST), its unshipped outbox re-ships LATE so
        those rows DELIVER, and a fresh PodFlowSuite incarnation (gen+1)
        takes over ingest."""
        ln = self._lanes[idx]
        with self._lock:
            if ln.status != LOST:
                return False
            box, ln.outbox = ln.outbox, []
        if ln.handle is not None and ln.handle.thread is not \
                threading.current_thread():
            ln.handle.join(timeout=2.0)
        fin = ln.pod.counters()
        with self._lock:
            ln.base_sent += fin["pod_rows_sent"]
            ln.base_delivered += fin["pod_rows_delivered"]
            ln.base_host += fin["pod_rows_host"]
            ln.base_lost += fin["pod_rows_lost"]
            ln.rejoin_lost += fin["pod_rows_pending"]
            ln.gen += 1
            ln.del_seen = 0
            self._host_rejoins += 1
        recovered = 0
        for m in box:
            self.transport.send_contribution(idx, m._replace(late=True))
            recovered += m.rows
        ln.pod = self._make_lane_pod(idx, ln.gen)
        ln.last_local = None
        with self._lock:
            ln.status = ACTIVE
        if not getattr(self.transport, "collective", False):
            self._spawn_agent(ln)
        _LOG.warning("%s host %d rejoined gen %d (%d rows re-shipped from "
                     "its snapshots, %d counted lost)", self.name, idx,
                     ln.gen, recovered, fin["pod_rows_pending"])
        return True

    # -- lifecycle / observability -----------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(ln.status != ACTIVE or ln.pod.drain(timeout=0.1)
                   for ln in self._lanes):
                return True
            time.sleep(0.005)
        return False

    def close(self, final_epoch: bool = True) -> Optional[EpochResult]:
        """Final pod-wide merge (one extra epoch when stragglers or
        held-back traffic remain), then stop agents and lane pods."""
        self._epoch_stop.set()
        if self._epoch_handle is not None:
            self._epoch_handle.stop()
            self._epoch_handle.join(timeout=2.0)
        res = None
        try:
            if final_epoch and not self._closed:
                self.drain(timeout=10.0)
                res = self.close_epoch()
                if not self.transport.quiet() \
                        or any(ln.outbox for ln in self._lanes):
                    time.sleep(0.01)
                    res = self.close_epoch()
        finally:
            self._closed = True
            for ln in self._lanes:
                if ln.stop_ev is not None:
                    ln.stop_ev.set()
                if ln.handle is not None:
                    ln.handle.stop()
            self.transport.close()
            for ln in self._lanes:
                if ln.handle is not None and ln.handle.thread is not \
                        threading.current_thread():
                    ln.handle.join(timeout=2.0)
            for ln in self._lanes:
                ln.pod.close(final_epoch=False)
        return res

    def pending_rows(self) -> int:
        with self._lock:
            return sum(self._lane_pending(ln, ln.pod.counters())
                       for ln in self._lanes)

    @staticmethod
    def _lane_pending(ln: _HostLane, pc: dict) -> int:
        # delivered by the lane pod but not yet merged (nor lost) pod-wide
        residual = (ln.base_delivered + pc["pod_rows_delivered"]
                    - ln.gmerged - ln.glost)
        return pc["pod_rows_pending"] + max(0, residual)

    def host_status(self) -> List[dict]:
        with self._lock:
            return [{"host": ln.idx, "status": ln.status,
                     "gen": ln.gen, "rows_merged": ln.gmerged,
                     "rows_dropped": ln.drop_rows,
                     "rows_lost_rejoin": ln.rejoin_lost,
                     "outbox": len(ln.outbox),
                     "link_up": (self.transport.link_up(ln.idx)
                                 if hasattr(self.transport, "link_up")
                                 else True)}
                    for ln in self._lanes]

    def shard_status(self) -> List[dict]:
        out = []
        base = 0
        for ln in self._lanes:
            for s in ln.pod.shard_status():
                row = dict(s)
                row["shard"] = base + int(s["shard"])
                row["host"] = ln.idx
                if ln.status == LOST:
                    row["status"] = LOST
                out.append(row)
            base += ln.pod.n_shards
        return out

    def counters(self) -> dict:
        """The pod-WIDE ledger in one consistent snapshot: every term of
        the conservation equality reads under one lock, and each lane
        pod's counters() is itself one locked snapshot."""
        with self._lock:
            sent = delivered = host = lost = pending = shed = 0
            for ln in self._lanes:
                pc = ln.pod.counters()
                sent += ln.base_sent + pc["pod_rows_sent"] + ln.drop_rows
                delivered += ln.gmerged
                host += ln.base_host + pc["pod_rows_host"]
                lost += (ln.base_lost + pc["pod_rows_lost"] + ln.drop_rows
                         + ln.rejoin_lost + ln.glost)
                shed += pc["pod_rows_shed"]
                pending += self._lane_pending(ln, pc)
            active = sum(1 for ln in self._lanes if ln.status == ACTIVE)
            c = {"pod_hosts": self.n_hosts,
                 "pod_hosts_active": active,
                 "pod_hosts_lost": self.n_hosts - active,
                 "pod_hosts_killed": self._hosts_killed,
                 "pod_hosts_missed": self._hosts_missed,
                 "pod_host_rows_excluded": self._host_rows_excluded,
                 "pod_host_late_merges": self._host_late_merges,
                 "pod_host_rejoins": self._host_rejoins,
                 "pod_dup_contributions": self._dup_contribs,
                 "pod_shards": self.n_shards,
                 "pod_epochs": self._epochs,
                 "pod_merges": self._merges,
                 "pod_merge_epoch_s": round(self._last_merge_s, 6),
                 "pod_rows_sent": sent,
                 "pod_rows_delivered": delivered,
                 "pod_rows_host": host,
                 "pod_rows_lost": lost,
                 "pod_rows_shed": shed,
                 "pod_rows_pending": pending,
                 "dcn_markers_sent": self._markers_sent,
                 "dcn_markers_lost": self._markers_lost,
                 "pod_marker_errors": self._marker_errors}
            c.update(self.transport.counters())
        return c
