"""Zero-copy decode->staging: decoded columns land straight in the
staging buffer that crosses to the device.

`LaneStager` packs decoded chunk columns directly into recycled
coalesced staging buffers in the slot layout that
`flow_suite.make_coalesced_update` consumes ([n_k | plane_k] per slot):
a buffer of k complete slots is itself a valid k-batch transfer, so a
window flush ships the open prefix without a repack. `DictWireStager`
cuts the dict wire at `capacity` rows, runs one packer pack()+flush() per
cut (the inline path's partition, so state stays bit-identical) and
stages each group's news/hits word sequence (`flow_dict.stage_wire`
layout). The words are identical to the JAX package's stagers'.

Buffers on a CUDA exporter are PINNED (`alloc_words(..., pinned=True)`):
numpy views of page-locked memory, so the copy to the device is a true
asynchronous DMA on the exporter's copy stream. The copy reads the
buffer after the host has moved on, so a buffer is recycled only once
the fence of the program that consumed it has retired: the dispatcher
sets `group.fence`, and `recycle()` refuses (counts and drops) a buffer
whose fence the device has not passed. Pinned allocation is slow, so the
free lists are kept, bounded and size-keyed.

`PackPool` shards the pack work across supervised worker threads by
flow hash. The producer pre-assigns every destination in arrival order,
so worker timing cannot reorder a byte: the staged words equal the
single-threaded pack. A failed pack poisons its group
(`StagingPackError` from `wait_ready`), which crashes the feed thread
into the supervisor: the group's rows are counted lost and the device
state restored. The pool workers themselves never die on a bad chunk.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.utils.u32 import fold_columns_np

__all__ = ["DictWireStager", "LaneStager", "PackPool", "StagedGroup",
           "StagedWireGroup", "StagingPackError", "WordPool", "alloc_words"]

_PACK_COLS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
              "packet_tx", "packet_rx")


def alloc_words(words: int, pinned: bool) -> np.ndarray:
    """An uninitialized uint32 staging buffer; with `pinned`, a numpy
    view of page-locked host memory (the view keeps the tensor alive)."""
    if not pinned:
        return np.empty(words, np.uint32)
    return torch.empty(words, dtype=torch.int32,
                       pin_memory=True).numpy().view(np.uint32)


class WordPool:
    """Size-keyed free lists of flat uint32 staging buffers (pinned on a
    card): at most `cap` buffers per size, and new sizes kept only while
    at most `MAX_SIZES` are held. Power-of-two plane widths keep the
    distinct sizes few. Callers serialize get/put."""

    MAX_SIZES = 16

    def __init__(self, cap: int, pinned: bool) -> None:
        self.cap = max(1, int(cap))
        self.pinned = bool(pinned)
        self.free: Dict[int, list] = {}
        self.hits = 0

    def get(self, words: int) -> np.ndarray:
        """A free buffer of `words`, else a new one."""
        try:
            flat = self.free[words].pop()
        except (KeyError, IndexError):
            return alloc_words(words, self.pinned)
        self.hits += 1
        return flat

    def put(self, flat: np.ndarray) -> None:
        """Return a buffer whose last reader is done."""
        free = self.free.setdefault(flat.size, [])
        if len(free) < self.cap and len(self.free) <= self.MAX_SIZES:
            free.append(flat)

    def buffers(self) -> list:
        """Every free buffer, of every size."""
        return [b for bufs in self.free.values() for b in bufs]


def fence_retired(fence) -> bool:
    """True when a buffer's last reader is done: no fence (never sent
    to a device) or a fence event the device has passed."""
    if fence is None:
        return True
    try:
        return bool(fence.query())
    except RuntimeError:       # the device failed: never reuse the buffer
        return False


class StagingPackError(Exception):
    """A sharded pack task failed; the staged group is poisoned."""


class _GroupState:
    """Readiness countdown for one staging buffer: pre-assigned pack
    tasks check in as they complete; `wait` returns once all have."""

    __slots__ = ("_cond", "_pending", "error")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._pending = 0
        self.error: Optional[BaseException] = None

    def add(self, n: int = 1) -> None:
        with self._cond:
            self._pending += n

    def done(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            self._pending -= 1
            if error is not None and self.error is None:
                self.error = error
            if self._pending <= 0:
                self._cond.notify_all()

    def wait(self, timeout: Optional[float]) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._pending <= 0, timeout)


class StagedGroup:
    """k complete batch slots staged in one coalesced buffer: what the
    feed transfers and dispatches as a unit. `flat` is the prefix
    shipped, `buffer` the backing array recycled whole, `valid` the
    rows it carries (the feed's loss accounting reads it), `fence` the
    event of the program that consumed it (set by the dispatcher)."""

    __slots__ = ("flat", "buffer", "k", "capacity", "valid", "fence",
                 "_state")

    def __init__(self, flat: np.ndarray, buffer: np.ndarray, k: int,
                 capacity: int, valid: int, state: _GroupState) -> None:
        self.flat = flat
        self.buffer = buffer
        self.k = k
        self.capacity = capacity
        self.valid = valid
        self.fence = None
        self._state = state

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every sharded pack task of this group completed
        (a host barrier). Raises StagingPackError if a task failed or
        the timeout passed."""
        if not self._state.wait(timeout):
            raise StagingPackError(
                f"staged group ({self.k} batches) never became ready "
                f"within {timeout}s")
        if self._state.error is not None:
            raise StagingPackError(
                f"pack task failed: {self._state.error!r}") \
                from self._state.error


class PackPool:
    """Flow-hash-sharded pack workers (supervised, with deadman beats).
    One queue per worker: tasks of one shard stay FIFO on one thread;
    destinations are pre-assigned, so any interleaving lands the same
    bytes."""

    def __init__(self, n_workers: int, name: str = "stage-pack") -> None:
        self.n_workers = max(1, int(n_workers))
        # routing width: submit shards over the first `active` workers
        # (the autotuner's pack_workers knob moves it through resize)
        self.active = self.n_workers
        self.name = name
        self._queues: List[_queue.Queue] = [
            _queue.Queue(maxsize=256) for _ in range(self.n_workers)]
        self.tasks = 0
        self.task_errors = 0
        self._err_lock = threading.Lock()
        self._closed = False
        sup = default_supervisor()
        self._handles = [sup.spawn(f"{name}-{i}", self._make_worker(i))
                         for i in range(self.n_workers)]

    def _make_worker(self, i: int) -> Callable[[], None]:
        q = self._queues[i]

        def run() -> None:
            sup = default_supervisor()
            while True:
                try:
                    item = q.get(timeout=0.2)
                except _queue.Empty:
                    sup.beat()
                    if self._closed:
                        return
                    continue
                sup.beat()
                if item is None:
                    return
                fn, state = item
                # a bad chunk poisons ITS group, never the worker
                try:
                    fn()
                except BaseException as e:   # noqa: BLE001 -- contained
                    with self._err_lock:
                        self.task_errors += 1
                    state.done(e)
                else:
                    state.done()

        return run

    def submit(self, shard_key: int, fn: Callable[[], None],
               state: _GroupState) -> None:
        state.add()
        self.tasks += 1
        self._queues[shard_key % self.active].put((fn, state))

    def resize(self, n_workers: int) -> int:
        """Retarget the routing width (the autotuner's pack_workers
        knob). Growing past the spawned count spawns more supervised
        workers; shrinking only narrows `active` (idle workers keep
        beating). Tasks already queued finish where they are, and the
        destinations are pre-assigned, so any routing lands the same
        bytes. Returns the width applied."""
        n = max(1, int(n_workers))
        if self._closed:
            return self.active
        if n > self.n_workers:
            sup = default_supervisor()
            for i in range(self.n_workers, n):
                self._queues.append(_queue.Queue(maxsize=256))
                self._handles.append(
                    sup.spawn(f"{self.name}-{i}", self._make_worker(i)))
            self.n_workers = n
        self.active = n
        return n

    def close(self, timeout: float = 5.0) -> None:
        self._closed = True
        for q in self._queues:
            q.put(None)
        for h in self._handles:
            h.stop()
            h.join(timeout=timeout)

    def counters(self) -> dict:
        return {"pack_workers": self.active, "pack_tasks": self.tasks,
                "pack_task_errors": self.task_errors}


class LaneStager:
    """Decoded chunks straight into coalesced lane staging buffers
    (`group_batches` slots per buffer).

    Cuts exactly as Batcher does -- fill each slot to `capacity` rows,
    carry the remainder, pad and zero only the final partial slot at a
    flush -- so the batch partition (and the sketch state, ring phase
    included) is bit-identical to the TensorBatch path on the same
    stream."""

    def __init__(self, capacity: int, group_batches: int = 1,
                 pool: Optional[PackPool] = None, pool_cap: int = 4,
                 pinned: bool = False) -> None:
        self.capacity = int(capacity)
        self.group_batches = max(1, int(group_batches))
        self._pack_pool = pool
        self._pool_cap = max(1, int(pool_cap))
        self._pinned = bool(pinned)
        self._words = flow_suite.coalesced_lanes_words(
            self.group_batches, self.capacity)
        self._pending_group: Optional[int] = None
        self._free: list = []
        self._buf: Optional[np.ndarray] = None
        self._state: Optional[_GroupState] = None
        self._slot = 0          # complete slots in the current buffer
        self._fill = 0          # rows in the current (open) slot
        self._rows = 0          # valid rows staged in the current buffer
        self.total_rows = 0
        self.staged_groups = 0
        self.staged_batches = 0
        self.pool_hits = 0
        self.recycled = 0
        self.recycle_refused = 0

    # -- producer side (the exporter worker, serialized) ----------------------
    def put(self, cols: Dict[str, np.ndarray]) -> List[StagedGroup]:
        """Append one decoded chunk; returns zero or more complete
        groups. The chunk's arrays must stay unchanged until the groups'
        packs complete (decoded chunks are fresh per frame)."""
        n = len(next(iter(cols.values())))
        self.total_rows += n
        out: List[StagedGroup] = []
        off = 0
        while n - off > 0:
            self._ensure_buffer()
            take = min(self.capacity - self._fill, n - off)
            self._pack(cols, off, take)
            self._fill += take
            self._rows += take
            off += take
            if self._fill == self.capacity:
                self._close_slot(self.capacity)
                if self._slot == self.group_batches:
                    out.append(self._emit())
        return out

    def flush(self) -> List[StagedGroup]:
        """Emit the partial remainder as a prefix group (padded final
        slot, tail zeroed: the bytes the TensorBatch path stages)."""
        if self._buf is None or (self._slot == 0 and self._fill == 0):
            return []
        if self._fill > 0:
            plane = flow_suite.slot_plane(self._buf, self._slot,
                                          self.capacity)
            plane[:, self._fill:] = 0
            self._close_slot(self._fill)
        return [self._emit()]

    # -- consumer side (the feed thread) ------------------------------------
    def recycle(self, group: StagedGroup) -> None:
        """Return a group's backing buffer once its fence retired."""
        if group.buffer.size != self._words:
            return
        if not fence_retired(group.fence):
            self.recycle_refused += 1
            return
        self.recycled += 1
        if len(self._free) < self._pool_cap:
            self._free.append(group.buffer)

    def set_pool_cap(self, n: int) -> None:
        """Bound the free list at `n` buffers (the autotuner raises it
        with the feed's depth). A lower cap takes effect as buffers are
        taken; nothing is freed here."""
        self._pool_cap = max(1, int(n))

    def set_group_batches(self, n: int) -> None:
        """Retarget the coalesce width (the autotuner's coalesce_batches
        knob). It takes effect at the next group boundary: the open
        buffer keeps its layout, so no half-retuned group is emitted.
        The free list is dropped then (its buffers have the old size;
        `recycle` rejects them too), and buffers of the new size are
        allocated on this producer thread as groups need them."""
        self._pending_group = max(1, int(n))

    # -- internals ----------------------------------------------------------
    def _ensure_buffer(self) -> None:
        if self._buf is not None:
            return
        if self._pending_group is not None \
                and self._pending_group != self.group_batches:
            self.group_batches = self._pending_group
            self._words = flow_suite.coalesced_lanes_words(
                self.group_batches, self.capacity)
            self._free.clear()
        self._pending_group = None
        try:
            self._buf = self._free.pop()
            self.pool_hits += 1
        except IndexError:
            self._buf = alloc_words(self._words, self._pinned)
        self._state = _GroupState()
        self._slot = self._fill = self._rows = 0

    def _pack(self, cols: Dict[str, np.ndarray], off: int,
              take: int) -> None:
        """Pack cols[off:off+take] into the open slot at _fill: the one
        copy between decoded columns and the device transfer."""
        sub = {k: cols[k][off:off + take] for k in _PACK_COLS}
        plane = flow_suite.slot_plane(self._buf, self._slot, self.capacity)
        dest = plane[:, self._fill:self._fill + take]
        if self._pack_pool is None:
            flow_suite.pack_lanes_into(sub, dest)
            return
        # flow-hash shard of the sub-chunk's leading 5-tuple
        shard = int(fold_columns_np(
            [sub[c][:1] for c in ("ip_src", "ip_dst", "port_src",
                                  "port_dst", "proto")])[0])
        self._pack_pool.submit(
            shard, lambda s=sub, d=dest: flow_suite.pack_lanes_into(s, d),
            self._state)

    def _close_slot(self, valid: int) -> None:
        self._buf[self._slot * flow_suite.slot_words(self.capacity)] = valid
        self._slot += 1
        self._fill = 0
        self.staged_batches += 1

    def _emit(self) -> StagedGroup:
        k = self._slot
        flat = self._buf if k == self.group_batches else \
            self._buf[:flow_suite.coalesced_lanes_words(k, self.capacity)]
        group = StagedGroup(flat=flat, buffer=self._buf, k=k,
                            capacity=self.capacity, valid=self._rows,
                            state=self._state)
        self._buf = None
        self._state = None
        self._slot = self._fill = self._rows = 0
        self.staged_groups += 1
        return group

    def counters(self) -> dict:
        c = {"staged_groups": self.staged_groups,
             "staged_batches": self.staged_batches,
             "staged_rows": self.total_rows,
             "staging_pool_hits": self.pool_hits,
             "staging_recycled": self.recycled,
             "staging_recycle_refused": self.recycle_refused}
        if self._pack_pool is not None:
            c.update(self._pack_pool.counters())
        return c


class StagedWireGroup(StagedGroup):
    """A staged dict-wire group: one flat buffer holding an
    emission-ordered news/hits word sequence plus the signature that
    selects its `make_wire_update` program. `epoch` stamps the packer
    generation that emitted it: after a device-state restore swaps the
    packer (`DictWireStager.reset_packer`), a group of the old
    generation references indices the fresh device table never
    scattered, and the dispatcher drops it as counted loss."""

    __slots__ = ("sig", "epoch", "_wire_src")

    def __init__(self, flat: np.ndarray, sig, k: int, capacity: int,
                 valid: int, epoch: int, state: _GroupState) -> None:
        super().__init__(flat=flat, buffer=flat, k=k, capacity=capacity,
                         valid=valid, state=state)
        self.sig = sig
        self.epoch = epoch


class DictWireStager:
    """Dict-wire twin of LaneStager: decoded chunks -> recycled
    news/hits staging buffers.

    The packer is a stateful LRU whose news/hits split depends on every
    record before, so chunk slices cannot be packed independently: the
    stager accumulates the 7 sketch columns into a batch buffer, cut at
    exactly `capacity` rows, and runs ONE pack()+flush() per cut -- the
    inline path's partition, bit for bit (same pack boundaries, same
    planes, same batches_seen, same ring phase). Planes of
    `group_batches` consecutive cuts coalesce into one flat buffer (one
    device transfer), optionally copied by the PackPool.

    put/flush run on the exporter worker, serialized; recycle and
    reset_packer on the feed thread. `_lock` is a leaf lock guarding the
    packer and the open group's emitted wire, the only state both
    threads touch."""

    def __init__(self, capacity: int, packer_factory,
                 group_batches: int = 1,
                 pool: Optional[PackPool] = None, pool_cap: int = 4,
                 pinned: bool = False) -> None:
        self.capacity = int(capacity)
        self.group_batches = max(1, int(group_batches))
        self._packer_factory = packer_factory
        self._packer = packer_factory()
        self.epoch = 0
        self._lock = threading.Lock()
        self._pack_pool = pool
        # host key mirror of the device table, fed at stage time so the
        # degraded absorb can gather hit keys (flow_dict.mirror_news_np)
        self.mirror = np.zeros((4, self._packer.capacity), np.uint32)
        self._cols = {c: np.empty(self.capacity, np.uint32)
                      for c in _PACK_COLS}
        self._fill = 0           # rows in the open (unpacked) batch
        self._wire: list = []    # emitted planes of the open group
        self._batches = 0        # packed batches in the open group
        self._rows = 0           # valid rows packed into the open group
        self._free = WordPool(pool_cap, pinned)
        self._pending_group: Optional[int] = None
        self.total_rows = 0
        self.staged_groups = 0
        self.staged_batches = 0
        self.recycled = 0
        self.recycle_refused = 0
        self.epoch_drops = 0

    # -- producer side (the exporter worker, serialized) ----------------------
    def put(self, cols: Dict[str, np.ndarray]) -> List[StagedWireGroup]:
        """Append one decoded chunk; returns zero or more complete
        groups. The columns are copied at once, so the caller may reuse
        them when put() returns."""
        n = len(next(iter(cols.values())))
        self.total_rows += n
        out: List[StagedWireGroup] = []
        off = 0
        while n - off > 0:
            take = min(self.capacity - self._fill, n - off)
            for c in _PACK_COLS:
                np.copyto(self._cols[c][self._fill:self._fill + take],
                          cols[c][off:off + take], casting="unsafe")
            self._fill += take
            off += take
            if self._fill == self.capacity:
                g = self._cut_batch(self.capacity)
                if g is not None:
                    out.append(g)
        return out

    def flush(self) -> List[StagedWireGroup]:
        """Pack the partial remainder batch and emit whatever the open
        group holds (the window-boundary prefix)."""
        g = None
        if self._fill > 0:
            g = self._cut_batch(self._fill, force_emit=True)
        elif self._batches > 0 or self._wire:
            with self._lock:
                g = self._emit_locked()
        if g is None:
            return []
        self._stage(g)
        return [g]

    # -- consumer side (the feed thread) ------------------------------------
    def recycle(self, group: StagedWireGroup) -> None:
        """Return a group's flat buffer once its fence retired."""
        if not fence_retired(group.fence):
            self.recycle_refused += 1
            return
        self.recycled += 1
        self._free.put(group.flat)

    def reset_packer(self) -> int:
        """Device-state restore: a fresh packer generation (the fresh
        device table knows no index, so every flow re-announces as
        news). The open group's packed planes belong to the dead
        generation and are dropped; returns their rows for the caller
        to count. The open unpacked batch survives and packs under the
        new generation."""
        with self._lock:
            self._packer = self._packer_factory()
            self.epoch += 1
            self.mirror[:] = 0
            dropped = self._rows
            self._wire = []
            self._batches = 0
            self._rows = 0
            return dropped

    def set_pool_cap(self, n: int) -> None:
        """Bound each size's free list at `n` buffers, as in LaneStager."""
        self._free.cap = max(1, int(n))

    @property
    def _pool_cap(self) -> int:
        return self._free.cap

    @property
    def pool_hits(self) -> int:
        return self._free.hits

    def set_group_batches(self, n: int) -> None:
        """Retarget the coalesce width; it takes effect when the next
        group opens, as in LaneStager. The free lists are size-keyed, so
        buffers stay reusable whenever a size repeats."""
        self._pending_group = max(1, int(n))

    # -- internals ----------------------------------------------------------
    def _cut_batch(self, n: int,
                   force_emit: bool = False) -> Optional[StagedWireGroup]:
        batch = {c: self._cols[c][:n] for c in _PACK_COLS}
        g = None
        with self._lock:
            if self._batches == 0 and self._pending_group is not None:
                self.group_batches = self._pending_group
                self._pending_group = None
            # the inline sequence verbatim: one pack + one hit drain per
            # cut (the drain pins the partition to the inline path's)
            wire = self._packer.pack(batch)
            wire += self._packer.flush()
            self._fill = 0
            self._wire.extend(wire)
            self._batches += 1
            self._rows += n
            self.staged_batches += 1
            if force_emit or self._batches >= self.group_batches:
                g = self._emit_locked()
        if g is not None and not force_emit:
            self._stage(g)
        return g

    def _emit_locked(self) -> Optional[StagedWireGroup]:
        """Swap the open group out under the lock; its bytes are staged
        outside it (the wire list is local after the swap)."""
        wire, self._wire = self._wire, []
        k, self._batches = self._batches, 0
        rows, self._rows = self._rows, 0
        if not wire:
            return None
        g = StagedWireGroup(
            flat=np.empty(0, np.uint32), sig=flow_dict.wire_signature(wire),
            k=k, capacity=self.capacity, valid=rows, epoch=self.epoch,
            state=_GroupState())
        g._wire_src = wire
        return g

    def _stage(self, g: StagedWireGroup) -> None:
        wire = g._wire_src
        del g._wire_src
        flat = self._free.get(flow_dict.wire_words(g.sig))
        g.flat = g.buffer = flat
        flow_dict.mirror_news_np(wire, self.mirror)
        if self._pack_pool is None:
            flow_dict.stage_wire(wire, flat)
            self.staged_groups += 1
            return
        # header words here, plane copies sharded by plane index
        # (disjoint, pre-assigned destinations)
        off = len(wire)
        for i, (_, plane, nv) in enumerate(wire):
            flat[i] = nv
            dest = flat[off:off + plane.size]
            self._pack_pool.submit(
                i, lambda p=plane, d=dest: np.copyto(d, p.reshape(-1)),
                g._state)
            off += plane.size
        self.staged_groups += 1

    def counters(self) -> dict:
        c = {"staged_groups": self.staged_groups,
             "staged_batches": self.staged_batches,
             "staged_rows": self.total_rows,
             "staging_pool_hits": self.pool_hits,
             "staging_recycled": self.recycled,
             "staging_recycle_refused": self.recycle_refused,
             "dict_epoch": self.epoch,
             "dict_epoch_drops": self.epoch_drops}
        if self._pack_pool is not None:
            c.update(self._pack_pool.counters())
        return c
