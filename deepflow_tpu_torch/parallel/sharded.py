"""Sharded suites: batch-sharded updates, window merges at flush.

One process drives every shard of a `Mesh` axis that it holds
(parallel/mesh.py). A suite's state is a list with one state per local
shard, shard d on `devices[d]`, each with storage of its own (the
updates add in place, so a shared tensor would corrupt every shard that
holds it). A batch of B rows splits into n contiguous blocks, shard d
taking rows [d*B/n, (d+1)*B/n); B % n == 0 is required, as in JAX.
Updates touch only their shard. Where JAX's `shard_map` programs `psum`,
the port reduces onto the first local shard's device in shard order and
copies the result back to every shard.

A mesh may span processes (`multihost.make_global_mesh`). Each process
then holds a contiguous block of the global shards (the same count in
every process), is fed only its own rows of each global batch (every
`put_*` and `multihost.process_local_batch` take this process's rows),
and every cross-shard step reduces this process's shards first and then
runs one `torch.distributed` collective over the default process group,
so every process gets the same merged result: sums by all-reduce SUM,
HLL registers by all-reduce MAX, the candidate rings by an all-gather of
each process's concatenated (key, count) pairs, merged by the same sort
and top-k as in one process. The collectives carry host tensors (gloo;
one card cannot hold two NCCL ranks). Every process must issue the same
collectives in the same order: every update of the metrics suite sums
its PCA statistics across processes, even when this process's rows are
all masked. The dict form is the exception to "its own rows": as in the
reference's SPMD contract, every process passes the same full news and
hits planes (one `FlowDictPacker` over the global stream), every replica
of the key table is fed the same news and stays identical, and each
process counts only its global shards' records.

Three suites share the pattern (scaffolding in `_ShardedSuiteBase`):

- `ShardedFlowSuite`: the l4 sketch suite; CMS and entropy histograms
  merge by add, HLL by max, rings by dedup and top-k, then the merged
  ring is rescored against the merged sketch.
- `ShardedAppSuite`: per-service RED; every field merges by add.
- `ShardedMetricsSuite`: the flow_metrics suite. Entropy histograms and
  window sums stay per shard until flush; the PCA's (count, sums,
  gradient) is summed over the shards on every update, and the same
  step is applied on every shard, so the basis stays replicated.

Flight recorder (runtime/tracing.py, runtime/profiler.py): with the
tracer on, one put in 16 is timed through a device synchronize (the
`shard.h2d` stage and the `mesh_h2d_mb_s` gauge; the only place a suite
blocks for the recorder), every update form records a `shard.update`
span and a `dispatch` profiler record `shard:<suite>`, every flush a
`shard.flush` span, and every cross-process collective a
`shard.collective` span of its own (inside `shard.flush`, or inside
`shard.update` for the metrics suite's per-update sum).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_dict, flow_suite, metrics_suite
from deepflow_tpu_torch.models.flow_suite import (FlowSuiteConfig,
                                                  FlowSuiteState,
                                                  FlowWindowOutput)
from deepflow_tpu_torch.models.metrics_suite import (MetricsSuiteConfig,
                                                     MetricsWindowOutput)
from deepflow_tpu_torch.ops import cms, entropy, hll, pca, topk
from deepflow_tpu_torch.parallel.mesh import Mesh
from deepflow_tpu_torch.runtime.profiler import default_profiler
from deepflow_tpu_torch.runtime.tracing import default_tracer


def tree_map(fn, tree):
    """fn over every tensor of a (nested) NamedTuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*[tree_map(fn, x) for x in tree])


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) NamedTuple, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in tree_leaves(x)]


def _replicate_init(single, devices: Sequence[torch.device]) -> list:
    """One copy of a state per shard, each with storage of its own."""
    return [tree_map(lambda t: t.to(dev, copy=True), single)
            for dev in devices]


def _as_tensor(x) -> torch.Tensor:
    """A host array or a tensor -> a tensor; uint32 is held as int32
    bits, narrower unsigned types widen."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    elif x.dtype.kind == "u":
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def _split(x, devices: Sequence[torch.device], dim: int = 0) -> list:
    """x cut into len(devices) contiguous blocks along `dim`, block d on
    devices[d]."""
    t = _as_tensor(x)
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"batch axis {t.shape[dim]} is not a multiple of "
                         f"{n} shards")
    return [b.to(dev) for b, dev in zip(torch.chunk(t, n, dim), devices)]


def _put_sharded(cols: Dict, mask, devices) -> Tuple[list, list]:
    """A [B] batch -> per-shard column dicts and masks."""
    parts = {k: _split(v, devices) for k, v in cols.items()}
    cols_d = [{k: v[d] for k, v in parts.items()}
              for d in range(len(devices))]
    return cols_d, _split(_as_tensor(mask).to(torch.bool), devices)


def _reduce(ts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """`op`-reduce per-shard tensors onto the first one's device, in
    shard order, into a new tensor of the same dtype (the `psum` of this
    process's shards)."""
    acc = ts[0].clone()
    for t in ts[1:]:
        acc = op(acc, t.to(acc.device))
    return acc


def _sum(ts):
    return _reduce(ts, torch.add)


class _Collective:
    """The cross-process half of a suite's reductions, over the default
    torch.distributed process group. Each call reduces a list of tensors
    with one collective per dtype (flattened into one host tensor, the
    results copied back to each tensor's device); `seconds` and `calls`
    add up the wall time by kind ("update", "flush"), and each call is a
    `shard.collective` span of the suite's stream."""

    def __init__(self, suite: str) -> None:
        import torch.distributed as dist
        self._dist = dist
        self._suite = suite
        self._tracer = default_tracer()
        self.seconds = {"update": 0.0, "flush": 0.0}
        self.calls = {"update": 0, "flush": 0}

    def _timed(self, kind: str, fn):
        t0 = time.perf_counter()
        with self._tracer.span("shard.collective", stream=self._suite):
            out = fn()
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        return out

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str,
                   kind: str = "flush") -> List[torch.Tensor]:
        """Every tensor summed ("sum") or maxed ("max") across processes;
        integer sums wrap as the device's do."""
        rop = {"sum": self._dist.ReduceOp.SUM,
               "max": self._dist.ReduceOp.MAX}[op]
        out = list(tensors)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        for idx in groups.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx]).cpu()
            self._timed(kind, lambda: self._dist.all_reduce(flat, op=rop))
            off = 0
            for i in idx:
                t = tensors[i]
                out[i] = flat[off:off + t.numel()].view(t.shape).to(
                    t.device, copy=True)
                off += t.numel()
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every process's `t` (the same shape in each), in rank order,
        on `t`'s device (a flush's)."""
        host = t.cpu()
        got = [torch.empty_like(host)
               for _ in range(self._dist.get_world_size())]
        self._timed("flush", lambda: self._dist.all_gather(got, host))
        return [g.to(t.device) for g in got]


def _merge_axis0(states: Sequence[FlowSuiteState],
                 comm: Optional[_Collective] = None) -> FlowSuiteState:
    """Merge per-shard partial states into one on the first shard's
    device: CMS and entropy add, HLL max, rings dedup and top-k. The
    reference's `_dedup_keep_max` then `lax.top_k` is `sort_pairs` then
    `select_ring` here; the sort makes the merge independent of the
    order the rings arrive in. With `comm` the shards of every process
    merge: this process's first, then one collective each for the sums,
    the maxima and the rings."""
    root = states[0].ring.keys.device
    keys = torch.cat([s.ring.keys.to(root) for s in states])
    counts = torch.cat([s.ring.counts.to(root) for s in states])
    sums = [_sum([s.sketch.counts for s in states]),
            _sum([s.ent.hist for s in states]),
            _sum([s.rows_seen for s in states]),
            _sum([s.batches_seen for s in states])]
    regs = _reduce([s.services.registers for s in states], torch.maximum)
    if comm is not None:
        sums = comm.all_reduce(sums, "sum")
        (regs,) = comm.all_reduce([regs], "max")
        pairs = torch.cat(comm.all_gather(torch.stack([keys, counts])), 1)
        keys, counts = pairs[0], pairs[1]
    ring = topk.select_ring(*topk.sort_pairs(keys, counts),
                            states[0].ring.keys.shape[0])
    return FlowSuiteState(
        sketch=cms.CMSState(counts=sums[0], seeds=states[0].sketch.seeds),
        ring=ring,
        services=hll.HLLState(registers=regs),
        ent=entropy.EntropyState(hist=sums[1], seeds=states[0].ent.seeds),
        rows_seen=sums[2],
        batches_seen=sums[3],
    )


def rescore_ring(merged: FlowSuiteState) -> FlowSuiteState:
    """Re-score the merged ring's candidates against the merged sketch
    (each shard's estimates saw 1/n of the stream): live * (est + 1) - 1,
    -1 at empty slots."""
    est = cms.query(merged.sketch, merged.ring.keys).to(torch.int32)
    live = topk._not_sentinel(merged.ring.keys)
    return merged._replace(
        ring=merged.ring._replace(counts=live * (est + 1) - 1))


def merge_flush(states: Sequence[FlowSuiteState], cfg: FlowSuiteConfig,
                comm: Optional[_Collective] = None
                ) -> Tuple[FlowSuiteState, FlowSuiteState, FlowWindowOutput]:
    """The merged flush of per-shard partial states, on the first one's
    device: (merged pre-flush state with its ring rescored, fresh state,
    window output). The sharded suite, the pod and the cross-host pod
    all close their windows through it; with `comm` it merges the shards
    of every process (`_merge_axis0`), and every process computes the
    same rescore and flush."""
    merged = rescore_ring(_merge_axis0(states, comm))
    fresh, out = flow_suite.flush(merged, cfg)
    return merged, fresh, out


# -- one shard's block of a batch --------------------------------------------
# The mesh body for one shard, shared by ShardedFlowSuite (every shard in
# turn) and the pod (one shard per worker), so the two update each shard
# with the same code.

def update_lanes_shard(state: FlowSuiteState, plane: torch.Tensor, off: int,
                       n, cfg: FlowSuiteConfig) -> FlowSuiteState:
    """A shard's (4, b) block of a lane plane starting at global column
    `off`; n is the GLOBAL valid count, so row i is valid where
    i + off < n. The unfused ops: the sharded identity rests on shared
    code, not on the fused kernel's equality with them."""
    b = plane.shape[1]
    mask = (torch.arange(b, device=plane.device) + int(off)) < int(n)
    return flow_suite.update_packed(state, flow_suite._lanes_of(plane),
                                    mask, cfg)


def update_news_shard(state: FlowSuiteState, dtable, plane: torch.Tensor,
                      n, d: int, nd: int, cfg: FlowSuiteConfig):
    """A whole (6, C) news plane on shard d of nd: every valid row is
    written into this replica's table, and row i is counted here iff
    i % nd == d. Returns (state, dtable)."""
    rows = torch.arange(plane.shape[1], device=plane.device)
    count = (rows < int(n)) & (rows % nd == d)
    return flow_dict.update_news(state, dtable, plane, int(n), cfg,
                                 count_mask=count)


def update_hits_shard(state: FlowSuiteState, dtable, plane: torch.Tensor,
                      off_pairs: int, n, nd: int,
                      cfg: FlowSuiteConfig) -> FlowSuiteState:
    """A shard's (3, hp) block of a hits plane of nd * hp pairs, starting
    at pair `off_pairs`; n is the GLOBAL valid-record count. Its a-lanes
    hold global positions [off, off + hp), its b-lanes the same offsets
    past the global a-half."""
    hp = plane.shape[1]
    pos_a = torch.arange(hp, device=plane.device) + int(off_pairs)
    gmask = torch.cat([pos_a, pos_a + hp * nd]) < int(n)
    return flow_dict.update_hits(state, dtable, plane, int(n), cfg,
                                 mask=gmask)


def _host_output(out: FlowWindowOutput) -> FlowWindowOutput:
    return FlowWindowOutput(*[t.cpu() for t in out])


class _ShardedSuiteBase:
    """Mesh plumbing shared by the three sharded suites: one state per
    local shard of `axis`, batches split over the same shards, per-shard
    updates, the flight recorder's spans. Subclasses define `_update`
    and `_flush`."""

    _AUDIT_COLS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
                   "packet_tx", "packet_rx")

    def __init__(self, cfg, mesh: Mesh, axis: str,
                 init_single: Callable) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        local = mesh.local_indices(axis)
        if not local or list(local) != list(range(local[0],
                                                  local[0] + len(local))):
            raise ValueError(f"this process's shards of {axis!r} are not "
                             f"one contiguous block: {local}")
        # global shard count; this process's shards are global indices
        # [first, first + len(devices))
        self.n_devices = mesh.shape[axis]
        self.first = local[0]
        self.devices = mesh.local_devices(axis)
        self._init_single = init_single
        self._comm: Optional[_Collective] = None
        if mesh.process_count > 1:
            held = [mesh.axis_processes(axis).count(p)
                    for p in range(mesh.process_count)]
            if len(set(held)) != 1:
                raise ValueError(f"every process must hold as many shards "
                                 f"of {axis!r}: {held}")
            self._comm = _Collective(type(self).__name__)
        # an attached ShadowAuditor mirrors host batches before they are
        # split and closes against the MERGED window output at flush
        # (construct it with shards=n_devices for per-shard attribution)
        self._auditor = None
        self._tracer = default_tracer()
        self._prof = default_profiler()
        self._suite = type(self).__name__
        self._attrib_every = 16
        self._puts_traced = 0

    @property
    def collectives(self) -> Dict[str, Dict[str, float]]:
        """Wall seconds and calls of the cross-process collectives, by
        kind ("update", "flush"); empty in one process."""
        if self._comm is None:
            return {}
        return {"seconds": dict(self._comm.seconds),
                "calls": dict(self._comm.calls)}

    def attach_auditor(self, auditor) -> None:
        """Attach a ShadowAuditor; host-side only (batches already on a
        device are skipped, counted in audit_device_skipped)."""
        self._auditor = auditor
        self.audit_device_skipped = 0

    def init(self) -> list:
        return _replicate_init(self._init_single(self.devices[0]),
                               self.devices)

    def _put(self, put, arrays):
        """Run `put`; with the tracer on, one call in `_attrib_every` is
        timed through a device synchronize (shard.h2d, mesh_h2d_mb_s)."""
        tr = self._tracer
        if not tr.enabled:
            return put()
        detailed = self._puts_traced % self._attrib_every == 0
        self._puts_traced += 1
        if not detailed:
            return put()
        nbytes = sum(int(getattr(a, "nbytes", 0)) for a in arrays)
        t0 = time.perf_counter()
        out = put()
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        tr.observe("shard.h2d", dt, stream=self._suite)
        if dt > 0 and nbytes:
            tr.gauge("mesh_h2d_mb_s", nbytes / 1e6 / dt)
        return out

    def _dispatch(self, fn, *args):
        """Run one update form, as a shard.update span and a dispatch
        profiler record when the tracer is on."""
        tr = self._tracer
        if not tr.enabled:
            return fn(*args)
        t0 = time.perf_counter()
        with tr.span("shard.update", stream=self._suite):
            out = fn(*args)
        self._prof.record("dispatch", f"shard:{self._suite}",
                          time.perf_counter() - t0)
        return out

    def put_batch(self, cols: Dict, mask) -> Tuple[list, list]:
        """Split a batch (host arrays or tensors; on a mesh that spans
        processes, this process's rows of the global batch) over the
        local shards: (per-shard column dicts, per-shard masks)."""
        if self._auditor is not None:
            if all(isinstance(cols.get(k), np.ndarray)
                   for k in self._AUDIT_COLS) \
                    and isinstance(mask, np.ndarray):
                # the device skips masked (padding) rows; so must the
                # shadow, or its exact counts drift per batch
                m = mask.astype(bool, copy=False)
                self._auditor.absorb({k: cols[k] if m.all() else cols[k][m]
                                      for k in self._AUDIT_COLS})
            else:
                self.audit_device_skipped += 1
        return self._put(lambda: _put_sharded(cols, mask, self.devices),
                         list(cols.values()) + [mask])

    def update(self, state: list, cols: list, mask: list) -> list:
        """Advance every local shard by its block of the batch
        (put_batch's lists); returns the new per-shard states."""
        return self._dispatch(self._update, state, cols, mask)

    def _update(self, state: list, cols: list, mask: list) -> list:
        return [self._update_shard(s, c, m)
                for s, c, m in zip(state, cols, mask)]

    def flush(self, state: list, *args):
        tr = self._tracer
        if not tr.enabled:
            res = self._flush(state, *args)
        else:
            with tr.span("shard.flush", stream=self._suite):
                res = self._flush(state, *args)
        if self._auditor is not None and hasattr(res[1], "topk_keys"):
            self._auditor.close_window(_host_output(res[1]))
        return res


class ShardedFlowSuite(_ShardedSuiteBase):
    """FlowSuite sharded over a mesh's `data` axis.

    update(state, cols, mask): put_batch's per-shard lists of a [B] batch,
    B % n_devices == 0. flush(state): fresh per-shard states and the
    merged window output (on the first local shard's device, the same in
    every process)."""

    def __init__(self, cfg: FlowSuiteConfig, mesh: Mesh,
                 axis: str = "data") -> None:
        super().__init__(cfg, mesh, axis,
                         lambda dev: flow_suite.init(cfg, dev))

    def _update_shard(self, state, cols, mask):
        return flow_suite.update(state, cols, mask, self.cfg)

    # -- the full-row plane --------------------------------------------------

    def put_plane(self, plane, mask) -> Tuple[list, list]:
        """Split one (n_cols, B) full-row plane and its [B] mask on the
        batch axis: one block per local shard."""
        return self._put(lambda: (
            _split(plane, self.devices, dim=1),
            _split(_as_tensor(mask).to(torch.bool), self.devices)),
            [plane, mask])

    def update_plane(self, state: list, plane: list, mask: list) -> list:
        return self._dispatch(lambda: [
            flow_suite.update_plane(s, p, m, self.cfg)
            for s, p, m in zip(state, plane, mask)])

    # -- the packed lanes ----------------------------------------------------

    def put_lanes(self, plane) -> list:
        """Split one (4, B) lane plane on its batch axis (no mask:
        update_lanes rebuilds it from the global count)."""
        return self._put(lambda: _split(plane, self.devices, dim=1), [plane])

    def update_lanes(self, state: list, plane: list, n) -> list:
        """Advance from a split lane plane; n is the GLOBAL valid count,
        so global shard d's rows are valid where (arange(b) + d*b) < n."""
        return self._dispatch(lambda: [
            update_lanes_shard(s, p, (self.first + d) * p.shape[1], n,
                               self.cfg)
            for d, (s, p) in enumerate(zip(state, plane))])

    # -- the dictionary wire -------------------------------------------------
    # The key table is replicated, one own copy per shard. News planes go
    # to every replica, so every table stays identical, and each record is
    # counted by exactly one shard (rows % n_devices == d, d the GLOBAL
    # shard index). Hits planes split on their pairs axis and gather from
    # the local replica. On a mesh that spans processes the contract is
    # the reference's SPMD one (one jitted call over a multi-process mesh):
    # every process passes the same full news and hits planes, as one
    # FlowDictPacker fed the global stream emits them. Every replica in
    # every process is then fed the same planes and holds the same table;
    # the tables are never reduced, and the flush all-reduces the sketch
    # state as the other forms do.

    def init_dict(self, capacity: int = 1 << 20) -> list:
        """One replica of an empty key table per local shard."""
        return _replicate_init(
            flow_dict.init_dict(capacity, self.devices[0]), self.devices)

    def update_news(self, state: list, dtable: list, plane, n
                    ) -> Tuple[list, list]:
        """plane (6, C), the same full plane in every process, to every
        replica; each record counted on one shard of the whole mesh."""
        plane = _as_tensor(plane)

        def run():
            states, tables = [], []
            for d, (s, t, dev) in enumerate(zip(state, dtable,
                                                self.devices)):
                s, t = update_news_shard(s, t, plane.to(dev), n,
                                         self.first + d, self.n_devices,
                                         self.cfg)
                states.append(s)
                tables.append(t)
            return states, tables
        return self._dispatch(run)

    def update_hits(self, state: list, dtable: list, plane, n) -> list:
        """plane: the (3, H) pairs layout (2H records), the same full plane
        in every process; n is the GLOBAL valid-record count. This
        process takes its slice of the pairs axis, then splits it over its
        shards: global shard g's a-lanes hold global positions
        [g*hp, (g+1)*hp), its b-lanes the same offsets past the global
        a-half (H = hp * n_devices)."""
        plane = _as_tensor(plane)
        if plane.shape[1] % self.n_devices:
            raise ValueError(f"pairs axis {plane.shape[1]} is not a "
                             f"multiple of {self.n_devices} shards")
        hp = plane.shape[1] // self.n_devices
        mine = plane[:, self.first * hp:(self.first + len(self.devices))
                     * hp]
        return self._dispatch(lambda: [
            update_hits_shard(s, t, p, (self.first + d) * hp, n,
                              self.n_devices, self.cfg)
            for d, (s, t, p) in enumerate(zip(
                state, dtable, _split(mine, self.devices, dim=1)))])

    def _flush(self, state: list) -> Tuple[list, FlowWindowOutput]:
        _merged, fresh, out = merge_flush(state, self.cfg, self._comm)
        return _replicate_init(fresh, self.devices), out


class ShardedAppSuite(_ShardedSuiteBase):
    """AppSuite (per-service RED + DDSketch quantiles) over a mesh. Every
    state field merges by add (DDSketch merge is exact union), so flush
    sums the whole state and closes one window."""

    def __init__(self, cfg, mesh: Mesh, axis: str = "data") -> None:
        from deepflow_tpu_torch.models import app_suite
        self._app = app_suite
        super().__init__(cfg, mesh, axis,
                         lambda dev: app_suite.init(cfg, dev))

    def _update_shard(self, state, cols, mask):
        return self._app.update(state, cols, mask, self.cfg)

    def _flush(self, state: list):
        sums = [_sum(ts) for ts in zip(*map(tree_leaves, state))]
        if self._comm is not None:
            sums = self._comm.all_reduce(sums, "sum")
        it = iter(sums)
        merged = tree_map(lambda _: next(it), state[0])
        fresh, out = self._app.flush(merged, self.cfg)
        return _replicate_init(fresh, self.devices), out


class ShardedMetricsSuite(_ShardedSuiteBase):
    """MetricsSuite (DDoS entropy + golden-signal PCA) over a mesh.

    Entropy histograms and window sums stay per shard and are summed at
    flush (integer adds: sharded equals one device exactly). The PCA
    basis is replicated: every update sums each shard's (count, sum, sum
    of squares, Oja gradient), across processes too, and applies the
    same step on every shard.
    """

    def __init__(self, cfg: MetricsSuiteConfig, mesh: Mesh,
                 axis: str = "data") -> None:
        super().__init__(cfg, mesh, axis,
                         lambda dev: metrics_suite.init(cfg, dev))

    def _update(self, state: list, cols: list, mask: list) -> list:
        ents = [metrics_suite.entropy_update(s.ent, c, m)
                for s, c, m in zip(state, cols, mask)]
        # with one shard this is pca.update, defined as grad + apply_grad
        grads = [pca.grad(s.pca, metrics_suite.signal_matrix(c), m)
                 for s, c, m in zip(state, cols, mask)]
        summed = [_sum(ts) for ts in zip(*grads)]
        if self._comm is not None:
            # the one collective of the hot path, on every update
            summed = self._comm.all_reduce(summed, "sum", kind="update")
        out = []
        for s, c, m, e, dev in zip(state, cols, mask, ents, self.devices):
            p = pca.apply_grad(s.pca, *[t.to(dev) for t in summed],
                               lr=self.cfg.pca_lr)
            ws = s.win_sum + metrics_suite.window_sum(c, m)
            out.append(s._replace(ent=e, pca=p, win_sum=ws))
        return out

    def flush(self, state: list, cols: list, mask: list
              ) -> Tuple[list, MetricsWindowOutput]:
        """Close the window on the merged histograms and window sums (the
        window close consumes the last batch's put_batch lists). The
        anomaly scores stay per shard, concatenated in shard order: this
        process's rows (`multihost.local_shard`); the other outputs are
        the same on every shard of every process and read from the first
        local shard."""
        return super().flush(state, cols, mask)

    def _flush(self, state: list, cols: list, mask: list
               ) -> Tuple[list, MetricsWindowOutput]:
        hist = _sum([s.ent.hist for s in state])
        ws = _sum([s.win_sum for s in state])
        if self._comm is not None:
            hist, ws = self._comm.all_reduce([hist, ws], "sum")
        fresh, outs = [], []
        for s, c, m, dev in zip(state, cols, mask, self.devices):
            merged = s._replace(ent=s.ent._replace(hist=hist.to(dev)),
                                win_sum=ws.to(dev))
            f, o = metrics_suite.flush(merged, c, m, self.cfg)
            fresh.append(f)
            outs.append(o)
        root = self.devices[0]
        out = outs[0]._replace(anomaly_scores=torch.cat(
            [o.anomaly_scores.to(root) for o in outs]))
        return fresh, out
