"""Sharded suites: batch-sharded updates, window merges at flush.

One process drives every shard of a `Mesh` axis (parallel/mesh.py). A
suite's state is a list with one state per shard, shard d on
`devices[d]`, each with storage of its own (the updates add in place,
so a shared tensor would corrupt every shard that holds it). A batch of
B rows splits into n contiguous blocks, shard d taking rows
[d*B/n, (d+1)*B/n); B % n == 0 is required, as in JAX. Updates touch
only their shard. Where JAX's `shard_map` programs `psum`, the port
reduces onto the first shard's device in shard order and copies the
result back to every shard.

Three suites share the pattern (scaffolding in `_ShardedSuiteBase`):

- `ShardedFlowSuite`: the l4 sketch suite; CMS and entropy histograms
  merge by add, HLL by max, rings by dedup and top-k, then the merged
  ring is rescored against the merged sketch.
- `ShardedAppSuite`: per-service RED; every field merges by add.
- `ShardedMetricsSuite`: the flow_metrics suite. Entropy histograms and
  window sums stay per shard until flush; the PCA's (count, sums,
  gradient) is summed over the shards on every update, and the same
  step is applied on every shard, so the basis stays replicated.

The reference's tracer spans and profiler records are not ported (no
tracer in the port yet).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

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
    shard order, into a new tensor of the same dtype (the `psum`)."""
    acc = ts[0].clone()
    for t in ts[1:]:
        acc = op(acc, t.to(acc.device))
    return acc


def _sum(ts):
    return _reduce(ts, torch.add)


def _merge_axis0(states: Sequence[FlowSuiteState]) -> FlowSuiteState:
    """Merge per-shard partial states into one on the first shard's
    device: CMS and entropy add, HLL max, rings dedup and top-k. The
    reference's `_dedup_keep_max` then `lax.top_k` is `sort_pairs` then
    `select_ring` here."""
    root = states[0].ring.keys.device
    keys = torch.cat([s.ring.keys.to(root) for s in states])
    counts = torch.cat([s.ring.counts.to(root) for s in states])
    ring = topk.select_ring(*topk.sort_pairs(keys, counts),
                            states[0].ring.keys.shape[0])
    return FlowSuiteState(
        sketch=cms.CMSState(counts=_sum([s.sketch.counts for s in states]),
                            seeds=states[0].sketch.seeds),
        ring=ring,
        services=hll.HLLState(registers=_reduce(
            [s.services.registers for s in states], torch.maximum)),
        ent=entropy.EntropyState(hist=_sum([s.ent.hist for s in states]),
                                 seeds=states[0].ent.seeds),
        rows_seen=_sum([s.rows_seen for s in states]),
        batches_seen=_sum([s.batches_seen for s in states]),
    )


def rescore_ring(merged: FlowSuiteState) -> FlowSuiteState:
    """Re-score the merged ring's candidates against the merged sketch
    (each shard's estimates saw 1/n of the stream): live * (est + 1) - 1,
    -1 at empty slots."""
    est = cms.query(merged.sketch, merged.ring.keys).to(torch.int32)
    live = topk._not_sentinel(merged.ring.keys)
    return merged._replace(
        ring=merged.ring._replace(counts=live * (est + 1) - 1))


def merge_flush(states: Sequence[FlowSuiteState], cfg: FlowSuiteConfig
                ) -> Tuple[FlowSuiteState, FlowSuiteState, FlowWindowOutput]:
    """The merged flush of per-shard partial states, on the first one's
    device: (merged pre-flush state with its ring rescored, fresh state,
    window output). The sharded suite, the pod and the cross-host pod
    all close their windows through it."""
    merged = rescore_ring(_merge_axis0(states))
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
    shard of `axis`, batches split over the same shards, per-shard
    updates. Subclasses define `_update_shard` and `flush`."""

    _AUDIT_COLS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
                   "packet_tx", "packet_rx")

    def __init__(self, cfg, mesh: Mesh, axis: str,
                 init_single: Callable) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.n_devices = len(self.devices)
        self._init_single = init_single
        # an attached ShadowAuditor mirrors host batches before they are
        # split and closes against the MERGED window output at flush
        # (construct it with shards=n_devices for per-shard attribution)
        self._auditor = None

    def attach_auditor(self, auditor) -> None:
        """Attach a ShadowAuditor; host-side only (batches already on a
        device are skipped, counted in audit_device_skipped)."""
        self._auditor = auditor
        self.audit_device_skipped = 0

    def init(self) -> list:
        return _replicate_init(self._init_single(self.devices[0]),
                               self.devices)

    def put_batch(self, cols: Dict, mask) -> Tuple[list, list]:
        """Split a [B] batch (host arrays or tensors) over the shards:
        (per-shard column dicts, per-shard masks)."""
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
        return _put_sharded(cols, mask, self.devices)

    def update(self, state: list, cols: list, mask: list) -> list:
        """Advance every shard by its block of the batch (put_batch's
        lists); returns the new per-shard states."""
        return [self._update_shard(s, c, m)
                for s, c, m in zip(state, cols, mask)]

    def _close_audit(self, out: FlowWindowOutput) -> None:
        if self._auditor is not None:
            self._auditor.close_window(_host_output(out))


class ShardedFlowSuite(_ShardedSuiteBase):
    """FlowSuite sharded over a mesh's `data` axis.

    update(state, cols, mask): put_batch's per-shard lists of a [B] batch,
    B % n_devices == 0. flush(state): fresh per-shard states and the
    merged window output (on the first shard's device)."""

    def __init__(self, cfg: FlowSuiteConfig, mesh: Mesh,
                 axis: str = "data") -> None:
        super().__init__(cfg, mesh, axis,
                         lambda dev: flow_suite.init(cfg, dev))

    def _update_shard(self, state, cols, mask):
        return flow_suite.update(state, cols, mask, self.cfg)

    # -- the full-row plane --------------------------------------------------

    def put_plane(self, plane, mask) -> Tuple[list, list]:
        """Split one (n_cols, B) full-row plane and its [B] mask on the
        batch axis: one block per shard."""
        return (_split(plane, self.devices, dim=1),
                _split(_as_tensor(mask).to(torch.bool), self.devices))

    def update_plane(self, state: list, plane: list, mask: list) -> list:
        return [flow_suite.update_plane(s, p, m, self.cfg)
                for s, p, m in zip(state, plane, mask)]

    # -- the packed lanes ----------------------------------------------------

    def put_lanes(self, plane) -> list:
        """Split one (4, B) lane plane on its batch axis (no mask:
        update_lanes rebuilds it from the global count)."""
        return _split(plane, self.devices, dim=1)

    def update_lanes(self, state: list, plane: list, n) -> list:
        """Advance from a split lane plane; n is the GLOBAL valid count,
        so shard d's rows are valid where (arange(b) + d*b) < n."""
        return [update_lanes_shard(s, p, d * p.shape[1], n, self.cfg)
                for d, (s, p) in enumerate(zip(state, plane))]

    # -- the dictionary wire -------------------------------------------------
    # The key table is replicated, one own copy per shard. News planes go
    # to every replica, so every table stays identical, and each record is
    # counted by exactly one shard (rows % n_devices == d). Hits planes
    # split on their pairs axis and gather from the local replica.

    def init_dict(self, capacity: int = 1 << 20) -> list:
        return _replicate_init(
            flow_dict.init_dict(capacity, self.devices[0]), self.devices)

    def update_news(self, state: list, dtable: list, plane, n
                    ) -> Tuple[list, list]:
        """plane (6, C) to every replica; each record counted on one
        shard."""
        plane = _as_tensor(plane)
        states, tables = [], []
        for d, (s, t, dev) in enumerate(zip(state, dtable, self.devices)):
            s, t = update_news_shard(s, t, plane.to(dev), n, d,
                                     self.n_devices, self.cfg)
            states.append(s)
            tables.append(t)
        return states, tables

    def update_hits(self, state: list, dtable: list, plane, n) -> list:
        """plane: the (3, H) pairs layout (2H records) split on its pairs
        axis; n is the GLOBAL valid-record count. Shard d's a-lanes hold
        global positions [d*hp, (d+1)*hp), its b-lanes the same offsets
        past the global a-half (H = hp * n_devices)."""
        return [update_hits_shard(s, t, p, d * p.shape[1], n,
                                  self.n_devices, self.cfg)
                for d, (s, t, p) in enumerate(zip(
                    state, dtable, _split(plane, self.devices, dim=1)))]

    def flush(self, state: list) -> Tuple[list, FlowWindowOutput]:
        _merged, fresh, out = merge_flush(state, self.cfg)
        self._close_audit(out)
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

    def flush(self, state: list):
        sums = iter([_sum(ts) for ts in zip(*map(tree_leaves, state))])
        merged = tree_map(lambda _: next(sums), state[0])
        fresh, out = self._app.flush(merged, self.cfg)
        return _replicate_init(fresh, self.devices), out


class ShardedMetricsSuite(_ShardedSuiteBase):
    """MetricsSuite (DDoS entropy + golden-signal PCA) over a mesh.

    Entropy histograms and window sums stay per shard and are summed at
    flush (integer adds: sharded equals one device exactly). The PCA
    basis is replicated: every update sums each shard's (count, sum, sum
    of squares, Oja gradient) and applies the same step on every shard.
    """

    def __init__(self, cfg: MetricsSuiteConfig, mesh: Mesh,
                 axis: str = "data") -> None:
        super().__init__(cfg, mesh, axis,
                         lambda dev: metrics_suite.init(cfg, dev))

    def update(self, state: list, cols: list, mask: list) -> list:
        ents = [metrics_suite.entropy_update(s.ent, c, m)
                for s, c, m in zip(state, cols, mask)]
        # with one shard this is pca.update, defined as grad + apply_grad
        grads = [pca.grad(s.pca, metrics_suite.signal_matrix(c), m)
                 for s, c, m in zip(state, cols, mask)]
        summed = [_sum(ts) for ts in zip(*grads)]
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
        anomaly scores stay per shard, concatenated in shard order; the
        other outputs are the same on every shard and read from shard 0."""
        hist = _sum([s.ent.hist for s in state])
        ws = _sum([s.win_sum for s in state])
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
