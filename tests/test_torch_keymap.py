"""The store's sampled key map (`TpuSketchExporter._record_key_tuples`)
under new-key churn, against the JAX package's `_record_key_tuples` on
the same chunks: at a small cap, a stream that overflows it leaves the
same keys in the same order with the same 5-tuples after every chunk,
counts each eviction in `l4_keymap_evictions`, and writes the same
`topk_flows` rows."""

from types import SimpleNamespace

import numpy as np
import pytest

from deepflow_tpu.runtime.tpu_sketch import TpuSketchExporter as JaxExporter
from deepflow_tpu.utils.u32 import fold_columns_np
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime import tpu_sketch
from deepflow_tpu_torch.runtime.tpu_sketch import (SKETCH_DB,
                                                   TpuSketchExporter)
from deepflow_tpu_torch.store.db import Store

CAP = 64
_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)


def _chunks(seed, n_chunks=6, rows=2048, pool=40, unique_share=0.7):
    """Chunks of l4 records: `unique_share` of the rows carry a 5-tuple
    that never repeats, the rest one of `pool` flows (heavy and
    repeated, so some keys are seen again after others came in)."""
    rng = np.random.default_rng(seed)
    flows = np.stack([rng.integers(1, 1 << 31, pool),
                      rng.integers(1, 1 << 31, pool),
                      rng.integers(1024, 1 << 16, pool),
                      rng.choice([53, 80, 443], pool),
                      rng.choice([6, 17], pool)], axis=1).astype(np.uint32)
    out, ctr = [], 0
    for _ in range(n_chunks):
        tup = flows[rng.integers(0, pool, rows)].copy()
        new = rng.random(rows) < unique_share
        k = int(new.sum())
        tup[new, 0] = 0x0B000000 + ctr + np.arange(k, dtype=np.uint32)
        ctr += k
        cols = {n: tup[:, i] for i, n in enumerate(tpu_sketch._TUPLE_NAMES)}
        cols["packet_tx"] = rng.integers(1, 100, rows).astype(np.uint32)
        cols["packet_rx"] = np.zeros(rows, np.uint32)
        out.append(cols)
    return out


def _reference_record(ref, cols) -> int:
    """The JAX package's map on `ref` (a plain dict under a stub); the
    evictions it made: the keys it held or took in, less those it
    holds after."""
    sample = [np.asarray(cols[k][::16]) for k in tpu_sketch._TUPLE_NAMES]
    seen = set(ref._key_tuples) | {int(k) for k in fold_columns_np(sample)}
    JaxExporter._record_key_tuples(ref, cols)
    return len(seen) - len(ref._key_tuples)


def _exporter(root):
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                            batch_rows=1024, wire="dict",
                            store=Store(str(root)), device="cpu")
    exp._KEY_TUPLES_CAP = CAP
    return exp


@pytest.mark.parametrize("unique_share", [1.0, 0.7])
def test_key_map_order_and_evictions_match_jax(tmp_path, unique_share):
    exp = _exporter(tmp_path)
    ref = SimpleNamespace(_key_tuples={}, _KEY_TUPLES_CAP=CAP)
    evicted = 0
    try:
        for cols in _chunks(3, unique_share=unique_share):
            exp._record_key_tuples(cols)
            evicted += _reference_record(ref, cols)
            assert list(exp._key_tuples) == list(ref._key_tuples)
            for key, tup in ref._key_tuples.items():
                assert exp._key_tuples[key] == tup.tolist(), key
            assert exp.counters()["l4_keymap_evictions"] == evicted
    finally:
        exp.close()
    sampled = sum(len(c["ip_src"][::16]) for c in _chunks(3,
                  unique_share=unique_share))
    assert len(ref._key_tuples) == CAP and evicted > 0
    if unique_share == 1.0:
        # every sampled key is new: the overflow is all of it
        assert evicted == sampled - CAP


def _topk_rows(root, record):
    exp = _exporter(root)
    if record is not None:
        exp._key_tuples = {}
        exp._record_key_tuples = record.__get__(exp)
    try:
        for i, cols in enumerate(_chunks(5)):
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + i)
    finally:
        exp.close()
    store = Store(str(root))
    return store.table(SKETCH_DB, "topk_flows").scan()


def test_topk_flows_rows_match_the_jax_key_map(tmp_path):
    """The port's writer resolving its top-K through the JAX package's
    map (run on the exporter's own `_key_tuples`) writes the rows the
    port's own map gives."""
    def jax_map(self, cols):
        if self.topk_writer is not None:
            JaxExporter._record_key_tuples(self, cols)

    got = _topk_rows(tmp_path / "port", None)
    want = _topk_rows(tmp_path / "jax", jax_map)
    assert set(got) == set(want) and len(got["flow_key"]) > 0
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the pool's flows stay in the map and resolve their rows
    assert (got["ip_src"] != 0).any()
