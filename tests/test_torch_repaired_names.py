"""Six public names of ported modules that the port had dropped, held
against the JAX package's: `SnapshotBus.save`, `SketchSnapshot.age_s`,
`ops/hashing.fingerprint`, `store/table.schema_from_batch_schema`, the
`runtime/exporters.Exporter` Protocol and `runtime/faults.ALL_FAULT_SITES`.
"""

import inspect
import time
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.batch import schema as jschema
from deepflow_tpu.ops import hashing as jhashing
from deepflow_tpu.runtime import exporters as jexporters
from deepflow_tpu.runtime import faults as jfaults
from deepflow_tpu.runtime import snapbus as jsnapbus
from deepflow_tpu.store import table as jtable
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.batch import schema as tschema
from deepflow_tpu_torch.models import flow_suite as tfs
from deepflow_tpu_torch.ops import hashing as thashing
from deepflow_tpu_torch.runtime import exporters as texporters
from deepflow_tpu_torch.runtime import faults as tfaults
from deepflow_tpu_torch.runtime import snapbus as tsnapbus
from deepflow_tpu_torch.store import table as ttable

NAMES = ("SnapshotBus.save", "SketchSnapshot.age_s", "fingerprint",
         "schema_from_batch_schema", "Exporter", "ALL_FAULT_SITES")


@pytest.mark.parametrize("name", NAMES)
def test_repaired_name_matches_reference(name, tmp_path):
    rng = np.random.default_rng(16)
    if name == "SnapshotBus.save":
        cfg = tfs.FlowSuiteConfig(cms_depth=2, cms_log2_width=8,
                                  ring_size=64, hll_groups=8,
                                  hll_precision=6, entropy_log2_buckets=6)
        state = tfs.init(cfg, device="cpu")
        counts = state.sketch.counts
        counts.add_(torch.from_numpy(rng.integers(
            0, 9, tuple(counts.shape), dtype=np.int64)).to(counts.dtype))
        bus = tsnapbus.SnapshotBus(str(tmp_path), name="flows")
        path = bus.save(state, 7)
        assert path and path == bus.latest().path
        assert path.endswith("flows-000000000007.npz")
        want = [np.asarray(a) for a in convert.state_to_numpy(state)]
        # the file read back through both packages
        for snap in (tsnapbus.SnapshotBus(str(tmp_path),
                                          name="flows").read_latest(),
                     jsnapbus.SnapshotBus(str(tmp_path),
                                          name="flows").read_latest()):
            assert snap.step == 7 and len(snap.leaves) == len(want)
            for a, b in zip(snap.leaves, want):
                np.testing.assert_array_equal(np.asarray(a), b)
        assert tsnapbus.SnapshotBus(None).save([np.zeros(3)], 1) == \
            jsnapbus.SnapshotBus(None).save([np.zeros(3)], 1) == ""
    elif name == "SketchSnapshot.age_s":
        now = time.time()
        for wall in (now - 5.0, now + 60.0):
            t = tsnapbus.SketchSnapshot(step=1, seq=1, wall_time=wall,
                                        leaves=())
            j = jsnapbus.SketchSnapshot(step=1, seq=1, wall_time=wall,
                                        leaves=())
            assert abs(t.age_s - j.age_s) < 0.5
        assert t.age_s == 0.0 == j.age_s
        assert isinstance(inspect.getattr_static(
            tsnapbus.SketchSnapshot, "age_s"), property)
    elif name == "fingerprint":
        keys = rng.integers(-2**31, 2**31, 4096, dtype=np.int64) \
            .astype(np.int32)
        for salt in (0xF1A9E12, 0, 0xFFFFFFFF, 12345):
            want = np.asarray(jhashing.fingerprint(jnp.asarray(keys), salt))
            got = thashing.fingerprint(torch.from_numpy(keys), salt)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(
            thashing.fingerprint(torch.from_numpy(keys)).numpy()
            .view(np.uint32),
            np.asarray(jhashing.fingerprint(jnp.asarray(keys))))
    elif name == "schema_from_batch_schema":
        from deepflow_tpu.store.table import AggKind as JAgg
        from deepflow_tpu_torch.store.table import AggKind as TAgg
        for sname in ("L4_SCHEMA", "METRIC_SCHEMA", "L7_SCHEMA"):
            jb, tb = getattr(jschema, sname), getattr(tschema, sname)
            cols = [c for c, _ in jb.columns]
            aggs = {c: ("SUM", "MAX", "MIN", "LAST")[i % 4]
                    for i, c in enumerate(cols) if i % 3}
            j = jtable.schema_from_batch_schema(
                jb, {c: JAgg[a] for c, a in aggs.items()},
                time_column="timestamp", ttl_seconds=3600)
            t = ttable.schema_from_batch_schema(
                tb, {c: TAgg[a] for c, a in aggs.items()},
                time_column="timestamp", ttl_seconds=3600)
            assert t.to_json() == j.to_json()
    elif name == "Exporter":
        assert getattr(texporters.Exporter, "_is_protocol", False)
        assert typing.Protocol in texporters.Exporter.__mro__
        for meth in ("start", "close", "is_export_data", "put"):
            assert inspect.signature(
                getattr(texporters.Exporter, meth)) == inspect.signature(
                getattr(jexporters.Exporter, meth))
        assert sorted(n for n in vars(texporters.Exporter)
                      if not n.startswith("_")) == \
            sorted(n for n in vars(jexporters.Exporter)
                   if not n.startswith("_"))
    else:
        assert tfaults.ALL_FAULT_SITES == jfaults.ALL_FAULT_SITES
        assert "ALL_FAULT_SITES" in tfaults.__all__
