"""The roofline, trace and metric arithmetic."""

import json

import numpy as np
import pytest

from harness import roofline
from harness.run_cell import RunData, _load_reader
from harness.trace import MARK, Trace
from reference import hashing as H
from reference.l4_sketch import Sizes
from rooflines import fused_lane, fused_news, hist
from rooflines.sectors import touched_bytes

SUITE = {"cms_depth": 4, "cms_log2_width": 17, "ring_size": 2048,
         "top_k": 100, "hll_groups": 1024, "hll_precision": 10,
         "entropy_log2_buckets": 12, "seed": 0xDEC0DE}


def test_touched_bytes_counts_sectors_both_ways():
    assert touched_bytes(np.array([0, 1, 7])) == 64          # one sector
    assert touched_bytes(np.array([0, 8, 8, 16])) == 3 * 64
    assert touched_bytes(np.array([0]), np.array([0])) == 128  # two states


class _T:
    """A host tensor stand-in: what the cost functions read."""

    def __init__(self, a):
        self.a = np.asarray(a)

    def cpu(self):
        return self

    def numpy(self):
        return self.a

    def reshape(self, *s):
        return _T(self.a.reshape(*s))

    def __getitem__(self, i):
        return _T(self.a[i])

    def item(self):
        return self.a.item()


def test_fused_lane_cost_is_plane_plus_sectors():
    n, C = 3, 8
    plane = np.zeros((4, C), np.uint32)
    plane[:, :n] = [[1, 1, 2], [5, 5, 5], [7 << 16 | 80] * 3,
                    [6 << 24 | 10] * 3]
    nbytes, ops = fused_lane.cost((_T(plane.view(np.int32)),
                                   _T(np.array([n], np.int32))),
                                  {"flow_suite": SUITE})
    sz = Sizes(SUITE)
    keys = H.fold([plane[0, :n], plane[1, :n], plane[2, :n] >> 16,
                   plane[2, :n] & 0xFFFF, plane[3, :n] >> 24])
    cms = np.concatenate([H.bucket(keys, *sz.cms_seeds[d], 17) + d * (1 << 17)
                          for d in range(4)])
    ent = [H.bucket(v, *sz.ent_seeds[f], 12) + f * 4096 for f, v in
           enumerate([plane[0, :n], plane[1, :n], plane[2, :n] >> 16,
                      plane[2, :n] & 0xFFFF])]
    want = 4 * 4 * n + 4 + touched_bytes(cms, np.concatenate(ent))
    assert nbytes == want and ops == 191 * n


def test_fused_news_counts_valid_records_only():
    C = 16
    plane = np.arange(6 * C, dtype=np.uint32).reshape(6, C)
    full, _ = fused_news.cost((_T(plane.view(np.int32)),
                               _T(np.array([C], np.int32))),
                              {"flow_suite": SUITE})
    half, _ = fused_news.cost((_T(plane.view(np.int32)),
                               _T(np.array([C // 2], np.int32))),
                              {"flow_suite": SUITE})
    assert half < full
    assert full >= 6 * 4 * C + 4


def test_hist_cost_clamps_and_masks():
    idx = _T(np.array([[0, 1, 9, 100]], np.int32))
    mask = _T(np.array([True, True, True, False]))
    nbytes, ops = hist.cost((idx, None, mask, 16, 2), {})
    # cells 0, 1, 9 (lane 3 masked): sectors 0 and 1
    assert nbytes == 4 * 4 + 4 + 2 * 64 and ops == 4 * 10


def _trace_file(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def test_trace_busy_gaps_and_kernels(tmp_path):
    t = Trace(_trace_file(tmp_path, [
        _ev("user_annotation", MARK, 0, 1000),
        _ev("kernel", "void fused_hists_kernel<true, false>(int)", 100, 50),
        _ev("kernel", "void fused_hists_kernel<false, true>(int)", 120, 80),
        _ev("gpu_memcpy", "Memcpy HtoD", 600, 100),
        _ev("cpu_op", "aten::unique", 200, 400, tid=2),
        _ev("cpu_op", "aten::copy_", 700, 250, tid=2),
    ]))
    assert t.window_s() == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(200e-6)      # [100, 200) + [600, 700)
    assert len(t.kernels(fused_news.KERNEL)) == 1
    assert len(t.kernels(fused_lane.KERNEL)) == 1
    gaps = dict(t.idle_gaps())
    assert gaps["aten::unique"] == pytest.approx(400e-6)   # [200, 600)
    assert gaps["aten::copy_"] == pytest.approx(300e-6)    # [700, 1000)
    assert sum(gaps.values()) == pytest.approx(800e-6)
    ops = dict(t.device_ops())
    assert ops["Memcpy HtoD"] == pytest.approx(100e-6)


def test_roofline_share_and_its_guards(tmp_path, monkeypatch):
    t = Trace(_trace_file(tmp_path, [
        _ev("user_annotation", MARK, 0, 1000),
        _ev("kernel", "hist_global_kernel", 0, 10)]))
    monkeypatch.setattr(hist, "cost", lambda rec, cfg: (33_500, 4))
    dev = "NVIDIA H100 80GB HBM3"
    # 33.5 kB at 3.35 TB/s = 10 ns against 10 us of kernel: 0.1%
    assert roofline.share("hist", [None], t, {}, dev) == pytest.approx(0.1)
    assert roofline.share("hist", [None, None], t, {}, dev) is None
    assert roofline.share("hist", [None], t, {}, "another card") is None


def test_metric_readers(tmp_path):
    t = Trace(_trace_file(tmp_path, [
        _ev("user_annotation", MARK, 0, 1000),
        _ev("kernel", "k", 0, 250), _ev("kernel", "k", 500, 250)]))
    c0 = {"rows_in": 100, "h2d_bytes": 1000, "feed_fence_wait_s": 1.0,
          "batches": 10}
    c1 = {"rows_in": 300, "h2d_bytes": 2600, "feed_fence_wait_s": 1.5,
          "batches": 12}
    run = RunData(trace=t, slice_counters=(c0, c1),
                  stretch_counters=(c0, c1), stretch_s=5.0,
                  stretch_closes_ms=[3.0, 9.0, 4.0], launches={},
                  config={}, device_name="x")
    got = {name: _load_reader(name).read(run) for name in (
        "h2d_bytes_per_record.l4", "feed_fence_wait_share.l4",
        "launches_per_batch.l4", "launches_per_batch.red",
        "device_idle_share", "window_close_max_ms")}
    assert got == pytest.approx({
        "h2d_bytes_per_record.l4": 8.0, "feed_fence_wait_share.l4": 10.0,
        "launches_per_batch.l4": 1.0, "launches_per_batch.red": 1.0,
        "device_idle_share": 50.0, "window_close_max_ms": 9.0})
    run.trace = None
    assert _load_reader("device_idle_share").read(run) is None
    assert _load_reader("fused_lane_roofline").read(run) is None


def test_host_thread_shares():
    from harness import host
    now = host.thread_cpu_s()
    assert "MainThread" in now
    shares = host.cpu_shares({"a": 1.0, "b": 2.0},
                             {"a": 1.5, "b": 2.0, "c": 0.25}, 0.5)
    assert shares == {"a": 1.0, "c": 0.5}
