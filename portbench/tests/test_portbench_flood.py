"""The SYN-flood cell (`l4_syn_flood`) on the CPU: its configuration,
which offers every lane to the top-K ring, holds the flood's exact top-K
within the guarantee on a small bank, and the same bank under the
shipped 1-in-16 admission (`l4_sketch_ingester`'s) loses more than it;
the control is not correct in this cell either. Then the arithmetic of
the cell's per-layer readers, each None on what a program without its
counter or stage reports (the trace's launches: on an untraced run)."""

import io
import json

import pytest

import control
from harness import run_cell, spec
from harness.run_cell import RunData, _load_reader

CELL = "l4_syn_flood"
SEED = 2**31 + 29


def _run(small_mix, seconds=6.0):
    return run_cell.run(CELL, SEED, seconds, False, device="cpu",
                        mix=small_mix("syn_flood", 1 << 17),
                        log=io.StringIO())


def test_flood_cell_holds_the_topk(small_mix):
    r = _run(small_mix)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["topk_loss"]["value"] < 0.01


def test_shipped_admission_loses_the_flood_topk(monkeypatch, small_mix):
    shipped = json.loads((spec.ROOT / "portbench" / "configs" /
                          "l4_sketch_ingester.json").read_text())
    sample = shipped["flow_suite"]["topk_sample_log2"]
    assert sample > 0
    find = spec.find_cell

    def shipped_admission(name, bench=None):
        cell = find(name, bench)
        cell.config["flow_suite"]["topk_sample_log2"] = sample
        return cell
    monkeypatch.setattr(spec, "find_cell", shipped_admission)
    r = _run(small_mix)
    assert r["correct"] is False
    c = r["checks"]["topk_loss"]
    assert not run_cell.within(c["value"], c["limit"]), c
    # the ring stays self-consistent: only the loss catches it
    assert r["checks"]["topk_off"]["value"] == 0


def test_control_is_not_correct_in_the_flood_cell(small_mix):
    r = control.control(CELL, 23, 60_000, 3,
                        mix=small_mix("syn_flood", 1 << 17))
    assert r["correct"] is False
    c = r["checks"]["readout_gap"]
    assert not run_cell.within(c["value"], c["limit"])


def _data(c0, c1, trace=None, launches=None):
    return RunData(trace=trace, slice_counters=(c0, c1),
                   stretch_counters=(c0, c1), stretch_s=1.0,
                   stretch_closes_ms=[], launches=launches or {},
                   config={}, device_name="x")


@pytest.mark.parametrize("name,c0,c1,want", [
    ("dict_news_share.flood",
     {"rows_in": 1000, "l4_dict_news_rows": 900},
     {"rows_in": 3000, "l4_dict_news_rows": 2800}, 95.0),
    ("keymap_us_per_record.flood",
     {"rows_in": 1000, "l4_keymap_sum_s": 0.5},
     {"rows_in": 5000, "l4_keymap_sum_s": 0.502}, 0.5),
    ("graph_replay_share.flood",
     {"l4_graph_replays": 10, "l4_graph_eager": 2},
     {"l4_graph_replays": 58, "l4_graph_eager": 4}, 96.0),
    ("pack_us_per_record.flood",
     {"rows_in": 1000, "l4_pack_sum_s": 1.0, "l4_keymap_sum_s": 0.5},
     {"rows_in": 3000, "l4_pack_sum_s": 1.003, "l4_keymap_sum_s": 0.501,
      "l4_coerce_sum_s": 0.0004, "l4_audit_sum_s": 0.0006}, 2.5),
    ("state_lock_wait_share.flood",
     {"l4_lock_wait_sum_s": 0.25}, {"l4_lock_wait_sum_s": 0.5}, 25.0),
    ("dispatch_ms_per_batch.flood",
     {"batches": 4, "l4_dispatch_sum_s": 0.04},
     {"batches": 14, "l4_dispatch_sum_s": 0.14}, 10.0),
    # counters first seen inside the stretch count from zero
    ("dict_news_share.flood", {"rows_in": 0},
     {"rows_in": 400, "l4_dict_news_rows": 100}, 25.0),
])
def test_flood_reader_arithmetic(name, c0, c1, want):
    assert _load_reader(name).read(_data(c0, c1)) == pytest.approx(want)


def test_flood_launches_reader_counts_the_slice():
    class Trace:
        def kernels(self):
            return [None] * 90
    got = _load_reader("launches_per_batch.flood").read(
        _data({"batches": 2}, {"batches": 5}, trace=Trace()))
    assert got == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["dict_news_share.flood",
                                  "keymap_us_per_record.flood",
                                  "graph_replay_share.flood",
                                  "fused_news_flood_roofline",
                                  "pack_us_per_record.flood",
                                  "state_lock_wait_share.flood",
                                  "dispatch_ms_per_batch.flood",
                                  "launches_per_batch.flood"])
def test_flood_readers_none_without_their_counters(name):
    """A program that lacks the counter or stage (the parent of the
    change that added it), an empty stretch, and an untraced run read
    None and raise nothing."""
    reader = _load_reader(name)
    old = {"rows_in": 10, "batches": 1, "dispatches": 1}
    assert reader.read(_data(old, {"rows_in": 90, "batches": 3,
                                   "dispatches": 3})) is None
    still = {"rows_in": 90, "batches": 3, "l4_dict_news_rows": 80,
             "l4_keymap_sum_s": 1.0, "l4_pack_sum_s": 1.0,
             "l4_dispatch_sum_s": 1.0, "l4_graph_replays": 3,
             "l4_graph_eager": 1}
    assert reader.read(_data(still, dict(still))) is None
