"""The readers of the exporters' always-on stage counters."""

import pytest

from harness.run_cell import RunData, _load_reader


STAGE_READERS = {
    # name: (counters before, after, stretch seconds, expected value)
    "pack_us_per_record.l4": (
        {"rows_in": 1000, "l4_coerce_sum_s": 0.1, "l4_keymap_sum_s": 0.2,
         "l4_pack_sum_s": 0.3, "l4_audit_sum_s": 0.0},
        {"rows_in": 11000, "l4_coerce_sum_s": 0.11, "l4_keymap_sum_s": 0.22,
         "l4_pack_sum_s": 0.35, "l4_audit_sum_s": 0.01}, 1.0, 9.0),
    "state_lock_wait_share.l4": (
        {"l4_lock_wait_sum_s": 1.0}, {"l4_lock_wait_sum_s": 1.5}, 5.0, 10.0),
    "dispatch_ms_per_batch.l4": (
        {"batches": 10, "l4_dispatch_sum_s": 2.0},
        {"batches": 30, "l4_dispatch_sum_s": 2.5}, 1.0, 25.0),
    "close_drain_ms.l4": (
        {"windows": 3, "l4_close_drain_sum_s": 0.1},
        {"windows": 7, "l4_close_drain_sum_s": 0.14}, 1.0, 10.0),
    "close_snapshot_ms.l4": (
        {"windows": 3, "l4_close_snapshot_copy_sum_s": 0.1,
         "l4_close_snapshot_write_sum_s": 0.2},
        {"windows": 5, "l4_close_snapshot_copy_sum_s": 0.12,
         "l4_close_snapshot_write_sum_s": 0.3}, 1.0, 60.0),
    "dispatch_ms_per_batch.red": (
        {"batches": 100, "red_update_sum_s": 1.0},
        {"batches": 500, "red_update_sum_s": 1.2}, 1.0, 0.5),
    "batching_us_per_record.red": (
        {"rows_in": 0, "red_cut_sum_s": 0.5, "red_stage_sum_s": 0.25},
        {"rows_in": 100000, "red_cut_sum_s": 0.6, "red_stage_sum_s": 0.3},
        1.0, 1.5),
}


def _stage_run(c0, c1, stretch_s):
    return RunData(trace=None, slice_counters=(c0, c1),
                   stretch_counters=(c0, c1), stretch_s=stretch_s,
                   stretch_closes_ms=[], launches={}, config={},
                   device_name="x")


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_readers(name):
    """Each reader of the exporters' always-on stages on hand-made
    counters; None from a program without the stage's counter (the
    parent of the change that added it) and when no record, batch or
    window moved, or no time passed."""
    c0, c1, stretch_s, want = STAGE_READERS[name]
    reader = _load_reader(name)
    assert reader.read(_stage_run(c0, c1, stretch_s)) == \
        pytest.approx(want)
    # a stage first recorded inside the stretch counts from zero
    if name == "pack_us_per_record.l4":
        c0b = {k: v for k, v in c0.items() if k != "l4_audit_sum_s"}
        assert reader.read(_stage_run(c0b, c1, stretch_s)) == \
            pytest.approx(want)
    old = {"rows_in": 5, "batches": 5, "windows": 5, "h2d_bytes": 1}
    assert reader.read(_stage_run(old, dict(old), stretch_s)) is None
    still = dict(c1)
    for k in ("rows_in", "batches", "windows"):
        if k in c0:
            still[k] = c0[k]
    moved = any(k in c0 for k in ("rows_in", "batches", "windows"))
    got = reader.read(_stage_run(c0, still, 0.0 if not moved else
                                 stretch_s))
    assert got is None
