"""Milliseconds per l4 window close spent publishing the snapshot: its
host copy, npz write, fsync and subscribers (the stages
`l4.close.snapshot_copy` and `l4.close.snapshot_write` over the
exporter's `windows`) in the untraced stretch; None from a program
without the stages."""

STAGES = ("l4_close_snapshot_copy", "l4_close_snapshot_write")


def read(run):
    c0, c1 = run.stretch_counters
    if any(f"{k}_sum_s" not in c1 for k in STAGES):
        return None
    windows = c1["windows"] - c0["windows"]
    if windows <= 0:
        return None
    return 1e3 * sum(c1[f"{k}_sum_s"] - c0.get(f"{k}_sum_s", 0.0)
                     for k in STAGES) / windows
