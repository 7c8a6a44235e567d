"""Milliseconds per l4 window close spent shipping the open staging
prefix and draining the feed (the `l4.close.drain` stage over the
exporter's `windows`) in the untraced stretch; None from a program
without the stage."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_close_drain_sum_s" not in c1:
        return None
    windows = c1["windows"] - c0["windows"]
    if windows <= 0:
        return None
    return 1e3 * (c1["l4_close_drain_sum_s"]
                  - c0.get("l4_close_drain_sum_s", 0.0)) / windows
