"""Share of the untraced stretch's wall time in which the device feed
thread waited on a fence (a group still on the card), from the
exporter's `feed_fence_wait_s` counter."""


def read(run):
    c0, c1 = run.stretch_counters
    if "feed_fence_wait_s" not in c1 or run.stretch_s <= 0:
        return None
    return 100.0 * (c1["feed_fence_wait_s"] - c0["feed_fence_wait_s"]) \
        / run.stretch_s
