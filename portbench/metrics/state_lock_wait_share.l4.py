"""Share of the untraced stretch's wall time in which the l4 worker
waited for the exporter's state lock (its `l4.lock_wait` stage; a window
close holds the lock); None from a program without the stage."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_lock_wait_sum_s" not in c1 or run.stretch_s <= 0:
        return None
    return 100.0 * (c1["l4_lock_wait_sum_s"]
                    - c0.get("l4_lock_wait_sum_s", 0.0)) / run.stretch_s
