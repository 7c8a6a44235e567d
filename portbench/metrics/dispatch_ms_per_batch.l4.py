"""Host milliseconds the l4 feed thread spends per batch issuing its copy
and launching its program (the `l4.dispatch` stage over the exporter's
`batches`) in the untraced stretch; None from a program without the
stage."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_dispatch_sum_s" not in c1:
        return None
    batches = c1["batches"] - c0["batches"]
    if batches <= 0:
        return None
    return 1e3 * (c1["l4_dispatch_sum_s"]
                  - c0.get("l4_dispatch_sum_s", 0.0)) / batches
