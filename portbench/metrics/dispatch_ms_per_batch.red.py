"""Host milliseconds the RED worker spends per batch in the suite's
update, which launches its kernels (the `red.update` stage over the
exporter's `batches`) in the untraced stretch; None from a program
without the stage."""


def read(run):
    c0, c1 = run.stretch_counters
    if "red_update_sum_s" not in c1:
        return None
    batches = c1["batches"] - c0["batches"]
    if batches <= 0:
        return None
    return 1e3 * (c1["red_update_sum_s"]
                  - c0.get("red_update_sum_s", 0.0)) / batches
