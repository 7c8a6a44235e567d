"""Host microseconds the RED exporter spends per record cutting batches
and staging them for their copy (the stages `red.cut` and `red.stage`
over `rows_in`) in the untraced stretch; None from a program without
the stages."""

STAGES = ("red_cut", "red_stage")


def read(run):
    c0, c1 = run.stretch_counters
    if any(f"{k}_sum_s" not in c1 for k in STAGES):
        return None
    rows = c1["rows_in"] - c0["rows_in"]
    if rows <= 0:
        return None
    return 1e6 * sum(c1[f"{k}_sum_s"] - c0.get(f"{k}_sum_s", 0.0)
                     for k in STAGES) / rows
