"""Host microseconds the l4 worker spends per record in the store's
sampled key map (the `l4.keymap` stage over `rows_in`) in the untraced
stretch; its evictions, `l4_keymap_evictions`, are among the counters on
stderr. None from a program without the stage."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_keymap_sum_s" not in c1:
        return None
    rows = c1["rows_in"] - c0["rows_in"]
    if rows <= 0:
        return None
    return 1e6 * (c1["l4_keymap_sum_s"]
                  - c0.get("l4_keymap_sum_s", 0.0)) / rows
