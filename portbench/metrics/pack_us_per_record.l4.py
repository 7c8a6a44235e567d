"""Host microseconds the l4 worker spends per record coercing, mapping
keys, packing and auditing (the exporter's always-on stages `l4.coerce`,
`l4.keymap`, `l4.pack` and `l4.audit`) over the untraced stretch; None
from a program without the stages."""

STAGES = ("l4_coerce", "l4_keymap", "l4_pack", "l4_audit")


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_pack_sum_s" not in c1:
        return None
    rows = c1["rows_in"] - c0["rows_in"]
    if rows <= 0:
        return None
    s = sum(c1.get(f"{k}_sum_s", 0.0) - c0.get(f"{k}_sum_s", 0.0)
            for k in STAGES)
    return 1e6 * s / rows
