"""Bytes copied to the card per record by the dict packer and stager,
from the exporter's `h2d_bytes` and `rows_in` counters over the run's
untraced stretch."""


def read(run):
    c0, c1 = run.stretch_counters
    rows = c1["rows_in"] - c0["rows_in"]
    if rows <= 0:
        return None
    return (c1["h2d_bytes"] - c0["h2d_bytes"]) / rows
