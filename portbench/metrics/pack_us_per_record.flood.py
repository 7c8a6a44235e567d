"""`pack_us_per_record.l4`'s reading in the flood cell: host microseconds
the l4 worker spends per record coercing, mapping keys, packing and
auditing, where ~90% of records are new keys for the dict packer; None
from a program without the stages."""

from harness.run_cell import _load_reader


def read(run):
    return _load_reader("pack_us_per_record.l4").read(run)
