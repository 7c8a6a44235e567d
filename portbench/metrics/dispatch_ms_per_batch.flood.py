"""`dispatch_ms_per_batch.l4`'s reading in the flood cell: host
milliseconds the feed thread spends per batch on the news-heavy group
signatures a flood makes; None from a program without the stage."""

from harness.run_cell import _load_reader


def read(run):
    return _load_reader("dispatch_ms_per_batch.l4").read(run)
