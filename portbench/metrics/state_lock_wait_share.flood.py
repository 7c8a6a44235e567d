"""`state_lock_wait_share.l4`'s reading in the flood cell: the share of
the untraced stretch in which the l4 worker waited for the state lock
that a window close holds; None from a program without the stage."""

from harness.run_cell import _load_reader


def read(run):
    return _load_reader("state_lock_wait_share.l4").read(run)
