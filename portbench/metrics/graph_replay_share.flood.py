"""`graph_replay_share.l4`'s reading in the flood cell: the share of the
dict wire's dispatches in the untraced stretch that replayed a captured
CUDA graph, on the news-heavy group signatures a flood makes; None from
a program without the counters."""

from harness.run_cell import _load_reader


def read(run):
    return _load_reader("graph_replay_share.l4").read(run)
