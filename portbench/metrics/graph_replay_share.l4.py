"""Share of the l4 dict wire's dispatches in the untraced stretch that
replayed a captured CUDA graph: `l4_graph_replays` over the replays and
the eager runs (`l4_graph_eager`), each dispatch counted once in one of
the two; None from a program without the counters."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_graph_replays" not in c1:
        return None
    replays = c1["l4_graph_replays"] - c0.get("l4_graph_replays", 0)
    eager = c1["l4_graph_eager"] - c0.get("l4_graph_eager", 0)
    if replays + eager <= 0:
        return None
    return 100.0 * replays / (replays + eager)
