"""The reader of the dict wire's graph replay counters."""

import pytest

from harness.run_cell import RunData, _load_reader


def _run(c0, c1):
    return RunData(trace=None, slice_counters=(c0, c1),
                   stretch_counters=(c0, c1), stretch_s=1.0,
                   stretch_closes_ms=[], launches={}, config={},
                   device_name="x")


@pytest.mark.parametrize("c0,c1,want", [
    ({"l4_graph_replays": 10, "l4_graph_eager": 5},
     {"l4_graph_replays": 100, "l4_graph_eager": 15}, 90.0),
    # counters first seen inside the stretch count from zero
    ({}, {"l4_graph_replays": 3, "l4_graph_eager": 1}, 75.0),
    ({"l4_graph_replays": 4, "l4_graph_eager": 4},
     {"l4_graph_replays": 4, "l4_graph_eager": 6}, 0.0),
])
def test_graph_replay_share(c0, c1, want):
    reader = _load_reader("graph_replay_share.l4")
    assert reader.read(_run(c0, c1)) == pytest.approx(want)


def test_graph_replay_share_none():
    """None from a program without the counters (the parent of the
    change that added them) and when no dict-wire dispatch was made."""
    reader = _load_reader("graph_replay_share.l4")
    old = {"batches": 5, "dispatches": 5}
    assert reader.read(_run(old, {"batches": 9, "dispatches": 9})) is None
    still = {"l4_graph_replays": 7, "l4_graph_eager": 2}
    assert reader.read(_run(still, dict(still))) is None
