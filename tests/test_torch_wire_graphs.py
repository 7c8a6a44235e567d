"""The dict wire's programs replayed from CUDA graphs
(runtime/wire_graphs.py).

On the CPU every program runs eagerly and is counted so, and a window's
output owns its row count. Tests marked `card` skip without a CUDA card;
on the card (`python3 -m pytest tests/test_torch_wire_graphs.py -m
card`) they hold the replayed exporter to the eager one bit for bit."""

import numpy as np
import pytest
import torch

from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.runtime import wire_graphs
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
from deepflow_tpu_torch.runtime.tracing import default_tracer

_SMALL = dict(cms_log2_width=12, ring_size=64, top_k=10, hll_groups=32,
              hll_precision=8, entropy_log2_buckets=10)
_MODES = {
    "zero_copy": dict(prefetch_depth=2),
    "tensorbatch": dict(prefetch_depth=2, zero_copy=False),
    "inline": dict(),
}
_GRAPH_COUNTERS = ("l4_graph_captures", "l4_graph_replays",
                   "l4_graph_eager", "l4_graph_capture_failures")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs capture on the card only")
    return torch.cuda.get_device_name(0)


def _zipf_stream(seed, windows, rows, chunk, pool=4096):
    """`windows` lists of chunks of l4 columns: records drawn from a pool
    of 5-tuples by Zipf(1.1) over rank, 1% new tuples, u32 edge values in
    the pool."""
    rng = np.random.default_rng(seed)
    u32 = np.uint32

    def tuples(n):
        t = {"ip_src": rng.integers(0, 1 << 32, n, dtype=np.uint64),
             "ip_dst": rng.integers(0, 1 << 32, n, dtype=np.uint64),
             "port_src": rng.integers(0, 1 << 16, n),
             "port_dst": rng.integers(0, 1 << 16, n),
             "proto": rng.choice([6, 17, 1, 255], n)}
        return {k: v.astype(u32) for k, v in t.items()}

    base = tuples(pool)
    base["ip_src"][:2] = [0, 0xFFFFFFFF]
    base["port_dst"][:2] = [0, 0xFFFF]
    out = []
    for _ in range(windows):
        rank = np.minimum(rng.zipf(1.1, rows), pool) - 1
        cols = {k: v[rank] for k, v in base.items()}
        fresh = rng.random(rows) < 0.01
        new = tuples(int(fresh.sum()))
        for k in cols:
            cols[k][fresh] = new[k]
        cols["packet_tx"] = rng.integers(1, 70000, rows).astype(u32)
        cols["packet_rx"] = rng.integers(0, 40, rows).astype(u32)
        out.append([{k: v[s:s + chunk] for k, v in cols.items()}
                    for s in range(0, rows, chunk)])
    return out


def _feed(exp, chunks):
    for c in chunks:
        exp.process([("l4_flow_log", 0, c, -1)])


def _subscribe(exp):
    snaps = []
    exp.snapshot_bus.subscribe(lambda s: snaps.append(
        [np.asarray(a) for a in s.leaves]))
    return snaps


def _restore(exp):
    """A device-state restore between windows, as the device-error
    ladder makes one: the newest snapshot into fresh tensors, a fresh
    dict table and packer."""
    with exp._state_lock:
        if exp._feed is not None:
            assert exp._feed.drain(timeout=60)
        exp._restore_device_state_locked()


# -- on the CPU ---------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cpu_runs_every_program_eagerly(mode):
    """On the CPU the dict wire never captures: every dispatch counts in
    `l4_graph_eager`, and the window rows add up to the records put."""
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                            batch_rows=512, window_seconds=3600,
                            device="cpu", **_MODES[mode])
    try:
        sent = rows = 0
        for chunks in _zipf_stream(7, windows=2, rows=1500, chunk=700):
            _feed(exp, chunks)
            sent += sum(len(c["ip_src"]) for c in chunks)
            rows += int(exp.flush_window().rows)
        c = exp.counters()
        assert rows == sent == exp.rows_in
        assert c["l4_graph_eager"] == c["dispatches"] > 0
        assert c["l4_graph_captures"] == c["l4_graph_replays"] == 0
        assert c["l4_graph_capture_failures"] == 0
    finally:
        exp.close()


def test_graph_counters_only_on_the_dict_wire():
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                            batch_rows=512, window_seconds=3600,
                            wire="lanes", prefetch_depth=2, device="cpu")
    try:
        assert not set(_GRAPH_COUNTERS) & set(exp.counters())
    finally:
        exp.close()


def test_window_output_owns_its_rows():
    """`flush` hands out a copy of the row counter: updating the state's
    own tensor afterwards (as a replay into the static set does) leaves
    the output alone; the exporter's output does not alias its state."""
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    state = flow_suite.init(cfg, "cpu")
    plane = torch.zeros(4, 512, dtype=torch.int32)
    state = flow_suite.update_lane_plane(state, plane, 300, cfg)
    _, out = flow_suite.flush(state, cfg)
    assert int(out.rows) == 300
    assert out.rows.untyped_storage().data_ptr() != \
        state.rows_seen.untyped_storage().data_ptr()
    state.rows_seen.add_(5)
    assert int(out.rows) == 300

    exp = TpuSketchExporter(cfg=cfg, batch_rows=512, window_seconds=3600,
                            prefetch_depth=2, device="cpu")
    try:
        (chunks,) = _zipf_stream(3, windows=1, rows=900, chunk=450)
        _feed(exp, chunks)
        before = exp.state.rows_seen
        out = exp.flush_window()
        assert int(out.rows) == 900
        assert out.rows.untyped_storage().data_ptr() != \
            before.untyped_storage().data_ptr()
    finally:
        exp.close()


def test_state_leaves_round_trip():
    """The static set's flattening: every tensor of the suite state and
    the dict state once, in order, and back into the same structure."""
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    state = flow_suite.init(cfg, "cpu")
    dstate = flow_dict.init_dict(1024, "cpu")
    leaves = wire_graphs._leaves(state) + wire_graphs._leaves(dstate)
    assert len(leaves) == 10 and leaves[-1] is dstate.table
    copies = [t.clone() for t in leaves]
    it = iter(copies)
    s2, d2 = wire_graphs._rebuild(state, it), wire_graphs._rebuild(dstate, it)
    assert isinstance(s2, flow_suite.FlowSuiteState)
    assert s2.ring.keys is copies[2] and d2.table is copies[9]
    assert all(torch.equal(a, b) for a, b in zip(
        wire_graphs._leaves(s2) + wire_graphs._leaves(d2), leaves))


def test_split_launch_arguments_are_planned_by_what_they_are():
    """A split-off kernel call's arguments: views of the static input
    become the same views of each group's input, static tensors pass as
    they are, a computed plane is copied per launch, a host value passes
    as it is; a kernel output that is not static refuses the capture."""
    g = wire_graphs.WireGraphs(None)
    flat = torch.arange(40, dtype=torch.int32)
    counts = torch.zeros(4, 8, dtype=torch.int32)
    computed = torch.ones(4, 8, dtype=torch.int32)
    static = {counts.untyped_storage().data_ptr()}
    args = (flat[10:34].view(4, 6), flat[2:3], counts, counts, computed, 2)
    plans = [g._plan(i, a, flat, static) for i, a in enumerate(args)]
    assert [p[0] for p in plans] == ["input", "input", "static", "static",
                                     "copy", "value"]
    group = torch.arange(100, 140, dtype=torch.int32)
    got = [wire_graphs._arg(p, group) for p in plans]
    assert torch.equal(got[0], group[10:34].view(4, 6))
    assert torch.equal(got[1], group[2:3])
    assert got[2] is counts and got[5] == 2
    assert torch.equal(got[4], computed) and got[4] is not computed
    with pytest.raises(ValueError, match="static"):
        g._plan(3, computed, flat, static)


def test_cpu_wire_graphs_count_eager_sightings():
    """Without a CUDA stream every sighting, the capturing one included,
    runs the program eagerly."""
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    sig = (("hits", 256),)
    prog = flow_dict.make_wire_update(cfg, sig)
    g = wire_graphs.WireGraphs(None)
    state = flow_suite.init(cfg, "cpu")
    dstate = flow_dict.init_dict(1024, "cpu")
    flat = torch.zeros(flow_dict.wire_words(sig), dtype=torch.int32)
    flat[0] = 100
    for _ in range(3):
        state, dstate = g.run(sig, prog, state, dstate, flat)
    assert int(state.rows_seen) == 300
    assert g.counters() == {"l4_graph_captures": 0, "l4_graph_replays": 0,
                            "l4_graph_eager": 3,
                            "l4_graph_capture_failures": 0}


# -- on the card ----------------------------------------------------------------
def _card_exporter(tmp_path, name, mode, eager):
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(),
                            batch_rows=1 << 13, window_seconds=3600,
                            checkpoint_dir=str(tmp_path / name),
                            **_MODES[mode])
    # a small program cache, so that it and the graphs clear mid-stream
    exp._PROGRAM_CACHE_CAP = 2
    if eager:
        exp._graphs.CAPTURE_AT = 1 << 30
    return exp


@pytest.mark.card
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_replay_equals_eager_bit_for_bit(card, tmp_path, mode):
    """A zipf stream over 4 windows through a replaying exporter and an
    eager twin, the tracer on: every state leaf each window published,
    every output, the dict table and the counters equal bit for bit,
    across window flushes, a state restore between windows 2 and 3
    (a rebind), close-time partial signatures and program-cache
    clears."""
    tracer = default_tracer()
    was_on = tracer.enabled
    tracer.enable()
    graph = _card_exporter(tmp_path, "graph", mode, eager=False)
    eager = _card_exporter(tmp_path, "eager", mode, eager=True)
    try:
        snaps = [_subscribe(graph), _subscribe(eager)]
        stream = _zipf_stream(0xC0DE, windows=4, rows=40000, chunk=4096)
        for w, chunks in enumerate(stream):
            outs = []
            for exp in (graph, eager):
                _feed(exp, chunks)
                outs.append(exp.flush_window())
            torch.cuda.synchronize()
            for a, b in zip(*outs):
                assert torch.equal(a.cpu(), b.cpu())
            assert len(snaps[0][-1]) == 9
            for a, b in zip(snaps[0][-1], snaps[1][-1]):
                np.testing.assert_array_equal(a, b)
            assert torch.equal(graph._dict_state.table.cpu(),
                               eager._dict_state.table.cpu())
            if w == 1:
                _restore(graph)
                _restore(eager)
        assert len(snaps[0]) == len(snaps[1]) == 4
        cg, ce = graph.counters(), eager.counters()
        for k in ("rows_in", "batches", "dispatches", "h2d_bytes",
                  "lost_rows", "device_errors", "restores"):
            assert cg[k] == ce[k], k
        assert cg["lost_rows"] == 0 and cg["device_errors"] == 0
        assert cg["l4_graph_capture_failures"] == 0
        assert cg["l4_graph_captures"] > len(graph._graphs._replays)
        assert cg["l4_graph_replays"] > 0
        assert cg["l4_graph_replays"] + cg["l4_graph_eager"] \
            == cg["dispatches"]
        assert ce["l4_graph_eager"] == ce["dispatches"]
        assert ce["l4_graph_replays"] == 0
    finally:
        graph.close()
        eager.close()
        if not was_on:
            tracer.disable()


@pytest.mark.card
def test_a_failed_capture_runs_eagerly_and_is_no_device_error(card):
    """A program that reads a device value on the host cannot be
    captured: the capture ends cleanly, the signature runs eagerly from
    then on, and a later signature still captures and replays."""
    dev = torch.device("cuda")
    stream = torch.cuda.Stream(dev)
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    g = wire_graphs.WireGraphs(stream)

    def syncing(state, dstate, flat):
        n = int(flat[0])        # a host read: refused inside a capture
        return state._replace(rows_seen=state.rows_seen + n), dstate, n

    good_sig = (("hits", 256),)
    good = flow_dict.make_wire_update(cfg, good_sig)
    with torch.cuda.stream(stream):
        state = flow_suite.init(cfg, dev)
        dstate = flow_dict.init_dict(1024, dev)
        flat = torch.zeros(flow_dict.wire_words(good_sig),
                           dtype=torch.int32, device=dev)
        flat[0] = 7
        for _ in range(3):
            state, dstate = g.run("sync", syncing, state, dstate, flat)
        assert g.capture_failures == 1 and g.eager == 3
        # the stream allocates from the device's own pool again
        probe = torch.empty(1 << 22, dtype=torch.uint8, device=dev)
        ptr = probe.data_ptr()
        for seg in torch.cuda.memory_snapshot():
            if seg["address"] <= ptr < seg["address"] + seg["total_size"] \
                    and "segment_pool_id" in seg:
                assert tuple(seg["segment_pool_id"]) == (0, 0)
        for _ in range(3):
            state, dstate = g.run(good_sig, good, state, dstate, flat)
        torch.cuda.synchronize()
    assert int(state.rows_seen.cpu()) == 6 * 7
    assert g.counters() == {"l4_graph_captures": 1, "l4_graph_replays": 2,
                            "l4_graph_eager": 4,
                            "l4_graph_capture_failures": 1}
