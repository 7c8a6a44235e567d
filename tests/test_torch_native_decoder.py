"""The port's native TAGGEDFLOW decoder (decode/native.py, its own copy of
native_src/decoder.cc) against the JAX package's decoders, on the CPU.

Every case of the JAX package's `tests/test_native_decoder.py` runs as a
parity case: on the same `SyntheticAgent` records (or hand-built and
hostile payloads) the port's `decode_l4_payload` equals BOTH the JAX
package's Python decoder (`columnar.decode_l4_records`) and its native
decoder (`native.decode_l4_payload`), column for column, dtype for dtype
and bit for bit, with the same bad-record counts. `g++` builds the port's
library here at first use, into `build/deepflow_tpu_torch/`. Then the
`_Decoder` fast path (bad records counted, an exception falling through
to the record-list decode) against the JAX package's `_Decoder`, and the
port's `Ingester` with two l4 decoders fed TAGGEDFLOW frames against the
JAX package's `Ingester` (store rows, sketch leaves at each window close,
decoder counters: exact; the window outputs' cardinalities and entropies,
float readouts, within rtol 1e-5), with the native decoder and with
`native.available()` patched False (the Python decoder)."""

import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_pair as tp
from deepflow_tpu.decode import columnar as jcol
from deepflow_tpu.decode import native as jnative
from deepflow_tpu.pipelines import flow_log as jflow_log
from deepflow_tpu.replay.generator import SyntheticAgent
from deepflow_tpu.wire import framing as jframing
from deepflow_tpu.wire.codec import pack_pb_records as jpack
from deepflow_tpu.wire.gen import flow_log_pb2
from deepflow_tpu_torch.decode import columnar as tcol
from deepflow_tpu_torch.decode import native
from deepflow_tpu_torch.ops._build import BUILD_DIR
from deepflow_tpu_torch.pipelines import flow_log as tflow_log
from deepflow_tpu_torch.wire import FlowHeader, MessageType, encode_frame
from deepflow_tpu_torch.wire.codec import pack_pb_records
from deepflow_tpu_torch.wire.framing import Frame

REPO = Path(__file__).resolve().parent.parent


def _assert_cols(got, want, ctx=""):
    assert sorted(got) == sorted(want), ctx
    for name in want:
        assert got[name].dtype == want[name].dtype, (ctx, name)
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{ctx} {name}")


def _parity(payload, records=None, **kw):
    """The port's native decode of `payload` = the JAX native decode
    (columns and bad count), and = the JAX Python decoder on `records`
    when given; returns (columns, bad)."""
    assert jpack(records or []) == pack_pb_records(records or [])
    got, bad = native.decode_l4_payload(payload, **kw)
    jgot, jbad = jnative.decode_l4_payload(payload, **kw)
    assert bad == jbad
    _assert_cols(got, jgot, "jax native")
    if records is not None:
        _assert_cols(got, jcol.decode_l4_records(records), "jax python")
        _assert_cols(got, tcol.decode_l4_records(records), "port python")
    return got, bad


def test_builds_into_the_port_build_dir():
    """The port builds its own source into build/deepflow_tpu_torch/ (a
    name keyed by source, flags and host target), never the JAX
    package's; the C source below its header is the reference's, so the
    ABI and the walk are the same."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.so_path.parent == BUILD_DIR
    assert native.so_path.name.startswith("libnative_decoder-")
    assert REPO / "deepflow_tpu_torch" in native.SRC.parents
    ref = (REPO / "deepflow_tpu/decode/native_src/decoder.cc").read_text()
    own = native.SRC.read_text()
    assert own[own.index("#include"):] == ref[ref.index("#include"):]
    assert [n for n, _ in native.L4_COLS32] == \
        [n for n, _ in jnative.L4_COLS32]
    assert [n for n, _ in native.L4_COLS64] == \
        [n for n, _ in jnative.L4_COLS64]


def test_nothing_builds_at_import():
    code = ("import deepflow_tpu_torch.pipelines.flow_log\n"
            "from deepflow_tpu_torch.decode import native as n\n"
            "assert n._lib is None and n._build_error is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_failed_build_falls_back_and_logs_once(monkeypatch, tmp_path,
                                               caplog):
    """A source g++ refuses: available() False, build_error() says why,
    one WARNING however often it is asked, and the l4 decoders register
    no TAGGEDFLOW fast path (the Python decoder runs)."""
    bad = tmp_path / "decoder.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with caplog.at_level("WARNING", logger=native.__name__):
        assert not native.available()
        assert not native.available()
        assert native.build_error()
    warned = [r for r in caplog.records if r.name == native.__name__]
    assert len(warned) == 1, warned
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_l4_into(b"", np.empty((len(native.L4_COLS32), 1),
                                            np.uint32),
                              np.empty((len(native.L4_COLS64), 1),
                                       np.uint64))
    assert not list((tmp_path / "build").glob("*.so"))
    assert _fast_paths() == [False, False]


def _fast_paths():
    """Whether each l4 decoder of a fresh pipeline registered the native
    TAGGEDFLOW fast path."""
    from deepflow_tpu_torch.enrich.platform_data import PlatformDataManager
    from deepflow_tpu_torch.runtime.receiver import Receiver
    pipe = tflow_log.FlowLogPipeline(Receiver(port=0), None,
                                     PlatformDataManager(), n_decoders=2)
    return [d.payload_decode_fns.get(MessageType.TAGGEDFLOW)
            is native.decode_l4_payload
            for d in pipe.decoders if d.stream == "l4_flow_log"]


def test_l4_decoders_register_the_native_path():
    assert _fast_paths() == [True, True]


def test_parity_with_python_decoder():
    _, records = SyntheticAgent().l4_batch(500)
    got, bad = _parity(pack_pb_records(records), records)
    assert bad == 0 and len(got["ip_src"]) == 500


@pytest.mark.parametrize("capacity", [1, 64, 299, 300, 65536])
def test_capacity_chunking(capacity):
    _, records = SyntheticAgent().l4_batch(300)
    got, bad = _parity(pack_pb_records(records), records, capacity=capacity)
    assert bad == 0 and len(got["ip_src"]) == 300


@pytest.mark.parametrize("n_threads", [2, 4, 0])
def test_threaded_decode_matches(n_threads):
    """df_decode_l4_mt (its gaps compacted) = the serial walk = the
    Python decoder, with bad records spread over the threads' ranges."""
    _, records = SyntheticAgent(seed=3).l4_batch(2000)
    for i in (5, 700, 1999):
        records[i] = b"\xff\xff\xff garbage"
    payload = pack_pb_records(records)
    got, bad = _parity(payload, n_threads=n_threads)
    assert bad == 3
    _assert_cols(got, native.decode_l4_payload(payload)[0], "serial")
    good = [r for i, r in enumerate(records) if i not in (5, 700, 1999)]
    _assert_cols(got, jcol.decode_l4_records(good), "jax python")


def test_bad_records_skipped():
    _, records = SyntheticAgent().l4_batch(10)
    records[3] = b"\xff\xff\xff garbage"
    got, bad = _parity(pack_pb_records(records))
    assert bad == 1 and len(got["ip_src"]) == 9
    _assert_cols(got, jcol.decode_l4_records(records[:3] + records[4:]),
                 "jax python")


def test_truncated_payload():
    _, records = SyntheticAgent().l4_batch(5)
    got, bad = _parity(pack_pb_records(records)[:-7])
    assert bad == 1 and len(got["ip_src"]) == 4
    _assert_cols(got, jcol.decode_l4_records(records[:4]), "jax python")


def test_empty_payload():
    got, bad = _parity(b"", [])
    assert bad == 0 and len(got["ip_src"]) == 0


def test_v6_fold_agrees_across_paths():
    """Capture (the JAX agent), both Python wire decoders and both native
    decoders give the same class-E-confined u32 for one v6 address."""
    import struct

    from deepflow_tpu.agent.packet import decode_packets
    from deepflow_tpu.store.dict_store import fold_ipv6 as jfold
    from deepflow_tpu_torch.store.dict_store import fold_ipv6

    src16 = bytes(range(100, 116))
    dst16 = bytes(range(116, 132))
    tcp = struct.pack(">HHIIBBHHH", 443, 55000, 7, 0, 0x50, 0x10,
                      8192, 0, 0)
    ip6 = struct.pack(">IHBB", 0x60000000, len(tcp), 6, 64) \
        + src16 + dst16
    frame = b"\x02" * 6 + b"\x04" * 6 + b"\x86\xdd" + ip6 + tcp
    assert decode_packets([frame])["ip_src"][0] == fold_ipv6(src16) \
        == jfold(src16)
    d = flow_log_pb2.TaggedFlow()
    d.flow.flow_key.ip6_src = src16
    d.flow.flow_key.ip6_dst = dst16
    d.flow.flow_key.port_src = 443
    d.flow.flow_key.port_dst = 55000
    rec = d.SerializeToString()
    got, _ = _parity(pack_pb_records([rec]), [rec])
    assert got["ip_src"][0] == fold_ipv6(src16)
    assert got["ip_dst"][0] == fold_ipv6(dst16)
    buf32 = np.empty((len(native.L4_COLS32), 8), np.uint32)
    buf64 = np.empty((len(native.L4_COLS64), 8), np.uint64)
    rows, bad, _ = native.decode_l4_into(pack_pb_records([rec]), buf32,
                                         buf64)
    assert (rows, bad) == (1, 0)
    names32 = [n for n, _ in native.L4_COLS32]
    assert buf32[names32.index("ip_src"), 0] == fold_ipv6(src16)
    assert buf32[names32.index("ip_dst"), 0] == fold_ipv6(dst16)


def test_hash_cache_counters_match_across_paths():
    """The process-wide string-hash LRU: the Python decoders move both
    packages' counters alike (v6 folds hash through it); the native
    walkers hash in C++ and leave both untouched."""
    agent = SyntheticAgent(seed=9)
    records = []
    for i in range(64):
        d = flow_log_pb2.TaggedFlow()
        d.flow.flow_key.ip6_src = bytes([i % 8] * 16)
        d.flow.flow_key.ip6_dst = bytes([200 + i % 4] * 16)
        records.append(d.SerializeToString())
    records += agent.l4_batch(64)[1]
    tcol._fnv1a32_cached.cache_clear()
    jcol._fnv1a32_cached.cache_clear()
    tcol.decode_l4_records(records)
    jcol.decode_l4_records(records)
    t, j = tcol.hash_cache_counters(), jcol.hash_cache_counters()
    assert t == j and t["hash_cache_misses"] == 12, t
    _parity(pack_pb_records(records))
    assert tcol.hash_cache_counters() == t
    assert jcol.hash_cache_counters() == j


def test_round3_column_goldens():
    """Tunnel MACs, acl_gids, derived status / retrans_syn[ack] /
    l7_error: exact values through every decoder."""
    def rec(close_type, proto, syn=0, synack=0, gids=(),
            cli_err=0, srv_err=0):
        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        f.flow_key.proto = proto
        f.flow_key.ip_src = 1
        f.flow_key.ip_dst = 2
        f.close_type = close_type
        f.start_time = 1_000_000_000
        f.end_time = 2_000_000_000
        t = f.tunnel
        t.tx_mac0, t.tx_mac1 = 0x0000AABB, 0xCCDDEEFF
        t.rx_mac0, t.rx_mac1 = 0x00001122, 0x33445566
        f.acl_gids.extend(gids)
        if syn or synack or cli_err or srv_err:
            f.has_perf_stats = 1
            f.perf_stats.tcp.syn_count = syn
            f.perf_stats.tcp.synack_count = synack
            f.perf_stats.l7.err_client_count = cli_err
            f.perf_stats.l7.err_server_count = srv_err
        return m.SerializeToString()

    records = [
        rec(1, 6, syn=3, synack=2, gids=(7, 9)),   # FIN -> status 0
        rec(3, 6),                                 # TCP timeout -> 3
        rec(3, 17),                                # UDP timeout -> 0
        rec(2, 6, cli_err=2, srv_err=5),           # RST -> 3
    ]
    got, bad = _parity(pack_pb_records(records), records)
    assert bad == 0
    assert got["status"].tolist() == [0, 3, 0, 3]
    assert got["retrans_syn"].tolist() == [2, 0, 0, 0]
    assert got["retrans_synack"].tolist() == [1, 0, 0, 0]
    assert got["acl_gids"].tolist() == [7, 0, 0, 0]
    assert got["l7_error"].tolist() == [0, 0, 0, 7]
    assert got["tunnel_tx_mac"].tolist() == [0x0000AABBCCDDEEFF] * 4
    assert got["tunnel_rx_mac"].tolist() == [0x0000112233445566] * 4


def _hostile_payloads():
    rng = np.random.default_rng(0xFADE)
    _, real = SyntheticAgent().l4_batch(64)
    payloads = [rng.bytes(n) for n in (0, 1, 3, 4, 5, 64, 4096)]
    # a length prefix pointing past the end
    payloads.append((1 << 20).to_bytes(4, "little") + b"x" * 32)
    # real records with random corruption
    for _ in range(20):
        recs = list(real)
        for _ in range(8):
            i = int(rng.integers(0, len(recs)))
            b = bytearray(recs[i])
            if len(b):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            recs[i] = bytes(b)
        payloads.append(pack_pb_records(recs))
    whole = pack_pb_records(real)
    for cut in (1, 7, len(whole) // 3, len(whole) - 1):
        payloads.append(whole[:cut])
    return payloads


@pytest.mark.parametrize("threads", [1, 4])
def test_fuzz_hostile_payloads_match(threads):
    """Random bytes, corrupted records and pathological length prefixes
    never crash the port's walker, and its rows, bad counts and columns
    equal the JAX native decoder's on every payload."""
    for payload in _hostile_payloads():
        got, bad = _parity(payload, n_threads=threads)
        assert bad >= 0 and len(got["ip_src"]) <= 64


def _records(n, seed=0):
    agent = SyntheticAgent(seed=seed)
    base = agent.l4_columns(n)
    return [agent.l4_record(base, i) for i in range(n)]


def test_pipelined_decoder_matches_serial():
    """PipelinedDecoder yields the serial decode_l4_into's columns over a
    stream that cycles every ring slot several times, and a slow consumer
    never sees a held buffer overwritten."""
    recs = _records(512)
    payloads = [pack_pb_records(recs[i::8]) for i in range(8)] * 3
    n32, n64 = len(native.L4_COLS32), len(native.L4_COLS64)
    want = []
    b32 = np.empty((n32, 64), np.uint32)
    b64 = np.empty((n64, 64), np.uint64)
    j32, j64 = np.empty_like(b32), np.empty_like(b64)
    for p in payloads:
        rows, bad, _ = native.decode_l4_into(p, b32, b64)
        assert (rows, bad) == jnative.decode_l4_into(p, j32, j64)[:2]
        np.testing.assert_array_equal(b32[:, :rows], j32[:, :rows])
        np.testing.assert_array_equal(b64[:, :rows], j64[:, :rows])
        want.append((rows, b32[:, :rows].copy(), b64[:, :rows].copy()))
    dec = native.PipelinedDecoder(capacity=64, n_bufs=3)
    got_n = 0
    for (rows, g32, g64), (wr, w32, w64) in zip(
            dec.stream(iter(payloads)), want):
        time.sleep(0.002)    # slow consumer: the feeder runs ahead
        assert rows == wr
        np.testing.assert_array_equal(g32[:, :rows], w32)
        np.testing.assert_array_equal(g64[:, :rows], w64)
        got_n += 1
    assert got_n == len(payloads)


def test_pipelined_decoder_propagates_feeder_errors():
    dec = native.PipelinedDecoder(capacity=64)

    def gen():
        yield b"\x00\x01ok-this-will-decode-to-nothing"
        raise RuntimeError("payload source exploded")

    with pytest.raises(RuntimeError, match="payload source exploded"):
        for _ in dec.stream(gen()):
            pass
    with pytest.raises(ValueError):
        native.PipelinedDecoder(capacity=8, n_bufs=1)


def test_pipelined_decoder_reusable_after_abort_and_error():
    """An early break or a feeder error does not poison the next stream
    on the same decoder."""
    recs = _records(128)
    payloads = [pack_pb_records(recs[i::4]) for i in range(4)]
    dec = native.PipelinedDecoder(capacity=128, n_bufs=2)
    for n, _ in enumerate(dec.stream(iter(payloads))):
        if n == 1:
            break

    def gen():
        yield payloads[0]
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        for _ in dec.stream(gen()):
            pass
    got = [rows for rows, _, _ in dec.stream(iter(payloads))]
    assert got == [32, 32, 32, 32]


def _tagged_frames(seed=17, n=3072, per=256):
    """(frame, rows it decodes to) of a pooled TAGGEDFLOW stream from two
    vtaps, one frame with two garbage records and one whose payload is
    cut mid-record."""
    agent = SyntheticAgent(seed=seed, vtap_id=5)
    cols = agent.l4_columns_pooled(n, pool=256)
    recs = [agent.l4_record(cols, i) for i in range(n)]
    payloads = [pack_pb_records(recs[s:s + per]) for s in range(0, n, per)]
    bad = list(recs[per:2 * per])
    bad[10] = bad[200] = b"\xff\xff\xff garbage"
    payloads[1] = pack_pb_records(bad)
    payloads[5] = payloads[5][:-9]
    rows = [per] * len(payloads)
    rows[1], rows[5] = per - 2, per - 1
    # two vtap_ids: the receiver hashes them onto both decoders
    return [(encode_frame(MessageType.TAGGEDFLOW, p,
                          FlowHeader(sequence=i // 2 + 1,
                                     vtap_id=5 + i % 2)), r)
            for i, (p, r) in enumerate(zip(payloads, rows))]


def _decoder_pair(fast_tagged):
    """The l4 `_Decoder` of each package with the TAGGEDFLOW fast path
    registered as each pipeline does, called directly (no queue, store
    or exporter); each one's decoded chunks land in its list."""
    jfns = {jframing.MessageType.TAGGEDFLOW: jnative.decode_l4_payload}
    tfns = {MessageType.TAGGEDFLOW: fast_tagged}
    jgot, tgot = [], []
    j = jflow_log._Decoder("l4_flow_log", 0, None, jcol.decode_l4_records,
                           lambda c: jgot.append(c) or c, None, None, None,
                           payload_decode_fns=jfns)
    t = tflow_log._Decoder("l4_flow_log", 0, None, tcol.decode_l4_records,
                           lambda c: tgot.append(c) or c, None, None, None,
                           payload_decode_fns=tfns)
    return (j, jgot), (t, tgot)


@pytest.mark.parametrize("fast", ["native", "raises"])
def test_decoder_fast_path_counts_and_falls_through(fast):
    """TAGGEDFLOW frames with bad and truncated records through the
    `_Decoder`'s per-frame fast path: the same rows and decode_errors as
    the JAX package's decoder. A fast path that raises on a frame falls
    through to the record-list decode for it, with the same result."""
    def raises(payload):
        raise RuntimeError("walker refused")

    (j, jgot), (t, tgot) = _decoder_pair(
        native.decode_l4_payload if fast == "native" else raises)
    raw = b"".join(f for f, _ in _tagged_frames(n=1536))
    jf = list(jframing.FrameReader().feed(raw))
    tf = [Frame(MessageType.TAGGEDFLOW, None, x.payload) for x in jf]
    j.handle(jf)
    t.handle(tf)
    assert len(jgot) == len(tgot) == 1
    _assert_cols(tgot[0], jgot[0])
    assert t.counters() == j.counters() == {
        "frames": 6, "records": 1536 - 3, "decode_errors": 3}


# -- the port's Ingester against the JAX package's, two l4 decoders ------------

NOWS = (1000.0, 1001.0)


def _ingest(package, root, frames, python=False):
    """Build `package`'s ingester with two l4 decoders (the native fast
    path off when `python`), send the frames one at a time, each once the
    one before it is decoded and in the exporter (so every chunk reaches
    the sketch in frame order), close a window after each half; returns
    (snapshot leaves, outputs, decoder counters, fast paths, tables)."""
    with pytest.MonkeyPatch.context() as mp:
        if python:
            mp.setattr(native, "available", lambda: False)
        ing = tp.build(package, root, n_decoders=2,
                       tpu_sketch_window_s=3600, app_red_window_s=3600)
    decs = [d for d in ing.flow_log.decoders if d.stream == "l4_flow_log"]
    fast = [int(getattr(d.payload_decode_fns.get(int(
        MessageType.TAGGEDFLOW)), "__module__", "").endswith(".native"))
        for d in decs]
    snaps = []
    ing.tpu_sketch.snapshot_bus.subscribe(
        lambda s: snaps.append([np.asarray(a) for a in s.leaves]))
    ing.start()
    outs = []
    try:
        s = socket.create_connection(("127.0.0.1", ing.port))
        try:
            half = len(frames) // 2
            sent = 0
            for w, part in enumerate((frames[:half], frames[half:])):
                for f, rows in part:
                    sent += rows
                    s.sendall(f)
                    tp.wait(lambda: sum(d.records for d in decs) == sent,
                            "a frame decoded")
                    tp.wait(lambda: ing.tpu_sketch.rows_in == sent,
                            "exported")
                out = ing.tpu_sketch.flush_window(now=NOWS[w])
                outs.append([np.asarray(x) for x in out])
        finally:
            s.close()
        counters = sorted((d.counters() for d in decs),
                          key=lambda c: (c["frames"], c["records"]))
    finally:
        ing.close()
    return snaps, outs, counters, fast, tp.tables(root)


def _pinned(tables):
    out = {}
    for key, cols in tables.items():
        if key[0] == "tpu_sketch" and cols:
            keep = np.isin(cols["timestamp"], NOWS)
            cols = {k: v[keep] for k, v in cols.items()}
        out[key] = cols
    return out


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    frames = _tagged_frames()
    return {mode: _ingest(pkg, str(tmp_path_factory.mktemp(mode)), frames,
                          python=(mode == "port_python"))
            for pkg, mode in (("jax", "jax"), ("port", "port_native"),
                              ("port", "port_python"))}


@pytest.mark.parametrize("mode", ["port_native", "port_python"])
def test_ingester_two_decoders_matches_jax(ingested, mode):
    """Store rows, every sketch leaf at each window close (and the drain
    ladder's last checkpoint), the window outputs and the decoders'
    frames / records / decode_errors: the port (native fast path, or the
    Python decoder) = the JAX package's ingester with its native path."""
    ts, to, tc, tfast, tt = ingested[mode]
    js, jo, jc, jfast, jt = ingested["jax"]
    assert jfast == [1, 1]
    assert tfast == ([1, 1] if mode == "port_native" else [0, 0])
    assert len(ts) == len(js) == 3
    for a, b in zip(ts, js):
        assert len(a) == len(b) == 9
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a[0].view(np.uint32),
                                      b[0].view(np.uint32))
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a[3], b[3], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(a[4], b[4])
    assert tc == jc
    assert sum(c["decode_errors"] for c in tc) == 3
    assert sum(c["records"] for c in tc) == 3072 - 3
    assert min(c["frames"] for c in tc) > 0     # both decoders worked
    # close() writes one more sketch window at the wall clock: the
    # sketch tables are compared on the pinned windows
    # (their float readouts, the entropies, within rtol 1e-5)
    tp.assert_tables_equal(_pinned(tt), _pinned(jt),
                           loose=[("tpu_sketch", "window_signals")])
    assert len(tt[("flow_log", "l4_flow_log")]["_id"]) == 3072 - 3
