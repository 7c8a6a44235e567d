"""The port's disk spill (runtime/spill.py) against the JAX package's, on
the CPU.

The same seeded frames (random payloads, flow headers, several message
types) go through both packages: segment files are compared byte for
byte; each package replays the other's segments; a torn tail, the
budget eviction and the `spill.write` fault (each package's own
registry, armed with the same spec) give the same counters; and a
`SpillGroup` over the port's `MultiQueue` conserves every frame through
spill and replay."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from deepflow_tpu.runtime import faults as jfaults
from deepflow_tpu.runtime import queues as jqueues
from deepflow_tpu.runtime import spill as jspill
from deepflow_tpu_torch.runtime import faults as tfaults
from deepflow_tpu_torch.runtime import queues as tqueues
from deepflow_tpu_torch.runtime import spill as tspill
from deepflow_tpu_torch.wire import framing as tframing

TYPES = ("TAGGEDFLOW", "COLUMNAR_FLOW", "PROTOCOLLOG", "METRICS")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.default_faults().disarm()
    tfaults.default_faults().disarm()


def _blobs(seed, n):
    """n wire frames as bytes (the same in both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mt = tframing.MessageType[TYPES[int(rng.integers(len(TYPES)))]]
        payload = rng.integers(0, 256, int(rng.integers(1, 600)),
                               dtype=np.uint8).tobytes()
        fh = tframing.FlowHeader(sequence=i + 1,
                                 vtap_id=int(rng.integers(1, 9)))
        out.append(tframing.encode_frame(mt, payload, fh))
    return out


def _frames(mod, blobs):
    return [mod.decode_frame_blob(b) for b in blobs]


def _seg_files(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".seg"))


@pytest.mark.parametrize("seg_bytes,n", [(4096, 40), (8192, 200),
                                         (1 << 20, 64)])
def test_segments_byte_identical(tmp_path, seg_bytes, n):
    blobs = _blobs(seg_bytes + n, n)
    enc_t = [tspill.encode_frame_blob(f)
             for f in _frames(tspill, blobs)]
    enc_j = [jspill.encode_frame_blob(f)
             for f in _frames(jspill, blobs)]
    assert enc_t == enc_j == blobs
    dirs = {}
    for name, mod, enc in (("t", tspill, enc_t), ("j", jspill, enc_j)):
        d = str(tmp_path / name)
        st = mod.SegmentStore(d, name="q", segment_bytes=seg_bytes,
                              budget_bytes=64 << 20)
        for i in range(0, n, 7):
            assert st.append(enc[i:i + 7]) == (len(enc[i:i + 7]), 0)
        st.close()
        dirs[name] = d
    ft, fj = _seg_files(dirs["t"]), _seg_files(dirs["j"])
    assert ft == fj and ft
    for f in ft:
        with open(os.path.join(dirs["t"], f), "rb") as a, \
                open(os.path.join(dirs["j"], f), "rb") as b:
            assert a.read() == b.read()
    # each package reads the other's files
    for f in ft:
        rt = tspill.read_segment(os.path.join(dirs["j"], f))
        rj = jspill.read_segment(os.path.join(dirs["t"], f))
        assert rt == rj and not rt[1]


def _replay(mod, qmod, directory, cap=4096, timeout=20):
    """A fresh SpillQueue on `directory` replays its segments into a
    new ring; returns (frames taken, counters)."""
    q = qmod.OverwriteQueue("replay", cap)
    sq = mod.SpillQueue(q, directory)
    sq.start()
    got = []
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            got.extend(q.gets(256, timeout=0.05))
            if sq.store.pending()[0] == 0 and len(q) == 0 and got:
                break
    finally:
        sq.close()
    got.extend(q.gets(4096, timeout=0.01))
    return got, sq.counters()


def test_each_package_replays_the_others_segments(tmp_path):
    blobs = _blobs(11, 300)
    for writer, reader, rq in (("t", jspill, jqueues),
                               ("j", tspill, tqueues)):
        src = tspill if writer == "t" else jspill
        d = str(tmp_path / writer)
        st = src.SegmentStore(d, name="q", segment_bytes=8192)
        st.append(blobs)
        st.close()
        got, c = _replay(reader, rq, d)
        assert [reader.encode_frame_blob(f) for f in got] == blobs
        assert c["replayed"] == len(blobs) and c["torn_segments"] == 0
        assert c["pending_segments"] == 0 and c["decode_errors"] == 0


@pytest.mark.parametrize("cut", [1, 5, 9, 300])
def test_torn_tail_same_counters(tmp_path, cut):
    blobs = _blobs(cut, 50)
    out = {}
    for name, mod, qmod in (("t", tspill, tqueues), ("j", jspill, jqueues)):
        d = str(tmp_path / name)
        st = mod.SegmentStore(d, name="q", segment_bytes=1 << 20)
        st.append(blobs)
        st.close()
        (seg,) = _seg_files(d)
        p = os.path.join(d, seg)
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(size - cut)
        records, torn = mod.read_segment(p)
        got, c = _replay(mod, qmod, d)
        out[name] = (len(records), torn, len(got), c)
    assert out["t"] == out["j"]
    assert out["t"][1] and out["t"][3]["torn_segments"] == 1
    assert out["t"][2] == out["t"][0] < len(blobs)


@pytest.mark.parametrize("budget", [4096, 12288, 40000])
def test_budget_eviction_same_counters(tmp_path, budget):
    blobs = _blobs(budget, 400)
    res = {}
    for name, mod in (("t", tspill), ("j", jspill)):
        st = mod.SegmentStore(str(tmp_path / name), name="q",
                              segment_bytes=4096, budget_bytes=budget)
        evicted = 0
        for i in range(0, len(blobs), 13):
            w, e = st.append(blobs[i:i + 13])
            evicted += e
        res[name] = (evicted, st.pending(),
                     _seg_files(str(tmp_path / name)))
        st.close()
    assert res["t"] == res["j"] and res["t"][0] > 0


def _sink_run(mod, qmod, registry, d, blobs, spec):
    registry.arm_spec(spec)
    q = qmod.OverwriteQueue("ingest.x.0", 64)
    sq = mod.SpillQueue(q, d, segment_bytes=4096, watermark=0.5)
    q.spill_arm(sq._sink, sq._mark)
    frames = _frames(mod, blobs)
    for i in range(0, len(frames), 10):
        q.puts(frames[i:i + 10])
    q.spill_disarm()
    sq.store.close()
    c = sq.counters()
    registry.disarm()
    return c, q.counters(), _seg_files(d)


@pytest.mark.parametrize("spec", ["spill.write:count=1;seed=3",
                                  "spill.write:p=0.5;seed=9",
                                  "spill.write:after=3,count=2;seed=1"])
def test_spill_write_fault_same_counters(tmp_path, spec):
    blobs = _blobs(5, 400)
    ct = _sink_run(tspill, tqueues, tfaults.default_faults(),
                   str(tmp_path / "t"), blobs, spec)
    cj = _sink_run(jspill, jqueues, jfaults.default_faults(),
                   str(tmp_path / "j"), blobs, spec)
    assert ct == cj
    c, qc, _ = ct
    assert c["spill_write_errors"] > 0
    # every frame is in the ring, on disk or counted lost
    assert qc["pending"] + c["spilled_records"] + c["spill_evicted"] \
        == len(blobs)
    assert qc["spilled"] == c["spilled_records"] + c["spill_evicted"]


def test_spill_group_conserves_rows(tmp_path):
    """A MultiQueue of 2 rings of 32 armed at half capacity; a producer
    puts 600 frames while a consumer drains slowly: every frame comes
    out exactly once, through the ring or the spill's replay."""
    blobs = _blobs(17, 600)
    frames = _frames(tspill, blobs)
    mq = tqueues.MultiQueue("ingest.l4_flow_log", 2, 32)
    group = tspill.SpillGroup({mq.name: mq}, str(tmp_path / "spill"),
                              segment_bytes=4096, watermark=0.5)
    group.start()
    got = []
    stop = threading.Event()

    def consume():
        while not stop.is_set() or len(mq) or group.pending_segments():
            for i in range(2):
                got.extend(mq.gets(i, 4, timeout=0.01))
            time.sleep(0.002)

    th = threading.Thread(target=consume)
    th.start()
    try:
        for i in range(0, len(frames), 20):
            for k, f in enumerate(frames[i:i + 20]):
                mq.put(f.flow_header.vtap_id, f)
    finally:
        deadline = time.monotonic() + 30
        while (group.pending_segments() or len(mq)) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        stop.set()
        th.join(timeout=30)
        group.close()
    c = group.counters()
    assert c["spilled_records"] > 0
    assert c["replayed"] == c["spilled_records"]
    assert c["spill_evicted"] == 0 and c["pending_segments"] == 0
    assert sorted(tspill.encode_frame_blob(f) for f in got) == sorted(blobs)
    qc = mq.counters()
    assert qc["overwritten"] == 0
    assert set(group.per_queue()) == {q.name for q in mq.queues}
    shutil.rmtree(str(tmp_path / "spill"))
