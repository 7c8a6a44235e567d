"""The port's wire modules (deepflow_tpu_torch/wire/) against the JAX
package's: frame bytes, stream reassembly at every split offset, record
packing, the planar columnar payload and the protobuf copies. Every
input is drawn from a numpy seed; bytes compare exactly."""

import numpy as np
import pytest

from deepflow_tpu.batch import schema as jschema
from deepflow_tpu.wire import codec as jcodec
from deepflow_tpu.wire import columnar_wire as jcw
from deepflow_tpu.wire import framing as jfr
from deepflow_tpu.wire.gen import flow_log_pb2 as jflow_pb2
from deepflow_tpu.wire.gen import metric_pb2 as jmetric_pb2
from deepflow_tpu_torch.batch import schema as tschema
from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
from deepflow_tpu_torch.wire import codec as tcodec
from deepflow_tpu_torch.wire import columnar_wire as tcw
from deepflow_tpu_torch.wire import framing as tfr
from deepflow_tpu_torch.wire.gen import flow_log_pb2 as tflow_pb2
from deepflow_tpu_torch.wire.gen import metric_pb2 as tmetric_pb2


def _records(rng, n, lo=0, hi=300):
    return [rng.integers(0, 256, int(rng.integers(lo, hi)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _l4_cols(rng, n):
    """Every L4_SCHEMA column, full-range values of its dtype."""
    cols = {}
    for name, dt in jschema.L4_SCHEMA.columns:
        dt = np.dtype(dt)
        info = np.iinfo(dt)
        cols[name] = rng.integers(info.min, info.max, n, dtype=dt,
                                  endpoint=True)
    return cols


def test_constants_and_message_types_match():
    assert tfr.MESSAGE_FRAME_SIZE_MAX == jfr.MESSAGE_FRAME_SIZE_MAX == 512_000
    assert tfr.FLOW_HEADER_RETRANSMIT == jfr.FLOW_HEADER_RETRANSMIT
    assert {m.name: int(m) for m in tfr.MessageType} == \
        {m.name: int(m) for m in jfr.MessageType}
    assert [m.has_flow_header for m in tfr.MessageType] == \
        [m.has_flow_header for m in jfr.MessageType]


@pytest.mark.parametrize("msg", ["TAGGEDFLOW", "PROTOCOLLOG", "METRICS",
                                 "COLUMNAR_FLOW", "SYSLOG", "STATSD"])
def test_encode_frame_bytes_match(msg):
    rng = np.random.default_rng(11)
    payload = tcodec.pack_pb_records(_records(rng, 20))
    seq, vtap = int(rng.integers(0, 1 << 63)), int(rng.integers(0, 1 << 16))
    t = tfr.encode_frame(tfr.MessageType[msg], payload,
                         tfr.FlowHeader(sequence=seq, vtap_id=vtap))
    j = jfr.encode_frame(jfr.MessageType[msg], payload,
                         jfr.FlowHeader(sequence=seq, vtap_id=vtap))
    assert t == j
    if tfr.MessageType[msg].has_flow_header:
        assert tfr.set_retransmit(t) == jfr.set_retransmit(j)
        assert tfr.set_retransmit(tfr.set_retransmit(t)) == \
            tfr.set_retransmit(t)


def test_frame_limit_raises_in_both():
    big = b"\0" * (tfr.MESSAGE_FRAME_SIZE_MAX - tfr.MESSAGE_HEADER_LEN
                   - tfr.FLOW_HEADER_LEN + 1)
    for fr in (tfr, jfr):
        with pytest.raises(ValueError, match="too large"):
            fr.encode_frame(fr.MessageType.TAGGEDFLOW, big)
        fr.encode_frame(fr.MessageType.TAGGEDFLOW, big[:-1])


def test_frame_reader_every_split_offset():
    """One stream of mixed frames, split in two at every offset (and in
    seeded random pieces): both readers give the same frames."""
    rng = np.random.default_rng(12)
    stream = b""
    for i, msg in enumerate(["TAGGEDFLOW", "SYSLOG", "METRICS",
                             "COLUMNAR_FLOW", "PROTOCOLLOG"]):
        stream += tfr.encode_frame(
            tfr.MessageType[msg],
            tcodec.pack_pb_records(_records(rng, 3, hi=40)),
            tfr.FlowHeader(sequence=i + 1, vtap_id=9))

    def frames(mod, pieces):
        r = mod.FrameReader()
        return [(int(f.msg_type), None if f.flow_header is None else
                 (f.flow_header.version, f.flow_header.sequence,
                  f.flow_header.vtap_id), f.payload)
                for p in pieces for f in r.feed(p)]

    want = frames(jfr, [stream])
    assert len(want) == 5
    for cut in range(len(stream) + 1):
        pieces = [stream[:cut], stream[cut:]]
        assert frames(tfr, pieces) == want
    cuts = np.sort(rng.integers(0, len(stream), 30))
    pieces = [stream[a:b] for a, b in
              zip(np.r_[0, cuts], np.r_[cuts, len(stream)])]
    assert frames(tfr, pieces) == frames(jfr, pieces) == want


@pytest.mark.parametrize("bad", ["size", "type", "short"])
def test_frame_reader_rejects_like_jax(bad):
    base = tfr.encode_frame(tfr.MessageType.TAGGEDFLOW, b"abc")
    buf = bytearray(base)
    if bad == "size":
        buf[0:4] = (tfr.MESSAGE_FRAME_SIZE_MAX + 1).to_bytes(4, "big")
    elif bad == "type":
        buf[4] = 99
    else:
        buf[0:4] = (7).to_bytes(4, "big")
    errs = []
    for mod in (tfr, jfr):
        with pytest.raises(ValueError) as e:
            list(mod.FrameReader().feed(bytes(buf)))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_pb_records_round_trip():
    rng = np.random.default_rng(13)
    recs = _records(rng, 50) + [b""]
    packed = tcodec.pack_pb_records(recs)
    assert packed == jcodec.pack_pb_records(recs)
    assert list(tcodec.iter_pb_records(packed)) == recs
    for broken in (packed[:-1], packed + b"\1"):
        with pytest.raises(ValueError):
            list(tcodec.iter_pb_records(broken))
        with pytest.raises(ValueError):
            list(jcodec.iter_pb_records(broken))


def test_columnar_payload_matches_jax():
    rng = np.random.default_rng(14)
    cols = _l4_cols(rng, 777)
    assert tschema.L4_SCHEMA.columns == jschema.L4_SCHEMA.columns
    assert tschema.L7_SCHEMA.columns == jschema.L7_SCHEMA.columns
    assert len(tschema.L4_SCHEMA.columns) == 104
    assert len(tschema.L7_SCHEMA.columns) == 73
    assert tcw.schema_hash(tschema.L4_SCHEMA) == \
        jcw.schema_hash(jschema.L4_SCHEMA)
    assert tcw.schema_hash(tschema.L7_SCHEMA) == \
        jcw.schema_hash(jschema.L7_SCHEMA)
    payload = tcw.encode_columnar(cols)
    assert payload == jcw.encode_columnar(cols)
    got, bad = tcw.decode_columnar(payload)
    assert bad == 0
    for name, dt in tschema.L4_SCHEMA.columns:
        assert got[name].dtype == np.dtype(dt)
        np.testing.assert_array_equal(got[name], cols[name])
    # a 512,000-byte frame holds about 1,100 L4 rows
    per = (tfr.MESSAGE_FRAME_SIZE_MAX - tfr.MESSAGE_HEADER_LEN
           - tfr.FLOW_HEADER_LEN - tcw.HEADER_LEN) \
        // tschema.L4_SCHEMA.row_bytes()
    assert 1100 <= per <= 1150
    tfr.encode_frame(tfr.MessageType.COLUMNAR_FLOW, tcw.encode_columnar(
        {k: v[:per] for k, v in _l4_cols(rng, per).items()}))


def test_columnar_plane_and_rejects_match_jax():
    rng = np.random.default_rng(15)
    sk = {n: rng.integers(0, 1 << 32, 100, dtype=np.uint32)
          for n, _ in SKETCH_L4_SCHEMA.columns}
    sk["l3_epc_id"] = sk["l3_epc_id"].view(np.int32)
    p = tcw.encode_columnar(sk, SKETCH_L4_SCHEMA)
    assert p == jcw.encode_columnar(sk, jschema.SKETCH_L4_SCHEMA)
    tp, tb = tcw.decode_columnar_plane(p, SKETCH_L4_SCHEMA)
    jp, jb = jcw.decode_columnar_plane(p, jschema.SKETCH_L4_SCHEMA)
    assert tb == jb == 0
    np.testing.assert_array_equal(tp, jp)
    with pytest.raises(ValueError):
        tcw.decode_columnar_plane(p, tschema.L4_SCHEMA)
    for broken in (p[:-4], b"\0" * 8, p[:4] + b"\0\0" + p[6:]):
        tc, tbad = tcw.decode_columnar(broken, SKETCH_L4_SCHEMA)
        jc, jbad = jcw.decode_columnar(broken, jschema.SKETCH_L4_SCHEMA)
        assert tbad == jbad == 1
        assert all(len(v) == 0 for v in tc.values())


def test_pb2_copies_are_the_reference_bytes_and_import_together():
    """Both packages' pb2 modules share one descriptor in protobuf's
    default pool, so one message serializes to the same bytes."""
    assert tflow_pb2.DESCRIPTOR.serialized_pb == \
        jflow_pb2.DESCRIPTOR.serialized_pb
    assert tmetric_pb2.DESCRIPTOR.serialized_pb == \
        jmetric_pb2.DESCRIPTOR.serialized_pb
    rng = np.random.default_rng(16)
    flow_id = int(rng.integers(0, 1 << 62))
    tm, jm = tflow_pb2.TaggedFlow(), jflow_pb2.TaggedFlow()
    for m in (tm, jm):
        m.flow.flow_key.ip_src = 0x0A000001
        m.flow.flow_key.ip6_dst = bytes(range(16))
        m.flow.flow_id = flow_id
        m.flow.metrics_peer_src.l3_epc_id = -2
        m.flow.acl_gids.extend([3, 4])
    assert tm.SerializeToString() == jm.SerializeToString()
    td, jd = tmetric_pb2.Document(), jmetric_pb2.Document()
    for d in (td, jd):
        d.timestamp = 1_700_000_000
        d.tag.code = 0x1 | (1 << 42)
        d.tag.field.ip = b"\x0a\0\0\1"
        d.meter.flow.traffic.packet_tx = 12
    assert td.SerializeToString() == jd.SerializeToString()
    assert tflow_pb2.TaggedFlow.FromString(jm.SerializeToString()) == tm
