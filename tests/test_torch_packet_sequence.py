"""The port's packet-sequence path against the JAX package's, on the CPU:
`agent/packet_sequence.decode_blocks`/`decode_entries` on blocks built
by the JAX package's `PacketSequenceCollector` from seeded packets, the
`l4_packet` rows both packages' `Ingester` store from the same
PACKETSEQUENCE frames, the sidecar blob files byte for byte (each row's
batch read back through (batch_off, batch_len)), and the blob pruning
that follows expired partitions."""

import os
import struct
import time

import numpy as np
import pytest

from deepflow_tpu.agent import packet_sequence as jps
from deepflow_tpu_torch.agent import packet_sequence as tps
from deepflow_tpu_torch.wire import FlowHeader, MessageType, encode_frame

import torch_pair as tp

# block times a few seconds behind the wall clock at import, so the rows
# land in a live partition (both ingesters get the same frames)
T0_NS = (int(time.time()) - 30) * 1_000_000_000


def pseq_blocks(n_flows, seed=91, t0_ns=T0_NS):
    """Blocks for n_flows flows from the JAX collector: seeded packets
    (seq, ack, flags, window, payload length, direction), some flows long
    enough to hit the 255-packet block cap, then a forced flush."""
    rng = np.random.default_rng(seed)
    c = jps.PacketSequenceCollector()
    n = n_flows * 6 + 600
    fids = rng.integers(1, 1 << 62, n_flows, dtype=np.uint64)
    pick = np.concatenate([np.arange(n_flows),
                           rng.integers(0, n_flows, n - n_flows)])
    pick[-600:] = 0            # one long flow
    ts = np.sort(t0_ns + rng.integers(0, 3_000_000_000, n)).astype(
        np.uint64)
    blocks = c.observe(
        fids[pick], ts, rng.integers(0, 1 << 32, n, dtype=np.uint64),
        rng.integers(0, 1 << 32, n, dtype=np.uint64),
        rng.integers(0, 256, n), rng.integers(0, 1 << 16, n),
        rng.integers(0, 1500, n), rng.integers(0, 2, n))
    blocks += c.flush(force=True)
    return blocks


def pseq_frames(n_flows, seq0=1, per=40):
    """(PACKETSEQUENCE frames, blocks): the blocks concatenated `per` to
    a frame."""
    blocks = pseq_blocks(n_flows)
    frames = [encode_frame(MessageType.PACKETSEQUENCE,
                           b"".join(blocks[s:s + per]),
                           FlowHeader(sequence=seq0 + s, vtap_id=6))
              for s in range(0, len(blocks), per)]
    return frames, len(blocks)


def test_decode_blocks_and_entries_match_jax():
    blocks = pseq_blocks(256)
    assert any(jps.decode_blocks(b, 1)[0][0]["packet_count"] == 255
               for b in blocks)
    payload = b"".join(blocks)
    trows, tbad = tps.decode_blocks(payload, vtap_id=6)
    jrows, jbad = jps.decode_blocks(payload, vtap_id=6)
    assert tbad == jbad == 0 and len(trows) == len(blocks)
    assert trows == jrows
    for r in trows[:64]:
        te, je = tps.decode_entries(r["batch"]), jps.decode_entries(r["batch"])
        assert set(te) == set(je)
        for k in je:
            assert te[k].dtype == je[k].dtype, k
            np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    assert (tps.BLOCK_HEAD_SIZE, tps.ENTRY_SIZE) == \
        (jps.BLOCK_HEAD_SIZE, jps.ENTRY_SIZE)


MALFORMED = [
    struct.pack("<I", 4) + b"xxxx",                     # size <= head
    struct.pack("<I", 100) + b"\x00" * 20,              # past the end
    b"\x01\x02",                                        # short size field
    b"",
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_decode_blocks_malformed_matches_jax(i):
    good = pseq_blocks(4)[0]
    payload = good + MALFORMED[i] + good
    assert tps.decode_blocks(payload, 2) == jps.decode_blocks(payload, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames, n_blocks = pseq_frames(512)
    frames.append(encode_frame(MessageType.PACKETSEQUENCE,
                               struct.pack("<I", 4) + b"xxxx",
                               FlowHeader(sequence=999, vtap_id=6)))
    stages = [(frames, lambda ing: tp.offered(ing, "l4_packet") == n_blocks
               and tp.decoder(ing, "l4_packet").decode_errors == 1)]
    root = tmp_path_factory.mktemp("pseq")
    out = {"n": n_blocks}
    for package in ("jax", "port"):
        _, got, _ = tp.run(package, str(root / package), stages,
                           probe=lambda ing: tp.decoder(
                               ing, "l4_packet").counters())
        tdir = str(root / package / "flow_log" / "l4_packet")
        out[package] = (tp.tables(str(root / package)), got,
                        {k: v for k, v in tp.files(tdir).items()
                         if k.startswith("batches-p")})
    return out


def test_l4_packet_rows_match_jax(runs):
    t, j = runs["port"], runs["jax"]
    rows = j[0][("flow_log", "l4_packet")]
    assert len(rows["flow_id"]) == runs["n"]
    tp.assert_tables_equal(t[0], j[0])
    assert t[1] == j[1] and t[1]["decode_errors"] == 1


def test_blob_bytes_match_jax_and_read_back(runs):
    """The sidecar blob files are byte for byte the JAX package's, and
    every row's batch read back through (batch_off, batch_len) decodes
    to its packet_count entries."""
    t, j = runs["port"], runs["jax"]
    assert t[2] and t[2] == j[2]
    rows = t[0][("flow_log", "l4_packet")]
    from deepflow_tpu.pipelines.schemas import L4_PACKET_TABLE
    psec = L4_PACKET_TABLE.partition_seconds
    for i in range(len(rows["flow_id"])):
        part = int(rows["timestamp"][i]) // psec * psec
        blob = t[2][f"batches-p{part}.bin"]
        off, n = int(rows["batch_off"][i]), int(rows["batch_len"][i])
        e = tps.decode_entries(blob[off:off + n])
        assert len(e["tcp_seq"]) == rows["packet_count"][i] == \
            n // tps.ENTRY_SIZE


def test_blob_files_pruned_with_expired_partitions(tmp_path):
    """An expired partition's blob goes, a live one stays, in both
    packages (the blobs aged past the wall-clock grace)."""
    left = {}
    for package in ("jax", "port"):
        ing = tp.build(package, str(tmp_path / package))
        try:
            tab = ing.store.table("flow_log", "l4_packet")
            psec = tab.schema.partition_seconds
            now = int(time.time())
            live = now // psec * psec
            for part in (3600, live, live - 7 * psec):
                path = f"{tab.root}/batches-p{part}.bin"
                open(path, "wb").write(b"x")
                os.utime(path, (now - 600, now - 600))
            open(f"{tab.root}/batches-pjunk.bin", "wb").write(b"z")
            tab.append({
                "timestamp": np.array([now], np.uint32),
                "start_time_us": np.zeros(1, np.uint64),
                "end_time_us": np.zeros(1, np.uint64),
                "flow_id": np.ones(1, np.uint64),
                "vtap_id": np.ones(1, np.uint32),
                "packet_count": np.ones(1, np.uint32),
                "batch_off": np.zeros(1, np.uint64),
                "batch_len": np.ones(1, np.uint32),
            })
            ing.flow_log.flush()
            left[package] = sorted(n for n in os.listdir(tab.root)
                                   if n.startswith("batches-"))
        finally:
            ing.close()
    assert left["port"] == left["jax"]
    assert f"batches-p{live}.bin" in left["port"]
    assert "batches-p3600.bin" not in left["port"]
