"""The port's ext_metrics, event, profile and droplet pipelines against
the JAX package's, through both packages' `Ingester` on the CPU.

Mirrors tests/test_aux_pipelines.py at seeded widths: the same frames,
made from a seed with numpy, go over loopback TCP to the JAX `Ingester`
and then to the port's `Ingester(device="cpu")` (tests/torch_pair.py);
every table both stores hold is scanned and compared row for row
(integers and float32 values exactly), the tag dictionaries' persisted
entries line for line, the droplet artifacts byte for byte. Rows stamped
with the receive time (timestamp-less Telegraf lines, StatsD) are
compared without their timestamp, which is checked to lie in the run.
The last case sends one or more frames of every message type to both
ingesters with the sketch lane and the RED lane with its `le` buckets
on: every table is equal, and only COMPRESS (0), which neither package
claims, counts as `no_handler`.
"""

import socket
import time

import numpy as np
import pytest

from deepflow_tpu.pipelines import droplet as jdroplet
from deepflow_tpu.pipelines import ext_metrics as jext
from deepflow_tpu.replay.generator import SyntheticAgent
from deepflow_tpu.runtime.debug import debug_request as jdebug_request
from deepflow_tpu.utils import snappy as jsnappy
from deepflow_tpu_torch.pipelines import droplet as tdroplet
from deepflow_tpu_torch.pipelines import ext_metrics as text
from deepflow_tpu_torch.runtime.debug import debug_request
from deepflow_tpu_torch.wire import (FlowHeader, MessageType, encode_frame,
                                     pack_pb_records)
from deepflow_tpu_torch.wire.gen import stats_pb2, telemetry_pb2

import torch_pair as tp
from test_torch_otel import l7_frames, otel_frames
from test_torch_packet_sequence import pseq_frames

T0 = 1_700_000_000
# metrics timestamps an hour boundary ahead of the wall clock, so no
# rollup minute builds before its rows land
DOC_T0 = (int(time.time()) // 3600 + 2) * 3600


# -- frames, from a seed -------------------------------------------------------
def _write_request(rng, n_series, n_samples):
    wr = telemetry_pb2.WriteRequest()
    for i in range(n_series):
        ts = wr.timeseries.add()
        ts.labels.add(name="__name__",
                      value=f"metric_{int(rng.integers(0, 6))}_total")
        ts.labels.add(name="job", value=f"job{i % 4}")
        ts.labels.add(name="instance", value=f"10.0.0.{i}:9100")
        for k in range(n_samples):
            ts.samples.add(value=float(rng.normal(100, 40)),
                           timestamp=(T0 + 15 * k) * 1000
                           + int(rng.integers(0, 999)))
    return wr


def _ext_frames(rng):
    """PROMETHEUS wrapped / bare / snappy, TELEGRAF (with a comment, a
    garbage line and a field that does not parse), DFSTATS (with a bad
    record)."""
    seq = iter(range(1, 1000))
    out = []
    wr = _write_request(rng, 12, 8)
    pm = telemetry_pb2.PrometheusMetric(
        metrics=wr.SerializeToString(), extra_label_names=["cluster"],
        extra_label_values=["prod-a"])
    out.append(encode_frame(MessageType.PROMETHEUS, pm.SerializeToString(),
                            FlowHeader(sequence=next(seq), vtap_id=3)))
    out.append(encode_frame(
        MessageType.PROMETHEUS,
        _write_request(rng, 5, 4).SerializeToString(),
        FlowHeader(sequence=next(seq), vtap_id=3)))
    out.append(encode_frame(
        MessageType.PROMETHEUS,
        jsnappy.compress(_write_request(rng, 4, 6).SerializeToString()),
        FlowHeader(sequence=next(seq), vtap_id=3)))
    lines = ["# a comment", "garbage", "disk,host=db free=x"]
    for i in range(40):
        host = f"h{int(rng.integers(0, 5))}"
        lines.append(
            f"cpu,host={host},region=r{i % 3} "
            f"usage_idle={rng.uniform(0, 100):.4f},count={i}i,up=t "
            f"{(T0 + i) * 1_000_000_000}")
    out.append(encode_frame(MessageType.TELEGRAF,
                            "\n".join(lines).encode(),
                            FlowHeader(sequence=next(seq), vtap_id=3)))
    recs = []
    for i in range(30):
        st = stats_pb2.Stats(
            timestamp=T0 + i, name=f"queue.{i % 3}",
            tag_names=["module", "host"],
            tag_values=[f"m{i % 4}", "ing-1"],
            metrics_float_names=["pending", "dropped"],
            metrics_float_values=[float(rng.integers(0, 1 << 16)),
                                  float(rng.integers(0, 9))])
        recs.append(st.SerializeToString())
    recs.insert(7, b"\xff\xff\xff")
    out.append(encode_frame(MessageType.DFSTATS, pack_pb_records(recs)))
    return out


def _event_frames(rng):
    procs = []
    for i in range(24):
        ev = telemetry_pb2.ProcEvent(
            pid=int(rng.integers(1, 1 << 16)), thread_id=i, pod_id=i % 5,
            start_time=(T0 + i) * 1_000_000_000,
            end_time=(T0 + i) * 1_000_000_000
            + int(rng.integers(0, 1 << 30)) * (i % 3 != 0),
            event_type=telemetry_pb2.IoEvent)
        ev.io_event_data.bytes_count = int(rng.integers(0, 1 << 20))
        ev.io_event_data.operation = telemetry_pb2.Read if i % 2 else \
            telemetry_pb2.Write
        ev.io_event_data.latency = int(rng.integers(0, 1 << 20))
        ev.io_event_data.filename = f"/var/log/app{i % 6}.log\x00".encode()
        procs.append(ev.SerializeToString())
    alarms = [telemetry_pb2.AlarmEvent(
        timestamp=T0 + i, policy_id=i % 4, policy_name=f"policy-{i % 4}",
        event_level=i % 3, alarm_target=f"svc-{i % 7}",
        trigger_value=float(rng.uniform(0, 1000))).SerializeToString()
        for i in range(16)]
    return [encode_frame(MessageType.PROC_EVENT, pack_pb_records(procs),
                         FlowHeader(sequence=1, vtap_id=3)),
            encode_frame(MessageType.ALARM_EVENT, pack_pb_records(alarms),
                         FlowHeader(sequence=1, vtap_id=3))]


def _profile_frames(rng):
    funcs = ["main", "handler", "db_query", "parse", "encode", "gc"]
    recs = []
    for i in range(40):
        depth = int(rng.integers(1, 5))
        stack = ";".join(funcs[int(k)] for k in rng.integers(0, 6, depth))
        recs.append(telemetry_pb2.Profile(
            timestamp=(T0 + i // 4) * 1_000_000_000,
            app_service=f"svc-{i % 3}", pid=100 + i % 5, vtap_id=3,
            pod_id=i % 2, event_type="on-cpu" if i % 4 else "off-cpu",
            stack=stack,
            value=int(rng.integers(1, 1 << 34))).SerializeToString())
    return [encode_frame(MessageType.PROFILE, pack_pb_records(recs[:25]),
                         FlowHeader(sequence=1, vtap_id=3)),
            encode_frame(MessageType.PROFILE, pack_pb_records(recs[25:]),
                         FlowHeader(sequence=2, vtap_id=3))]


def _droplet_frames(rng):
    syslog = "".join(f"<14>Jul 29 host{i % 3} app: line {i} "
                     f"{int(rng.integers(0, 1 << 20))}\n" for i in range(12))
    statsd = "\n".join(
        [f"api.rps.{i % 4}:{int(rng.integers(0, 500))}|c|#env:prod,az:{i % 2}"
         for i in range(20)] + ["bad line", "x:notanumber|g"])
    pcap = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    return [encode_frame(MessageType.SYSLOG, syslog.encode()),
            encode_frame(MessageType.SYSLOG, b"<13>no newline at the end"),
            encode_frame(MessageType.STATSD, statsd.encode()),
            encode_frame(MessageType.RAW_PCAP, pcap[:1500],
                         FlowHeader(sequence=1, vtap_id=3)),
            encode_frame(MessageType.RAW_PCAP, pcap[1500:],
                         FlowHeader(sequence=2, vtap_id=3)),
            encode_frame(MessageType.RAW_PCAP, pcap[:700],
                         FlowHeader(sequence=1, vtap_id=8)),
            encode_frame(MessageType.TELEGRAF,
                         b"net,iface=eth0 rx=12i,tx=7i",
                         FlowHeader(sequence=1, vtap_id=3))]


def _aux_counters(ing):
    return {"ext": ing.ext_metrics.counters(), "event": ing.event.counters(),
            "profile": ing.profile.counters(),
            "droplet": ing.droplet.counters()}


def _progress(ing):
    return sum(v for c in _aux_counters(ing).values() for v in c.values())


def _send_one_by_one(ing, frames):
    """Each frame lands (its pipeline's counters move) before the next is
    sent, so every pipeline appends in send order."""
    s = socket.create_connection(("127.0.0.1", ing.port))
    try:
        for f in frames:
            before = _progress(ing)
            s.sendall(f)
            tp.wait(lambda: _progress(ing) > before, "a frame")
    finally:
        s.close()


def _run_pair(tmp_path, frames, resource_events=()):
    """Both packages over the same frames; returns {package: (tables,
    dictionaries, droplet files, counters, (t_start, t_end))}."""
    res = {}
    for package in ("jax", "port"):
        root = str(tmp_path / package)
        ing = tp.build(package, root)
        ing.start()
        t_start = int(time.time())
        try:
            _send_one_by_one(ing, frames)
            for args in resource_events:
                ing.event.put_resource_event(*args)
            counters = _aux_counters(ing)
            rc = ing.receiver.counters()
        finally:
            ing.close()
        res[package] = (tp.tables(root), tp.dict_lines(root),
                        tp.files(f"{root}/droplet"), counters, rc,
                        (t_start, int(time.time())))
    return res


@pytest.fixture(scope="module")
def ext_run(tmp_path_factory):
    rng = np.random.default_rng(71)
    frames = _ext_frames(rng) + _event_frames(rng) + _profile_frames(rng)
    return _run_pair(tmp_path_factory.mktemp("ext"), frames,
                     resource_events=[(3, 101, "create", "pod created",
                                       T0), (3, 102, "delete", "gone",
                                             T0 + 5)])


@pytest.fixture(scope="module")
def droplet_run(tmp_path_factory):
    return _run_pair(tmp_path_factory.mktemp("droplet"),
                     _droplet_frames(np.random.default_rng(72)))


# -- the line parsers ------------------------------------------------------------
INFLUX = [
    "cpu,host=web1,region=us usage_idle=90.5,count=3i 1700000000000000000",
    "# comment", "garbage", "", "   ",
    "mem used=1.5", "mem,host=a used=t,free=F 17",
    'weather,loc=x temp="21.5",note="warm" 1700000000',
    "bad,host=a field=abc 1", "m f=1 notanint", "m,a=1,b=2 x=1,y=2,z=3i 9",
]


@pytest.mark.parametrize("line", INFLUX,
                         ids=[f"l{i}" for i in range(len(INFLUX))])
def test_influx_parser_matches_jax(line):
    assert text.parse_influx_line(line) == jext.parse_influx_line(line)


STATSD = ["api.rps:42|c|#env:prod", "bad line", "", "lat:1.5|ms",
          "x:1|g|@0.5|#a:1,b:2", "y:nan|g", "z:|c", "name:7|c|#k"]


@pytest.mark.parametrize("line", STATSD,
                         ids=[f"s{i}" for i in range(len(STATSD))])
def test_statsd_parser_matches_jax(line):
    # repr: "y:nan|g" parses to a NaN value in both
    assert repr(tdroplet.parse_statsd_line(line)) == \
        repr(jdroplet.parse_statsd_line(line))


# -- the pipelines -----------------------------------------------------------------
def _table(run, db, name):
    return run[0][(db, name)]


def test_remote_write_telegraf_rows_match_jax(ext_run):
    """PROMETHEUS (wrapped with extra labels, bare, snappy) and TELEGRAF
    rows in ext_metrics.ext_samples: equal, and all of them there."""
    t = _table(ext_run["port"], "ext_metrics", "ext_samples")
    j = _table(ext_run["jax"], "ext_metrics", "ext_samples")
    assert len(j["value"]) == 12 * 8 + 5 * 4 + 4 * 6 + 40 * 3
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_dfstats_rows_match_jax(ext_run):
    t = _table(ext_run["port"], "deepflow_system", "ext_samples")
    j = _table(ext_run["jax"], "deepflow_system", "ext_samples")
    assert len(j["value"]) == 30 * 2
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("table", ["perf_event", "alarm_event",
                                   "resource_event"])
def test_event_rows_match_jax(ext_run, table):
    t = _table(ext_run["port"], "event", table)
    j = _table(ext_run["jax"], "event", table)
    assert len(j["timestamp"]) == {"perf_event": 24, "alarm_event": 16,
                                   "resource_event": 2}[table]
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_profile_rows_and_dictionaries_match_jax(ext_run):
    """Profiles (values past u32 clamp), and every tag dictionary's
    persisted contents (metric names, label sets, event strings,
    profile stacks and names)."""
    t = _table(ext_run["port"], "profile", "in_process_profile")
    j = _table(ext_run["jax"], "profile", "in_process_profile")
    assert len(j["value"]) == 40
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    td, jd = ext_run["port"][1], ext_run["jax"][1]
    assert {"metric_name.jsonl", "label_set.jsonl", "event_strings.jsonl",
            "profile_stack.jsonl", "profile_name.jsonl"} <= set(jd)
    assert td == jd


def test_every_table_and_counter_matches_jax(ext_run):
    tp.assert_tables_equal(ext_run["port"][0], ext_run["jax"][0])
    assert ext_run["port"][3] == ext_run["jax"][3]
    # the bad DFSTATS record (Telegraf skips lines it cannot parse)
    assert ext_run["port"][3]["ext"]["decode_errors"] == 1
    rc_t, rc_j = ext_run["port"][4], ext_run["jax"][4]
    assert rc_t == rc_j and rc_t["no_handler"] == 0


def test_syslog_statsd_pcap_match_jax(droplet_run):
    """Syslog text files and pcap files byte for byte; StatsD and a
    timestamp-less Telegraf line (stamped with the receive time) equal
    but for the timestamp, which lies inside each run."""
    t, j = droplet_run["port"], droplet_run["jax"]
    assert set(j[2]) == {"syslog-vtap0.log", "pcap-vtap3.bin",
                         "pcap-vtap8.bin"}
    assert t[2] == j[2]
    assert len(j[2]["pcap-vtap3.bin"]) == 4096
    assert t[3] == j[3]
    tp.assert_tables_equal(t[0], j[0], skip=("timestamp",))
    for run in (t, j):
        ts = _table(run, "ext_metrics", "ext_samples")["timestamp"]
        assert len(ts) == 20 + 2
        lo, hi = run[5]
        assert ((ts >= lo) & (ts <= hi)).all()
    assert t[1] == j[1]


def test_debug_artifacts_listing_matches_jax(tmp_path):
    """The `artifacts` debug command lists the droplet pipeline's files
    as the JAX ingester's does."""
    frames = _droplet_frames(np.random.default_rng(73))[3:6]
    replies = {}
    for package, req in (("jax", jdebug_request), ("port", debug_request)):
        def probe(ing, req=req):
            ing.flush()
            return req("artifacts", port=ing.debug.port)["data"]
        stages = [([f], lambda ing, n=n: ing.droplet.pcap_bytes >= n)
                  for f, n in zip(frames, (1500, 4096, 4796))]
        _, got, _ = tp.run(package, str(tmp_path / package), stages,
                           probe=probe, debug_port=0)
        got["dir"] = got["dir"].replace(str(tmp_path / package), "")
        replies[package] = got
    assert replies["port"] == replies["jax"]
    assert {f["name"] for f in replies["port"]["files"]} == \
        {"pcap-vtap3.bin", "pcap-vtap8.bin"}


# -- every message type, with the sketch lane and the le buckets on -------------
def _all_type_stages():
    """(stages, per-stage counts): one stage per message type, each
    waited for by its own pipeline's counter."""
    rng = np.random.default_rng(74)
    agent = SyntheticAgent(seed=74, vtap_id=5)
    cols = agent.l4_columns_pooled(600, pool=64)
    recs = [agent.l4_record(cols, i) for i in range(600)]
    tagged = list(agent.frames(recs[:300], MessageType.TAGGEDFLOW,
                               per_frame=100))
    from deepflow_tpu.batch.schema import L4_SCHEMA
    from deepflow_tpu.decode.columnar import decode_l4_records
    from deepflow_tpu_torch.wire.columnar_wire import encode_columnar
    wide = decode_l4_records(recs[300:])
    planar = [encode_frame(MessageType.COLUMNAR_FLOW,
                           encode_columnar({k: v[s:s + 100]
                                            for k, v in wide.items()}),
                           FlowHeader(sequence=10 + s, vtap_id=5))
              for s in range(0, 300, 100)]
    assert set(wide) == set(L4_SCHEMA.names)
    l7 = l7_frames(rng, 200)
    otel_raw, otel_z, n_spans = otel_frames(rng, 4)
    pseq, n_blocks = pseq_frames(64)
    docs = [agent.metric_record(
        DOC_T0 + i % 60, i, {"packet_tx": int(rng.integers(1, 1 << 20)),
                              "byte_tx": int(rng.integers(0, 1 << 30))})
        for i in range(128)]
    metrics = [encode_frame(MessageType.METRICS,
                            pack_pb_records(docs[s:s + 64]),
                            FlowHeader(sequence=1 + s, vtap_id=5))
               for s in range(0, 128, 64)]
    aux = _ext_frames(rng) + _event_frames(rng) + _profile_frames(rng) \
        + _droplet_frames(rng)[:6]
    compress = encode_frame(MessageType.COMPRESS, b"x")
    # l4 frame by frame (100 rows each), each exported before the next:
    # a decoder batch would decode its planar frames first
    stages = [([f], lambda ing, n=100 * (i + 1): ing.tpu_sketch.rows_in == n
               and tp.offered(ing, "l4_flow_log") == n)
              for i, f in enumerate(tagged + planar)]
    stages += [
        (l7, lambda ing: ing.app_red.rows_in == 200
         and tp.offered(ing, "l7_flow_log") == 200),
        (otel_raw + otel_z,
         lambda ing: tp.offered(ing, "l7_flow_log.otel") == n_spans
         and tp.decoder(ing, "l7_flow_log.otel").decode_errors == 2),
        (pseq, lambda ing: tp.offered(ing, "l4_packet") == n_blocks),
        (metrics, lambda ing: ing.flow_metrics.records == 128),
    ]
    return stages, aux, compress


def test_every_message_type_matches_jax(tmp_path):
    """Frames of all 17 message types through both ingesters, with the
    sketch lane, the RED lane and its le buckets (stride 8) on: every
    table (flow_log l4/l7/l4_packet, flow_metrics, ext_metrics with the
    le rows, deepflow_system, event, profile, tpu_sketch.app_red) equal,
    the sidecar blobs and droplet files byte for byte, the dictionaries
    line for line; `no_handler` counts COMPRESS alone in both."""
    stages, aux, compress = _all_type_stages()
    types = {MessageType.TAGGEDFLOW, MessageType.COLUMNAR_FLOW,
             MessageType.PROTOCOLLOG, MessageType.OPENTELEMETRY,
             MessageType.OPENTELEMETRY_COMPRESSED,
             MessageType.PACKETSEQUENCE, MessageType.METRICS,
             MessageType.PROMETHEUS, MessageType.TELEGRAF,
             MessageType.DFSTATS, MessageType.PROC_EVENT,
             MessageType.ALARM_EVENT, MessageType.PROFILE,
             MessageType.SYSLOG, MessageType.STATSD, MessageType.RAW_PCAP,
             MessageType.COMPRESS}
    assert types == set(MessageType)
    res = {}
    for package in ("jax", "port"):
        root = str(tmp_path / package)
        ing = tp.build(package, root, tpu_sketch_window_s=3600,
                       app_red_window_s=3600, app_red_prom_buckets=8)
        ing.start()
        try:
            tp.drive(ing, stages)
            _send_one_by_one(ing, aux)
            before = ing.receiver.counters()["no_handler"]
            tp.drive(ing, [([compress], lambda i: i.receiver.counters()
                            ["no_handler"] > before)])
            ing.tpu_sketch.flush_window(now=T0 + 10.0)
            ing.app_red.flush_window(now=T0 + 10.0)
            ing.flush()
            ing.flow_metrics.rollups.advance(DOC_T0 + 600)
            rc = ing.receiver.counters()
        finally:
            ing.close()
        res[package] = (tp.tables(root), tp.dict_lines(root),
                        tp.files(f"{root}/droplet"),
                        tp.files(f"{root}/flow_log/l4_packet"), rc)
    t, j = res["port"], res["jax"]
    # the exporters' close() writes one more window at the wall clock, and
    # StatsD rows carry the receive time: rows stamped after T0 + 1000
    # are left out of the sketch and ext_samples tables
    for r in (t, j):
        for key, cols in r[0].items():
            if (key[0] == "tpu_sketch" or key == ("ext_metrics",
                                                  "ext_samples")) and cols:
                keep = cols["timestamp"] < T0 + 1000
                r[0][key] = {k: v[keep] for k, v in cols.items()}
    import json
    names = {json.loads(x)["s"]: json.loads(x)["h"]
             for x in t[1]["metric_name.jsonl"]}
    ext = t[0][("ext_metrics", "ext_samples")]
    le = ext["metric"] == names["app_rrt_bucket"]
    groups = len(t[0][("tpu_sketch", "app_red")]["service_group"])
    assert groups > 0 and le.sum() == groups * (512 // 8)
    # the sketch and RED readouts' floats (entropies, quantiles) within
    # rtol 1e-5, as in test_torch_store.py and test_torch_app_red.py
    tp.assert_tables_equal(t[0], j[0], loose={
        ("tpu_sketch", "window_signals"), ("tpu_sketch", "app_red")})
    assert t[1] == j[1]
    assert t[2] == j[2]
    blobs = {k: v for k, v in t[3].items() if k.startswith("batches-p")}
    assert blobs and blobs == {k: v for k, v in j[3].items()
                               if k.startswith("batches-p")}
    assert t[4]["no_handler"] == j[4]["no_handler"] == 1
    assert t[4] == j[4]
