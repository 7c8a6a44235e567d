"""The port's L7 layer (`deepflow_tpu_torch/agent/{l7,l7_ext,trace_context,
sql_obfuscate}.py`, `utils/text.py`) against the JAX package's, on the CPU.

The payloads are the reference's own: every payload that the JAX
package's L7 tests (`test_agent.py::test_l7_parsers` and
`::test_session_aggregator_rrt`, `test_l7_ext.py`, `test_trace_context.py`
and `test_l7_fuzz.py`'s seeded fuzz) hand to a parser's `check` or
`parse` is recorded while those tests run here, then replayed in the same
order through both packages' `parse_payload` under several transport
contexts and two extraction configs, and through every parser's own
`check` and `parse`. Each package gets a fresh parser registry, built the
same way, so stateful parsers (HPACK tables, FIFO response matching) see
the same history. The records must be equal field by field, and None
where the reference gives None; one case per protocol.
"""

import dataclasses
import inspect

import numpy as np
import pytest

from deepflow_tpu.agent import l7 as jl7
from deepflow_tpu.agent import l7_ext as jl7x
from deepflow_tpu.agent import sql_obfuscate as jsql
from deepflow_tpu.agent import trace_context as jtc
from deepflow_tpu.agent import trident as jtrident
from deepflow_tpu.utils import text as jtext
from deepflow_tpu_torch.agent import l7 as tl7
from deepflow_tpu_torch.agent import l7_ext as tl7x
from deepflow_tpu_torch.agent import sql_obfuscate as tsql
from deepflow_tpu_torch.agent import trace_context as ttc
from deepflow_tpu_torch.agent import trident as ttrident
from deepflow_tpu_torch.utils import text as ttext

DEFAULT_TC = dict(trace_types=("traceparent", "sw8"),
                  span_types=("traceparent", "sw8"),
                  x_request_id="x-request-id",
                  proxy_client=("x-forwarded-for", "x-real-ip"))
CUSTOM_TC = dict(trace_types="X-MyTrace, uber-trace-id, sw3",
                 span_types=["sw3", "uber-trace-id", "traceparent"],
                 x_request_id=["x-req", "x-request-id"],
                 proxy_client="x-real-ip")
# (ip proto, port_src, port_dst): dispatch contexts; None = no context
CONTEXTS = ((None, None, None), (6, 40000, 443), (6, 55555, 80),
            (17, 53, 5353), (17, 40000, 53))
# the reference tests whose payloads are replayed: all argument-free
# tests of these modules, and the two named ones of test_agent.py
FIXTURE_MODULES = ("test_l7_ext", "test_trace_context", "test_l7_fuzz")
FIXTURE_TESTS = {"test_agent": ("test_l7_parsers",
                                "test_session_aggregator_rrt")}
PROTOCOLS = ("HTTP1", "DNS", "MYSQL", "REDIS", "TLS", "HTTP2", "GRPC",
             "KAFKA", "POSTGRESQL", "MONGODB", "DUBBO", "MQTT", "AMQP",
             "NATS", "OPENWIRE", "FASTCGI", "SOFARPC", "ORACLE")


def _proto_id(name):
    return getattr(jl7, f"L7_{name}", None) or getattr(jl7x, f"L7_{name}")


def fresh_registry(l7, l7x):
    """A registry built as the package builds its own at import."""
    parsers = [l7.HttpParser(), l7.DnsParser(), l7.MysqlParser(),
               l7.RedisParser()]
    l7x.register_extended(parsers)
    return parsers


def _fields(rec):
    return None if rec is None else (type(rec).__name__,
                                     dataclasses.asdict(rec))


@pytest.fixture(scope="module")
def corpus():
    """Every payload the reference's L7 tests offer a parser, in order
    of first use."""
    import importlib

    seen, order = set(), []
    classes = {type(p) for p in fresh_registry(jl7, jl7x)}

    def wrap(fn):
        def recorder(self, payload, *a, **k):
            b = bytes(payload)
            if b not in seen:
                seen.add(b)
                order.append(b)
            return fn(self, payload, *a, **k)
        return recorder
    mp = pytest.MonkeyPatch()
    try:
        for cls in classes:
            mp.setattr(cls, "check", wrap(cls.check))
            mp.setattr(cls, "parse", wrap(cls.parse))
        mods = {name: None for name in FIXTURE_MODULES}
        mods.update(FIXTURE_TESTS)
        for name, only in mods.items():
            mod = importlib.import_module(name)
            for fname, fn in sorted(vars(mod).items()):
                if not fname.startswith("test_") or not callable(fn):
                    continue
                if only is not None and fname not in only:
                    continue
                if inspect.signature(fn).parameters:
                    continue
                # test_trace_context's autouse fixture, as pytest runs it
                jtc.configure(**DEFAULT_TC)
                fn()
    finally:
        mp.undo()
        jtc.configure(**DEFAULT_TC)
    assert len(order) > 5000, len(order)
    return order


@pytest.fixture(scope="module")
def replay(corpus):
    """(payload, context, config, reference record, port record) for
    every payload, context and config, through parse_payload; and per
    parser class, (payload, check, parse) of both packages."""
    out = []
    jreg, treg = fresh_registry(jl7, jl7x), fresh_registry(tl7, tl7x)
    assert [type(p).__name__ for p in jreg] == \
        [type(p).__name__ for p in treg]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jl7, "PARSERS", jreg)
        mp.setattr(tl7, "PARSERS", treg)
        for cname, tc in (("default", DEFAULT_TC), ("custom", CUSTOM_TC)):
            jtc.configure(**tc)
            ttc.configure(**tc)
            for payload in corpus:
                for proto, ps, pd in CONTEXTS:
                    kw = {} if proto is None else dict(
                        proto=proto, port_src=ps, port_dst=pd)
                    out.append((payload, (proto, ps, pd), cname,
                                jl7.parse_payload(payload, **kw),
                                tl7.parse_payload(payload, **kw)))
        # every parser on its own, fresh instances, default config
        jtc.configure(**DEFAULT_TC)
        ttc.configure(**DEFAULT_TC)
        direct = {}
        for jp, tp in zip(fresh_registry(jl7, jl7x),
                          fresh_registry(tl7, tl7x)):
            rows = direct.setdefault((type(jp).__name__, jp.proto), [])
            for payload in corpus:
                jc, tc_ = jp.check(payload), tp.check(payload)
                rows.append((payload, jc, tc_,
                             jp.parse(payload) if jc else None,
                             tp.parse(payload) if tc_ else None))
    finally:
        mp.undo()
        jtc.configure(**DEFAULT_TC)
        ttc.configure(**DEFAULT_TC)
    return out, direct


@pytest.mark.parametrize("protocol", PROTOCOLS + ("unclaimed",))
def test_parsers_match_reference(replay, protocol):
    rows, direct = replay
    if protocol == "unclaimed":
        mine = [r for r in rows if r[3] is None]
        assert mine
        for payload, ctx, cfg, j, t in mine:
            assert t is None, (payload[:64], ctx, cfg, t)
        return
    pid = _proto_id(protocol)
    mine = [r for r in rows
            if (r[3] is not None and r[3].proto == pid)
            or (r[4] is not None and r[4].proto == pid)]
    # every protocol's fixtures reach parse_payload with a record
    assert mine, protocol
    for payload, ctx, cfg, j, t in mine:
        assert _fields(t) == _fields(j), (payload[:64], ctx, cfg)
    parsers = [k for k in direct if k[1] == pid]
    if protocol != "GRPC":     # gRPC is a record of the HTTP/2 parser
        assert parsers, protocol
    for key in parsers:
        for payload, jc, tc_, j, t in direct[key]:
            assert tc_ == jc, (key, payload[:64])
            assert _fields(t) == _fields(j), (key, payload[:64])


def _sessions(rng, n):
    """A seeded stream of L7 halves: requests and responses of several
    protocols over a few flows, pipelined, some unpaired, out of order."""
    ext = [("GET /a?x=1 HTTP/1.1\r\nHost: h\r\nUser-Agent: ua\r\n"
            "X-Request-Id: r1\r\ntraceparent: 00-"
            "4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01\r\n\r\n"
            ).encode(),
           b"HTTP/1.1 503 Unavailable\r\nX-Request-Id: r2\r\n\r\n",
           b"*2\r\n$3\r\nGET\r\n$3\r\nkey\r\n", b"-ERR no\r\n",
           b"\x16\x03\x01\x00\x05\x01\x00\x00\x01\x00",
           b"\x16\x03\x03\x00\x05\x02\x00\x00\x01\x00"]
    out = []
    for _ in range(n):
        flow = int(rng.integers(0, 6))
        payload = ext[int(rng.integers(0, len(ext)))]
        out.append(((("f", flow),), payload,
                    int(rng.integers(0, 120 * 10**9))))
    return out


def test_sessions_and_l7_messages_match_reference():
    """SessionAggregator merges (FIFO pipelining, unpaired responses,
    expiry) and each merged session's AppProtoLogsData bytes."""
    rng = np.random.default_rng(16)
    ja, ta = jl7.SessionAggregator(), tl7.SessionAggregator()
    n_msgs = 0
    for key, payload, ts in _sessions(rng, 4000):
        jr, tr = jl7.parse_payload(payload), tl7.parse_payload(payload)
        assert _fields(tr) == _fields(jr)
        jm, tm = ja.offer(key, jr, ts), ta.offer(key, tr, ts)
        assert tm == jm
        if jm is not None:
            flow = tuple(int(x) for x in rng.integers(0, 1 << 31, 5))
            vtap = int(rng.integers(0, 1 << 16))
            jb = jtrident.l7_session_message(flow, jm, ts, vtap) \
                .SerializeToString()
            tb = ttrident.l7_session_message(flow, tm, ts, vtap) \
                .SerializeToString()
            assert tb == jb
            assert ttrident._l7_record_bytes(flow, tm, ts, vtap) == \
                jtrident._l7_record_bytes(flow, jm, ts, vtap)
            n_msgs += 1
        if rng.random() < 0.01:
            now = int(rng.integers(0, 200 * 10**9))
            assert ta.expire(now) == ja.expire(now)
    assert n_msgs > 1000 and ja.merged > 100 and ja.unpaired > 100
    assert (ta.merged, ta.unpaired) == (ja.merged, ja.unpaired)
    assert ta._pending.keys() == ja._pending.keys()


def _helper_cases():
    rng = np.random.default_rng(1616)
    sql = [b"SELECT * FROM t WHERE id = 42 AND name = 'bob'",
           b"  insert into x values (1, 'a', 0x1F, -3.5e2)",
           b"UPDATE t SET a = $1 WHERE b IN (1,2,3) -- c",
           b"/* hint */ DELETE FROM t", b"BEGIN", b"",
           b"select \"q\"\"uoted\" from t where s = 'it''s'"]
    sql += [bytes(rng.integers(0, 256, int(rng.integers(0, 80)),
                               dtype=np.uint8)) for _ in range(300)]
    ids = [("traceparent", "00-4bf92f3577b34da6a3ce929d0e0e4736-"
            "00f067aa0ba902b7-01"), ("traceparent", "bad"),
           ("sw8", "1-dHJhY2UtMTIz-c2VnLTk=-3-c2Vydmlj-aW5zdA==-L2FwaQ=="
            "-MTAuMC4wLjE6ODA="), ("sw8", "1-@@-##-x"), ("sw6", "1-YQ==-Yg==-2"),
           ("sw3", "seg1|4|100|100|#10.0.0.1:80|#/parent|#/api|TRACE9|1"),
           ("uber-trace-id", "abcdef123:span77:parent0:1"),
           ("uber-trace-id", "x"), ("X-Company-Trace", " raw-id "),
           ("x-any", "")]
    texts = ["42", "0042", "", "4a", "\xb3", "٣", "-1", " 7", "99999999999"]
    return sql, ids, texts


@pytest.mark.parametrize("helper", ["obfuscate_sql", "sql_verb", "decode_id",
                                    "configure_extract", "parse_int"])
def test_helpers_match_reference(helper):
    sql, ids, texts = _helper_cases()
    if helper == "obfuscate_sql":
        for s in sql:
            for n in (256, 16):
                assert tsql.obfuscate_sql(s, n) == jsql.obfuscate_sql(s, n)
    elif helper == "sql_verb":
        for s in sql:
            assert tsql.sql_verb(s) == jsql.sql_verb(s)
    elif helper == "decode_id":
        for key, value in ids:
            for kind in (ttc.TRACE_ID, ttc.SPAN_ID):
                assert ttc.decode_id(key, value, kind) == \
                    jtc.decode_id(key, value, kind)
    elif helper == "parse_int":
        for s in texts:
            assert ttext.parse_int(s, -7) == jtext.parse_int(s, -7)
    else:
        headers = {"x-mytrace": "m-1", "sw3": ids[5][1],
                   "uber-trace-id": ids[6][1], "traceparent": ids[0][1],
                   "x-req": "q", "x-real-ip": "1.2.3.4",
                   "x-forwarded-for": " 9.9.9.9 , 8.8.8.8"}
        try:
            for tc in (DEFAULT_TC, CUSTOM_TC, dict(trace_types=[]),
                       dict(proxy_client="x-forwarded-for")):
                jtc.configure(**tc)
                ttc.configure(**tc)
                assert dataclasses.asdict(ttc.config()) == \
                    dataclasses.asdict(jtc.config())
                for drop in [None] + sorted(headers):
                    h = {k: v for k, v in headers.items() if k != drop}
                    assert ttc.extract(h) == jtc.extract(h)
        finally:
            jtc.configure(**DEFAULT_TC)
            ttc.configure(**DEFAULT_TC)


def test_port_registry_is_the_reference_registry():
    """The same parser classes in the same dispatch order, and the same
    public protocol ids."""
    names = [type(p).__name__ for p in fresh_registry(jl7, jl7x)]
    assert [type(p).__name__ for p in tl7.PARSERS] == names
    assert [type(p).__name__ for p in fresh_registry(tl7, tl7x)] == names
    for name in PROTOCOLS:
        mod = tl7 if hasattr(jl7, f"L7_{name}") else tl7x
        assert getattr(mod, f"L7_{name}") == _proto_id(name)
