"""The one traffic generator: a mix file of parameters -> a bank of
decoded columnar chunks, made from the seed.

A mix is a JSON file beside this one (`<mix>.json`). Its `kind` says
which stream it makes:

- `l4`: rows of the l4_flow_log stream, with the columns the sketch
  exporter reads (the ingester's `SKETCH_L4_SCHEMA`). Flows come from a
  stable `pool` of distinct 5-tuples, chosen by a Zipf law over rank
  (truncated to the pool, so no rank is clipped onto the last one), and
  from `unique` components whose 5-tuples never repeat within a run:
  their (ip_src, port_src) pair is an affine bijection of a running
  counter over the source net times the source port range, so each
  cycle of the bank re-salts them. A component may pin the destination
  (a flood's victim) or take it from a pool flow, and may pin columns
  (a SYN row's packet counts). Every other column follows the port's
  `replay/generator.SyntheticAgent.l4_columns`, copied here.
- `l7`: rows of the l7_flow_log stream with the columns the RED exporter
  reads: requests to `endpoints` (ip_dst, port_dst, protocol) chosen by
  a Zipf law, each endpoint serving one protocol, with server and
  client error shares and a lognormal response time scaled per
  endpoint.

The bank holds `bank_records` rows, cut into chunks of `chunk_rows`, and
is cycled: global chunk i is bank chunk i mod n_chunks in cycle
i // n_chunks. `chunk(i)` is what the producer hands the exporter;
`records(lo, hi)` rebuilds any global row range from the same function,
which is what the reference reads. The producer does no per-record
Python work: a chunk is column slices of the bank, and only the rows of
a unique component are rewritten past the first cycle (a few vector
operations on the chunk).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent

# the sketch exporter's columns and dtypes (SKETCH_L4_SCHEMA)
L4_COLUMNS = (
    ("ip_src", np.uint32), ("ip_dst", np.uint32), ("port_src", np.uint32),
    ("port_dst", np.uint32), ("proto", np.uint32), ("vtap_id", np.uint32),
    ("tap_side", np.uint32), ("l3_epc_id", np.int32),
    ("byte_tx", np.uint32), ("byte_rx", np.uint32),
    ("packet_tx", np.uint32), ("packet_rx", np.uint32),
    ("rtt", np.uint32), ("retrans", np.uint32), ("close_type", np.uint32),
    ("timestamp", np.uint32), ("duration_us", np.uint32),
)
# the RED exporter's columns (all u32)
L7_COLUMNS = (("ip_dst", np.uint32), ("port_dst", np.uint32),
              ("protocol", np.uint32), ("status", np.uint32),
              ("rrt_us", np.uint32))


def load_mix(name: str) -> dict:
    """The mix file `traffic/<name>.json`."""
    path = TRAFFIC_DIR / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    if mix.get("kind") not in ("l4", "l7"):
        raise ValueError(f"{path}: kind must be 'l4' or 'l7'")
    return mix


def ip4(text: str) -> int:
    a, b, c, d = (int(x) for x in text.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def net4(text: str):
    """'11.0.0.0/12' -> (base, number of addresses)."""
    addr, bits = text.split("/")
    return ip4(addr), 1 << (32 - int(bits))


def rng_of(seed: int, tag: str) -> np.random.Generator:
    """A generator per (seed, purpose): any whole seed, negative too."""
    return np.random.default_rng([int(seed) % (1 << 64),
                                  int.from_bytes(tag.encode(), "little")])


def zipf_ranks(rng: np.random.Generator, a: float, n_items: int,
               size: int) -> np.ndarray:
    """Ranks in [0, n_items) drawn with P(rank r) ~ (r + 1)^-a, the law
    truncated to the items (inverse CDF, no clipping)."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -float(a)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(size)),
                      n_items - 1).astype(np.int64)


@dataclass
class Unique:
    """A unique component's rows of the bank and their bijection."""

    pos: np.ndarray      # bank positions, ascending
    a: int               # multiplier, coprime to m
    b: int               # offset
    m: int               # source addresses x source ports
    net: int             # first source address
    port_lo: int
    n_ports: int

    def src(self, j: np.ndarray):
        """(ip_src, port_src) of running counters j (uint64)."""
        x = (np.uint64(self.a) * j + np.uint64(self.b)) % np.uint64(self.m)
        ip = (np.uint64(self.net) + x // np.uint64(self.n_ports))
        port = np.uint64(self.port_lo) + x % np.uint64(self.n_ports)
        return ip.astype(np.uint32), port.astype(np.uint32)


class Bank:
    """A seeded bank of chunks for one mix (see the module docstring)."""

    def __init__(self, mix: dict, seed: int) -> None:
        self.mix = mix
        self.kind = mix["kind"]
        self.chunk_rows = int(mix["chunk_rows"])
        n = int(mix["bank_records"])
        if n % self.chunk_rows:
            raise ValueError("bank_records must be a multiple of chunk_rows")
        self.n_records = n
        self.n_chunks = n // self.chunk_rows
        self.unique: List[Unique] = []
        if self.kind == "l4":
            self.columns = _l4_bank(mix, seed, n, self.unique)
        else:
            self.columns = _l7_bank(mix, seed, n)
        # per chunk, the span of each unique component's positions
        bounds = np.arange(self.n_chunks + 1) * self.chunk_rows
        self._spans = [np.searchsorted(u.pos, bounds) for u in self.unique]

    def chunk(self, i: int) -> Dict[str, np.ndarray]:
        """Global chunk i: column views of the bank, the unique rows
        re-salted past the first cycle."""
        j, cycle = i % self.n_chunks, i // self.n_chunks
        s = j * self.chunk_rows
        e = s + self.chunk_rows
        cols = {k: v[s:e] for k, v in self.columns.items()}
        if cycle == 0 or not self.unique:
            return cols
        ip = cols["ip_src"].copy()
        port = cols["port_src"].copy()
        for u, span in zip(self.unique, self._spans):
            lo, hi = int(span[j]), int(span[j + 1])
            if lo == hi:
                continue
            ctr = np.arange(lo, hi, dtype=np.uint64) \
                + np.uint64(cycle * len(u.pos))
            at = u.pos[lo:hi] - s
            ip[at], port[at] = u.src(ctr)
        cols["ip_src"], cols["port_src"] = ip, port
        return cols

    def records(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Global rows [lo, hi), as the chunks that carried them."""
        if hi <= lo:
            return {k: v[:0] for k, v in self.columns.items()}
        c0, c1 = lo // self.chunk_rows, (hi - 1) // self.chunk_rows
        parts = [self.chunk(i) for i in range(c0, c1 + 1)]
        off = lo - c0 * self.chunk_rows
        return {k: np.concatenate([p[k] for p in parts])[off:off + hi - lo]
                for k in self.columns}


def _coprime(rng: np.random.Generator, m: int) -> int:
    a = int(rng.integers(1 << 20, 1 << 30)) | 1
    while math.gcd(a, m) != 1:
        a += 2
    return a


def _l4_pool(mix: dict, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """`pool.flows` distinct 5-tuples, as SyntheticAgent.l4_columns draws
    them: clients from n_hosts addresses of 10.0.0.0/12, services (a
    server address of 172.16.0.0/16 and a well-known port) chosen by
    Zipf(1.25), ephemeral source ports, TCP 90% / UDP."""
    p = mix["pool"]
    flows = int(p["flows"])
    n_hosts = int(p.get("hosts", 4096))
    n_services = int(p.get("services", 64))
    clients = (ip4("10.0.0.0") + rng.choice(1 << 20, n_hosts, replace=False)
               ).astype(np.uint32)
    servers = (ip4("172.16.0.0") + rng.choice(1 << 16, n_services,
                                              replace=False)).astype(np.uint32)
    ports = rng.choice(np.array([80, 443, 3306, 6379, 8080, 9092, 5432, 53],
                                np.uint32), n_services)
    out: Dict[str, List[np.ndarray]] = {k: [] for k in
                                        ("ip_src", "ip_dst", "port_src",
                                         "port_dst", "proto")}
    seen = set()
    have = 0
    while have < flows:
        m = flows
        svc = (rng.zipf(1.25, m) - 1).clip(max=n_services - 1)
        t = (clients[rng.integers(0, n_hosts, m)], servers[svc],
             rng.integers(1024, 65536, m).astype(np.uint32), ports[svc],
             np.where(rng.random(m) < 0.9, 6, 17).astype(np.uint32))
        keys = np.stack(t, axis=1).astype(np.uint32).view("V20").ravel()
        _, first = np.unique(keys, return_index=True)
        for i in np.sort(first):
            k = keys[i].tobytes()
            if k in seen:
                continue
            seen.add(k)
            for name, col in zip(out, t):
                out[name].append(col[i:i + 1])
            have += 1
            if have == flows:
                break
    return {k: np.concatenate(v) for k, v in out.items()}


def _l4_bank(mix: dict, seed: int, n: int,
             unique: List[Unique]) -> Dict[str, np.ndarray]:
    rng = rng_of(seed, "l4:" + mix.get("name", ""))
    pool = _l4_pool(mix, rng)
    flows = len(pool["ip_src"])
    perm = rng.permutation(flows)           # rank -> pool flow
    comps = mix["components"]
    shares = np.cumsum([float(c["share"]) for c in comps])
    if abs(shares[-1] - 1.0) > 1e-9:
        raise ValueError("component shares must sum to 1")
    which = np.searchsorted(shares, rng.random(n), side="right")
    which = np.minimum(which, len(comps) - 1)
    # every row first takes a pool flow (a unique row keeps its
    # destination when the component takes it from the pool)
    pick = perm[zipf_ranks(rng, float(mix["pool"]["zipf_a"]), flows, n)]
    cols = {k: v[pick] for k, v in pool.items()}
    # the rest of the row, as SyntheticAgent.l4_columns draws it
    cols["vtap_id"] = np.full(n, 7, np.uint32)
    cols["tap_side"] = rng.integers(0, 3, n).astype(np.uint32)
    cols["l3_epc_id"] = rng.integers(-2, 100, n).astype(np.int32)
    cols["byte_tx"] = np.minimum(rng.lognormal(6.0, 1.5, n),
                                 2**32 - 1).astype(np.uint32)
    cols["byte_rx"] = np.minimum(rng.lognormal(7.0, 1.5, n),
                                 2**32 - 1).astype(np.uint32)
    cols["packet_tx"] = rng.integers(1, 64, n).astype(np.uint32)
    cols["packet_rx"] = rng.integers(1, 64, n).astype(np.uint32)
    cols["rtt"] = rng.integers(100, 200_000, n).astype(np.uint32)
    cols["retrans"] = ((rng.random(n) < 0.02)
                       * rng.integers(1, 5, n)).astype(np.uint32)
    cols["close_type"] = rng.integers(0, 8, n).astype(np.uint32)
    cols["timestamp"] = (1_700_000_000 + np.arange(n) // 1_000_000
                         ).astype(np.uint32)
    cols["duration_us"] = rng.integers(10, 10_000_000, n).astype(np.uint32)
    for ci, comp in enumerate(comps):
        if comp["source"] == "pool":
            continue
        if comp["source"] != "unique":
            raise ValueError(f"unknown component source {comp['source']!r}")
        pos = np.nonzero(which == ci)[0]
        net, n_addr = net4(comp["src_net"])
        plo, phi = (int(x) for x in comp["src_ports"])
        n_ports = phi - plo + 1
        m = n_addr * n_ports
        u = Unique(pos=pos, a=_coprime(rng, m), b=int(rng.integers(0, m)),
                   m=m, net=net, port_lo=plo, n_ports=n_ports)
        unique.append(u)
        cols["ip_src"][pos], cols["port_src"][pos] = u.src(
            np.arange(len(pos), dtype=np.uint64))
        dst = comp.get("dst", "pool")
        if dst != "pool":
            cols["ip_dst"][pos] = ip4(dst["ip"])
            cols["port_dst"][pos] = int(dst["port"])
            cols["proto"][pos] = int(dst["proto"])
        for name, value in comp.get("columns", {}).items():
            cols[name][pos] = value
    return {name: np.ascontiguousarray(cols[name], dtype=dt)
            for name, dt in L4_COLUMNS}


def _assign_protocols(mass: np.ndarray, shares: np.ndarray) -> np.ndarray:
    """Endpoint -> protocol index, walking endpoints from the heaviest
    and giving each to the protocol furthest below its share of the
    request mass, so the requests split as the shares say."""
    got = np.zeros(len(shares))
    out = np.empty(len(mass), np.int64)
    for i in np.argsort(-mass, kind="stable"):
        k = int(np.argmax(shares - got))
        out[i] = k
        got[k] += mass[i]
    return out


def _l7_bank(mix: dict, seed: int, n: int) -> Dict[str, np.ndarray]:
    rng = rng_of(seed, "l7:" + mix.get("name", ""))
    ep = mix["endpoints"]
    n_ep = int(ep["count"])
    a = float(ep["zipf_a"])
    net, n_addr = net4(ep["net"])
    protos = mix["protocols"]
    shares = np.array([float(p["share"]) for p in protos])
    if abs(shares.sum() - 1.0) > 1e-9:
        raise ValueError("protocol shares must sum to 1")
    perm = rng.permutation(n_ep)            # rank -> endpoint
    mass = np.empty(n_ep)
    mass[perm] = np.arange(1, n_ep + 1, dtype=np.float64) ** -a
    proto_of = _assign_protocols(mass / mass.sum(), shares)
    ips = (net + rng.choice(n_addr, n_ep, replace=False)).astype(np.uint32)
    ports = np.empty(n_ep, np.uint32)
    for k, p in enumerate(protos):
        at = np.nonzero(proto_of == k)[0]
        ports[at] = rng.choice(np.array(p["ports"], np.uint32), len(at))
    codes = np.array([int(p["protocol"]) for p in protos], np.uint32)
    rr = mix["rrt_us"]
    scale = rng.lognormal(0.0, float(rr["service_sigma"]), n_ep)
    e = perm[zipf_ranks(rng, a, n_ep, n)]
    pk = proto_of[e]
    u = rng.random(n)
    s_err = float(mix["server_error_share"])
    c_err = float(mix["client_error_share"])
    status = np.empty(n, np.uint32)
    for k, p in enumerate(protos):
        at = pk == k
        m = int(at.sum())
        pick = {kind: np.array(p[kind], np.uint32)[
            rng.integers(0, len(p[kind]), m)]
            for kind in ("ok", "server_error", "client_error")}
        uk = u[at]
        status[at] = np.where(uk < s_err, pick["server_error"],
                              np.where(uk < s_err + c_err,
                                       pick["client_error"], pick["ok"]))
    rrt = float(rr["median"]) * rng.lognormal(0.0, float(rr["sigma"]), n) \
        * scale[e]
    rrt = np.clip(np.rint(rrt), int(rr["min"]), int(rr["max"]))
    return {"ip_dst": ips[e], "port_dst": ports[e], "protocol": codes[pk],
            "status": status, "rrt_us": rrt.astype(np.uint32)}


def make_bank(mix_name: str, seed: int,
              mix: Optional[dict] = None) -> Bank:
    """The bank of mix `mix_name` (or of the given mix dict) for a seed."""
    return Bank(mix if mix is not None else load_mix(mix_name), seed)
