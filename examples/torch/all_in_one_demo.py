"""The whole product in one process on the PyTorch/CUDA port: controller
+ ingester + querier + a live agent, driven end to end, the device
analytics on the card.

What a reference (dzy176/deepflow) user gets after switching:

1. all-in-one server boots (election -> resource model -> receiver ->
   pipelines -> querier), as `server/cmd/server/main.go` does;
2. a cloud domain is registered (filereader poller) and agent-reported
   genesis interfaces land beside it;
3. a real Agent syncs against the controller, captures packet frames
   (synthetic eth/ipv4/tcp here), runs flow generation + L7 parsing,
   and ships flows/metrics/l7 logs over the firehose wire;
4. the ingester decodes, enriches with platform data, stores, and the
   device analytics exporters keep heavy-hitter/cardinality/entropy and
   per-service RED windows;
5. DeepFlow-SQL answers over the stored data, including the sketch
   outputs (top-K rows resolve to human-readable 5-tuples; RED rows
   carry DDSketch latency quantiles).

Run:  python examples/torch/all_in_one_demo.py [--device cuda|cpu]

The server's exporters and the agent's flow map run on the card unless
`--device cpu` is given; without a card the demo raises. Step 3b, the
kernel capture filter, runs where `agent.bpf.available()` says this host
loads socket-filter eBPF, and prints why not elsewhere.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import urllib.parse
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _req(url: str, body=None, form: dict | None = None):
    data = None
    headers = {}
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    elif form is not None:
        data = urllib.parse.urlencode(form).encode()
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.load(resp)


def run(device="cuda") -> dict:
    """The seven steps on `device`; the SQL answers of steps 5-7 (the
    result objects of /v1/query and /v1/l7_tracing)."""
    import numpy as np

    from deepflow_tpu_torch.agent.trident import Agent, AgentConfig
    from deepflow_tpu_torch.server import Server

    tmp = tempfile.mkdtemp(prefix="df-demo-")

    # -- 1. all-in-one server ---------------------------------------------
    cfg_path = f"{tmp}/server.yaml"
    with open(cfg_path, "w") as f:
        f.write(f"""
controller:
  port: 0
  lease_path: {tmp}/lease.json
ingester:
  port: 0
  store_path: {tmp}/store
  debug_port: 0
  tpu_sketch_window_s: 3600
  app_red_window_s: 3600
querier:
  port: 0
""")
    server = Server(cfg_path, device=device)
    server.start()
    ctl = f"http://127.0.0.1:{server.controller.port}"
    q = f"http://127.0.0.1:{server.querier.port}"
    print(f"server up: controller={server.controller.port} "
          f"ingester={server.ingester.port} querier={server.querier.port}")

    # -- 2. cloud domain + resources --------------------------------------
    with open(f"{tmp}/cloud.json", "w") as f:
        json.dump({
            "vpcs": [{"name": "prod-vpc"}],
            "subnets": [{"name": "web-subnet", "vpc": "prod-vpc",
                         "cidr": "10.0.0.0/16", "epc_id": 1}],
            "pod_clusters": [{"name": "prod"}],
            "pod_namespaces": [{"name": "default",
                                "pod_cluster": "prod"}],
            "services": [{"name": "api", "vpc": "prod-vpc",
                          "ip": "10.0.0.5", "port": 80}],
        }, f)
    _req(f"{ctl}/v1/cloud/domains",
         {"domain": "aws-prod", "platform": "filereader",
          "path": f"{tmp}/cloud.json", "interval_s": 3600})
    r = _req(f"{ctl}/v1/domains/aws-prod/refresh", {})
    print(f"cloud domain gathered: {r['resource_count']} resources")

    # -- 3. live agent (with a sandboxed wasm parser plugin) ---------------
    from deepflow_tpu_torch.agent.wasm_samples import build_memcached_wasm
    wasm_path = f"{tmp}/memcached.wasm"
    with open(wasm_path, "wb") as f:
        f.write(build_memcached_wasm())
    agent = Agent(AgentConfig(
        ctrl_ip="10.1.2.3", host="demo-node", controller_url=ctl,
        ingester_addr=f"127.0.0.1:{server.ingester.port}",
        wasm_plugins=(wasm_path,)), device=device)
    assert agent.sync_once()
    print(f"agent registered: vtap_id={agent.vtap_id}  "
          f"wasm plugins: {[p.name for p in agent.wasm_plugins.values()]}")

    # synthetic capture: an HTTP conversation between two pods, a
    # memcached lookup (parsed by the wasm plugin), and an internet
    # client whose address the geo table maps to a region
    from deepflow_tpu_torch.replay import eth_ipv4_tcp, ip4
    CLIENT, SERVER = ip4(10, 0, 0, 1), ip4(10, 0, 0, 2)
    INET = ip4(192, 0, 2, 55)            # TEST-NET-1: in the geo sample
    T0 = int(time.time() * 1e9)
    frames = [
        eth_ipv4_tcp(CLIENT, SERVER, 41000, 80, 0x02, b"", seq=0),   # SYN
        eth_ipv4_tcp(SERVER, CLIENT, 80, 41000, 0x12, b"", seq=0),   # SYNACK
        eth_ipv4_tcp(CLIENT, SERVER, 41000, 80, 0x10,
                     b"GET /api/users HTTP/1.1\r\nHost: api\r\n\r\n",
                     seq=1),
        eth_ipv4_tcp(SERVER, CLIENT, 80, 41000, 0x10,
                     b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok",
                     seq=1),
        eth_ipv4_tcp(CLIENT, SERVER, 41002, 11211, 0x10,
                     b"get session:42\r\n", seq=1),
        eth_ipv4_tcp(SERVER, CLIENT, 11211, 41002, 0x10,
                     b"END\r\n", seq=1),
        eth_ipv4_tcp(INET, SERVER, 52000, 80, 0x10,
                     b"GET /api/health HTTP/1.1\r\nHost: api\r\n\r\n",
                     seq=1),
        eth_ipv4_tcp(SERVER, INET, 80, 52000, 0x10,
                     b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok",
                     seq=1),
    ]
    stamps = np.asarray([T0 + i * 400_000 for i in range(len(frames))],
                        np.uint64)
    fed = agent.feed(frames, stamps)
    sent = agent.tick(T0 + 1_000_000_000)
    print(f"agent: {fed} packets -> sent {sent}")

    # -- 3b. kernel eBPF capture filter on live loopback -------------------
    # the recv_engine's BPF injection, end to end: an in-tree-assembled
    # filter runs IN KERNEL on a real socket; non-matching packets never
    # reach userspace, and the verdict counters live in a BPF map
    from deepflow_tpu_torch.agent import bpf as bpf_mod
    if bpf_mod.available():
        import socket as _socket
        from deepflow_tpu_torch.agent.afpacket import AfPacketSource
        filt = bpf_mod.BpfFilter(proto=17, port=53530)
        # prepare hook: the filter lands on the socket BEFORE bind, so
        # the server's own loopback chatter can't slip in pre-attach
        csrc = AfPacketSource("lo", batch_size=512, poll_ms=150,
                              prepare=filt.attach_socket)
        csrc.bpf = filt
        tx = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        for i in range(20):
            tx.sendto(b"demo-match", ("127.0.0.1", 53530))
            tx.sendto(b"demo-noise", ("127.0.0.1", 49999))
        tx.close()
        time.sleep(0.2)
        live_frames, _ = csrc.read_batch()
        noise = sum(1 for f in live_frames if b"demo-noise" in f)
        c = filt.counters()
        csrc.close()
        filt.close()
        assert noise == 0, "kernel filter leaked non-matching packets"
        print(f"kernel eBPF filter: {c['bpf_seen']} pkts seen in kernel, "
              f"{c['bpf_accepted']} accepted, {len(live_frames)} "
              f"delivered, 0 noise")
    else:
        print("kernel eBPF filter: not run (agent.bpf.available() is False: "
              "this host refuses a socket-filter eBPF program through bpf(2))")

    # -- 4. ingester + sketches -------------------------------------------
    deadline = time.time() + 15
    while time.time() < deadline:
        server.ingester.flush()
        try:
            counts = [_req(f"{q}/v1/query", form={
                "db": "flow_log",
                "sql": f"SELECT Count(*) AS n FROM {t}",
            })["result"]["values"][0][0] for t in ("l4_flow_log",
                                                   "l7_flow_log")]
            if all(counts):
                break
        except Exception:
            pass
        time.sleep(0.2)

    # -- 5. queries --------------------------------------------------------
    flows = _req(f"{q}/v1/query", form={
        "db": "flow_log",
        "sql": "SELECT ip_src, ip_dst, port_dst, l7_protocol, "
               "Sum(byte_tx) AS bytes FROM l4_flow_log "
               "GROUP BY ip_src, ip_dst, port_dst, l7_protocol",
    })["result"]
    print("\nl4 flows:")
    print("  " + " | ".join(flows["columns"]))
    for row in flows["values"]:
        print("  " + " | ".join(str(v) for v in row))

    l7 = _req(f"{q}/v1/query", form={
        "db": "flow_log",
        "sql": "SELECT l7_protocol, endpoint_hash, status, rrt_us "
               "FROM l7_flow_log",
    })["result"]
    print("\nl7 requests:")
    for row in l7["values"]:
        print("  " + " | ".join(str(v) for v in row))

    tags = _req(f"{q}/v1/query", form={
        "db": "flow_log", "sql": "SHOW TAGS FROM l4_flow_log"})["result"]
    print(f"\nSHOW TAGS: {len(tags['values'])} tags available")

    # the internet client's flow oriented server-side (port 80 is the
    # service), so the client region is the _1 side
    geo = _req(f"{q}/v1/query", form={
        "db": "flow_log",
        "sql": "SELECT province_1, ip_dst, port_dst FROM l4_flow_log "
               "WHERE province_1 = 'TEST-NET-1'"})["result"]
    print("\ninternet-client flows by region (geo enrichment):")
    for row in geo["values"]:
        print("  " + " | ".join(str(v) for v in row))
    assert geo["values"], "geo-stamped flow missing"

    # runtime datasource CRUD: add a 1h rollup tier over the debug socket
    from deepflow_tpu_torch.runtime.debug import debug_request
    ds = debug_request("datasource", port=server.ingester.debug.port,
                       op="add", interval=3600)["data"]
    print(f"\ndatasource add: {ds['table']} (ttl {ds['ttl_seconds']}s)")

    # -- 6. device analytics: top-K heavy hitters + per-service RED --------
    # the exporters consume their queues asynchronously: wait for the
    # processed-rows watermark before closing the window, or it flushes
    # empty (same discipline as the exporter tests)
    deadline = time.time() + 15
    while time.time() < deadline and not (
            server.ingester.tpu_sketch.rows_in
            and server.ingester.app_red.rows_in):
        time.sleep(0.1)
    server.ingester.tpu_sketch.flush_window()
    server.ingester.app_red.flush_window()
    server.ingester.flush()
    topk = _req(f"{q}/v1/query", form={
        "db": "tpu_sketch",
        "sql": "SELECT rank, ip_src, ip_dst, port_dst, count "
               "FROM topk_flows ORDER BY count DESC LIMIT 3"})["result"]
    print("\ntop flows (device sketches, resolved 5-tuples):")
    for row in topk["values"]:
        print("  " + " | ".join(str(v) for v in row))
    red = _req(f"{q}/v1/query", form={
        "db": "tpu_sketch",
        "sql": "SELECT service_group, requests, errors, rrt_p95_us "
               "FROM app_red"})["result"]
    print("\nper-service RED (DDSketch quantiles):")
    for row in red["values"]:
        print("  " + " | ".join(str(v) for v in row))

    # -- 7. tracing without instrumentation: eBPF syscall records for a
    # client -> svc-a -> svc-b call path reassemble into ONE trace from
    # any row via syscall trace ids (GET /v1/l7_tracing)
    from deepflow_tpu_torch.agent.ebpf_source import (EbpfTracer,
                                                      SyscallRecord,
                                                      T_EGRESS, T_INGRESS)
    tracer = EbpfTracer(vtap_id=9)
    t0 = time.time_ns()
    REQ_A = b"GET /api/orders HTTP/1.1\r\nHost: svc-a\r\n\r\n"
    REQ_B = b"GET /stock/check HTTP/1.1\r\nHost: svc-b\r\n\r\n"
    RESP = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"
    CLI_IP, A_IP, B_IP = 0x0A000063, 0x0A000064, 0x0A000065
    recs = [
        SyscallRecord(10, 7, T_INGRESS, t0, CLI_IP, A_IP, 5000, 80,
                      tcp_seq=1, payload=REQ_A, process_kname="svc-a"),
        SyscallRecord(10, 7, T_EGRESS, t0 + 2_000_000, A_IP, B_IP,
                      42000, 80, tcp_seq=2, payload=REQ_B,
                      process_kname="svc-a"),
        SyscallRecord(10, 7, T_INGRESS, t0 + 8_000_000, B_IP, A_IP,
                      80, 42000, tcp_seq=3, payload=RESP,
                      process_kname="svc-a"),
        SyscallRecord(10, 7, T_EGRESS, t0 + 9_000_000, A_IP, CLI_IP,
                      80, 5000, tcp_seq=4, payload=RESP,
                      process_kname="svc-a"),
    ]
    wires = [w for r in recs if (w := tracer.feed(r)) is not None]
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.wire.framing import MessageType
    ebpf_sender = UniformSender(
        MessageType.PROTOCOLLOG,
        f"127.0.0.1:{server.ingester.port}", vtap_id=9)
    ebpf_sender.send(wires)
    ebpf_sender.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        server.ingester.flush()
        seeds = _req(f"{q}/v1/query", form={
            "db": "flow_log",
            "sql": "SELECT ip_dst, _id FROM l7_flow_log "
                   "WHERE signal_source = 3 GROUP BY ip_dst, _id",
        })["result"]["values"]
        if len(seeds) >= 2:
            break
        time.sleep(0.2)
    assert len(seeds) >= 2, "eBPF rows did not land"
    trace = _req(f"{q}/v1/l7_tracing?_id={seeds[0][1]}")
    print("\nl7 tracing (no instrumentation, chained on syscall ids):")
    for s in trace["spans"]:
        print(f"  {s['operationName'] or '-':28s}"
          f"ip.dst={s['attributes']['ip.dst']}"
          f"  syscall_req={s['attributes'].get('syscall_trace_id.request', '-')}")
    assert len(trace["spans"]) >= 2, "trace did not chain"

    agent.close()
    server.close()
    print("\ndemo OK")
    return {"flows": flows, "l7": l7, "geo": geo, "topk": topk, "red": red,
            "trace": trace}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
