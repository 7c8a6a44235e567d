"""df-ctl: the deepflow-ctl equivalent ops CLI.

Reference: cli/ctl/ (cobra `deepflow-ctl`): agent listing, agent-group
config CRUD, domain resource management, queries, and the ingester UDP
debug client. Run as `python -m deepflow_tpu_torch.cli <cmd> ...`.

The port's own copy of the JAX package's `cli.py`: it talks to the
port's controller, querier and debug servers (any server of the same
protocols answers it). `replay-pcap` and `capture` build the port's
`Agent`, whose flow map runs on `--device` (the card by default).
`lint` and `verify` run the port's own `analysis/` over the port's tree
against its own stores (`analysis/stores/`).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request

from deepflow_tpu_torch.runtime.debug import DEFAULT_DEBUG_PORT, debug_request

CONTROLLER = "http://127.0.0.1:20417"
QUERIER = "http://127.0.0.1:20416"


def _http(url: str, body=None, form: str = None, method: str = None):
    data = None
    headers = {}
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    elif form is not None:
        data = form.encode()
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.load(resp)
    except urllib.error.HTTPError as e:
        # both servers put the real message in a JSON error body; surface
        # it as a failure so commands exit non-zero instead of printing
        # the error dict as a result
        try:
            body = json.loads(e.read().decode())
        except ValueError:
            raise e from None
        raise RuntimeError(body.get("error", body)) from None


def _table(rows, columns):
    if not rows:
        print("(empty)")
        return
    widths = [max(len(str(c)), *(len(str(r[i])) for r in rows))
              for i, c in enumerate(columns)]
    print("  ".join(str(c).ljust(w) for c, w in zip(columns, widths)))
    for r in rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(r, widths)))


def cmd_agent_upgrade(args) -> int:
    """Staged fleet upgrade (reference: deepflow-ctl agent upgrade +
    trident.proto rpc Upgrade): upload a package, target a group at a
    revision, watch convergence."""
    import base64
    import os as _os
    if args.action == "push":
        if not args.package or not args.revision:
            print("push requires --package <file> and --revision")
            return 2
        with open(args.package, "rb") as f:
            data = f.read()
        name = _os.path.basename(args.package)
        up = _http(f"{args.controller}/v1/upgrade-package",
                   body={"name": name,
                         "data_b64": base64.b64encode(data).decode()})
        out = _http(f"{args.controller}/v1/upgrade",
                    body={"group": args.group, "revision": args.revision,
                          "package": name})
        print(json.dumps({"uploaded": up, "targets": out}, indent=2))
    elif args.action == "status":
        print(json.dumps(_http(f"{args.controller}/v1/upgrade"),
                         indent=2, sort_keys=True))
    else:                                          # cancel
        out = _http(f"{args.controller}/v1/upgrade/"
                    f"{urllib.parse.quote(args.group, safe='')}",
                    method="DELETE")
        print(json.dumps(out, indent=2))
    return 0


def cmd_agent(args) -> int:
    if args.action == "list":
        vtaps = _http(f"{args.controller}/v1/vtaps")
        _table([[v["vtap_id"], v["ctrl_ip"], v["host"], v["group"],
                 "ALIVE" if v["alive"] else "OFFLINE", v["revision"]]
                for v in vtaps],
               ["ID", "CTRL_IP", "HOST", "GROUP", "STATE", "REVISION"])
    else:
        # live-agent debug protocol (reference: deepflow-ctl agent ...
        # against agent/src/debug/'s UDP server)
        if args.debug_port is None:
            print("agent debug commands require --debug-port "
                  "(agents have no default debug port)")
            return 2
        out = debug_request(args.action, port=args.debug_port)
        print(json.dumps(out, indent=2, sort_keys=True))
    return 0


# every key the agent's pushed-RuntimeConfig hot-apply honors
# (Agent._apply_config), with the defaults it assumes when absent —
# the reference's `deepflow-ctl agent-group-config example` role
GROUP_CONFIG_EXAMPLE = """\
# deepflow-tpu agent-group config (pushed RuntimeConfig).
# CRUD as yaml: df-ctl agent-group-config set --group g --file cfg.yaml
# Keys absent from a push keep their current value on the agent.

# self-protection limits enforced by the guard thread
max_memory_mb: 768        # RSS ceiling; breach -> callbacks fire
max_cpus: 1               # CPU-fraction ceiling

# L7 protocol log collection on/off (payload parsing cost)
l7_log_enabled: true

# controller sync cadence, seconds
sync_interval_s: 60

# agent-side L7 session rate cap per second (reference:
# l7_log_collect_nps_threshold); 0 = uncapped. Sessions past the
# budget drop at the agent, counted in l7_throttled.
l7_log_rate: 10000

# l4 flow-log aggregation interval (collector/flow_aggr role):
# 0 ships every 1s tick row; 60 = one merged row per flow per minute
# (the metrics fork always stays at 1s). Hot-switchable; switching
# drains the stash through the next tick.
l4_log_aggr_s: 0

# L7 parser plugins. Omitted (or null) = not managed by this group:
# agents keep whatever they loaded statically. A LIST is authoritative
# and hot-converges agents to exactly it — so an explicit [] unloads
# every plugin. Uncomment deliberately:
# so_plugins: ["/opt/plugins/custom.so"]   # .so over df_plugin.h
# wasm_plugins: ["/opt/plugins/custom.wasm"]  # sandboxed wasm

# trace-context header extraction (ordered: first present header wins;
# custom keys decode raw). Omitted/null = agents keep their defaults.
# http_log_trace_id: [traceparent, sw8]
# http_log_span_id: [traceparent, sw8]
# http_log_x_request_id: [x-request-id]
# http_log_proxy_client: [x-forwarded-for, x-real-ip]
"""


def cmd_group_config(args) -> int:
    if args.action == "example":
        print(GROUP_CONFIG_EXAMPLE, end="")
        return 0
    url = f"{args.controller}/v1/vtap-group-config?group={args.group}"
    if args.action == "set":
        body = {}
        if args.file:
            import yaml
            with open(args.file) as f:
                doc = yaml.safe_load(f) or {}
            if not isinstance(doc, dict):
                raise RuntimeError(f"{args.file}: expected a yaml mapping")
            body.update(doc)
        for kv in args.set or []:
            k, _, v = kv.partition("=")
            try:
                body[k] = json.loads(v)
            except ValueError:
                body[k] = v
        if not body:
            raise RuntimeError("set requires --file and/or --set KEY=VALUE")
        out = _http(url, body=body)
        print(json.dumps(out))
    else:
        if args.set or args.file:
            # an older form was `agent-group-config --set k=v`
            # (no action); silently doing a GET would drop the change
            print("did you mean: agent-group-config set --set/--file ...")
            return 2
        print(json.dumps(_http(url), indent=2, sort_keys=True))
    return 0


def cmd_domain(args) -> int:
    with open(args.file) as f:
        resources = json.load(f)
    if isinstance(resources, dict):
        resources = resources.get("resources", [])
    out = _http(f"{args.controller}/v1/domains/"
                f"{urllib.parse.quote(args.name, safe='')}/resources",
                body={"resources": resources})
    print(json.dumps(out))
    return 0


def cmd_cloud(args) -> int:
    base = f"{args.controller}/v1/cloud"
    if args.action != "list" and not args.name:
        raise RuntimeError(f"cloud {args.action} requires a domain name")
    if args.action == "add":
        need = {"filereader": args.path, "http": args.url}
        if args.platform in need and not need[args.platform]:
            raise RuntimeError(
                f"--{'path' if args.platform == 'filereader' else 'url'} "
                f"is required for platform {args.platform}")
        body = {"domain": args.name, "platform": args.platform,
                "interval_s": args.interval}
        if args.platform == "filereader":
            body["path"] = args.path
        elif args.platform == "http":
            body["url"] = args.url
        elif args.platform == "kubernetes_gather":
            body["cluster"] = args.cluster or args.name
        if args.config:
            # vendor platforms (aws/aliyun/tencent/huawei/qingcloud/
            # baidubce) carry credentials + regions/endpoints in a
            # JSON file merged into the create body — the positional
            # name and --platform stay authoritative (a config copied
            # from another setup must not silently redirect the
            # create), and a non-object file fails crisply
            with open(args.config) as f:
                cfg = json.load(f)
            if not isinstance(cfg, dict):
                raise RuntimeError(
                    f"{args.config}: expected a JSON object")
            for reserved in ("domain", "platform"):
                if cfg.pop(reserved, None) is not None:
                    print(f"note: ignoring {reserved!r} from "
                          f"{args.config} (command line wins)",
                          file=sys.stderr)
            body.update(cfg)
        elif args.platform not in ("filereader", "http",
                                   "kubernetes_gather"):
            raise RuntimeError(
                f"--config is required for platform {args.platform}")
        print(json.dumps(_http(f"{base}/domains", body=body)))
    elif args.action == "list":
        rows = _http(f"{base}/tasks")
        _table([[t["domain"], t["platform"], t["gathers_ok"],
                 t["gathers_failed"], t["resource_count"],
                 round(t["last_cost_s"], 3), t["last_error"] or "-"]
                for t in rows],
               ["DOMAIN", "PLATFORM", "OK", "FAILED", "RESOURCES",
                "COST_S", "LAST_ERROR"])
    elif args.action == "refresh":
        q = urllib.parse.quote(args.name, safe="")
        print(json.dumps(_http(
            f"{args.controller}/v1/domains/{q}/refresh", body={})))
    elif args.action == "delete":
        q = urllib.parse.quote(args.name, safe="")
        print(json.dumps(_http(f"{base}/domains/{q}", method="DELETE")))
    return 0


def cmd_genesis(args) -> int:
    doc = _http(f"{args.controller}/v1/genesis/export")
    rows = [[d, r["type"], r["id"], r["name"], r.get("ip", "-")]
            for d, rs in sorted(doc.get("domains", {}).items())
            for r in rs]
    _table(rows, ["DOMAIN", "TYPE", "ID", "NAME", "IP"])
    return 0


def cmd_recorder(args) -> int:
    # one JSON document on stdout (pipe-safe, like the other
    # JSON-emitting subcommands)
    print(json.dumps(_http(f"{args.controller}/v1/recorder"),
                     indent=2, sort_keys=True))
    return 0


def cmd_resource(args) -> int:
    qs = f"?type={args.type}" if args.type else ""
    rows = _http(f"{args.controller}/v1/resources{qs}")
    _table([[r["type"], r["id"], r["name"], r["domain"]] for r in rows],
           ["TYPE", "ID", "NAME", "DOMAIN"])
    return 0


def cmd_ingester(args) -> int:
    if args.action == "set":   # full membership replace (rebalances fleet)
        out = _http(f"{args.controller}/v1/ingesters",
                    body={"addrs": args.addrs})
        print(json.dumps(out))
    elif args.action == "assignments":
        print(json.dumps(_http(f"{args.controller}/v1/assignments"),
                         indent=2))
    elif args.action == "datasource":
        req = {"op": args.op}
        if args.interval is not None:
            req["interval"] = args.interval
        if args.ttl is not None:
            req["ttl"] = args.ttl
        if args.keep_data:
            req["drop"] = False
        out = debug_request("datasource",
                            port=args.debug_port or DEFAULT_DEBUG_PORT,
                            **req)
        print(json.dumps(out, indent=2, sort_keys=True))
    elif args.action == "queue-tap":
        out = debug_request("queue-tap",
                            port=args.debug_port or DEFAULT_DEBUG_PORT,
                            module=args.module or "",
                            count=args.count)
        print(json.dumps(out, indent=2, sort_keys=True))
    elif args.action in ("counters", "vtap-status", "ping", "stacks",
                         "artifacts", "queues", "supervisor", "breakers",
                         "spill", "lint"):
        # lint self-scans ~250 files inside the debug loop: seconds, not
        # the protocol's usual milliseconds — give it a matching timeout
        out = debug_request(args.action,
                            port=args.debug_port or DEFAULT_DEBUG_PORT,
                            timeout=30.0 if args.action == "lint" else 2.0,
                            **({"module": args.module} if args.module
                               else {}))
        print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_query(args) -> int:
    if args.snapshots:
        # one-shot sketch point query straight off a snapshot directory:
        # no querier server needed — the SnapshotBus disk
        # store IS the serving format, so `df-ctl query --snapshots
        # <ckpt_dir> "SELECT sketch.topk(10) FROM sketch"` answers from
        # the newest snapshot a live (or dead) ingester left behind.
        from deepflow_tpu_torch.querier.sql import Select, parse_sql
        from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
        from deepflow_tpu_torch.serving import SketchTables, SnapshotCache
        stmt = parse_sql(args.sql)
        if not (isinstance(stmt, Select) and stmt.table == "sketch"):
            print("--snapshots serves the sketch datasource only "
                  "(SELECT sketch.* FROM sketch)", file=sys.stderr)
            return 2
        bus = SnapshotBus(args.snapshots)
        # offline snapshots are stale by definition: serve the newest
        # one regardless of age (its `time` column says how old it is)
        tables = SketchTables(SnapshotCache(bus,
                                            max_staleness_s=float("inf")))
        res = tables.sql(stmt)
        _table(res.values, res.columns)
        return 0
    form = urllib.parse.urlencode(
        {"sql": args.sql, **({"db": args.db} if args.db else {})})
    out = _http(f"{args.querier}/v1/query", form=form)
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 1
    res = out["result"]
    _table(res["values"], res["columns"])
    return 0


def cmd_incident(args) -> int:
    """Flight-recorder bundles: list/show/export straight
    off the incident directory — like `query --snapshots`, no live
    ingester needed (the bundles are fsynced precisely so they outlive
    the process that captured them)."""
    import os
    import tarfile
    import time

    from deepflow_tpu_torch.runtime.incident import IncidentRecorder

    rec = IncidentRecorder(args.dir)
    if args.action == "list":
        rows = [[m["id"], m["kind"],
                 time.strftime("%Y-%m-%d %H:%M:%S",
                               time.localtime(m.get("wall_time", 0))),
                 m.get("bytes", 0), len(m.get("files", {}))]
                for m in rec.list()]
        _table(rows, ["id", "kind", "time", "bytes", "files"])
        return 0
    if not args.id:
        print("--id required for show/export "
              "(list ids with `incident list`)", file=sys.stderr)
        return 2
    m = rec.manifest(args.id)
    if m is None:
        print(f"no bundle {args.id!r} under {args.dir}", file=sys.stderr)
        return 1
    if args.action == "show":
        bundle = {"manifest": m}
        for fname in ("trigger.json", "snapbus.json"):
            p = os.path.join(m["path"], fname)
            if os.path.isfile(p):
                with open(p, "r", encoding="utf-8") as f:
                    bundle[fname.split(".")[0]] = json.load(f)
        print(json.dumps(bundle, indent=2, sort_keys=True))
        return 0
    # export: one portable .tar.gz of the bundle directory
    out = args.out or f"{args.id}.tar.gz"
    with tarfile.open(out, "w:gz") as tar:
        tar.add(m["path"], arcname=args.id)
    print(f"wrote {out} ({os.path.getsize(out)} bytes, "
          f"{len(m.get('files', {}))} files)")
    return 0


def cmd_trace(args) -> int:
    """The trace family. `expand` (default with --id) assembles an L7
    trace from one row id (the L7FlowTracing role). `latency`, `spans`
    and `rrt` read the ingester's flight recorder over the UDP debug
    protocol: per-stage latency quantiles, recent slow-batch spans, and
    device transfer/kernel attribution."""
    if args.action == "expand":
        if args.id is None:
            print("trace expand requires --id <l7_flow_log row _id>",
                  file=sys.stderr)
            return 2
        out = _http(f"{args.querier}/v1/l7_tracing?_id={args.id}")
        rows = [[s["attributes"].get("_id", "-"),
                 s["operationName"] or "-",
                 s["attributes"].get("ip.src", "-"),
                 s["attributes"].get("ip.dst", "-"),
                 s["attributes"].get("syscall_trace_id.request", "-"),
                 s["attributes"].get("syscall_trace_id.response", "-"),
                 s["durationNanos"] // 1000]
                for s in out["spans"]]
        _table(rows, ["_ID", "OPERATION", "SRC", "DST", "SYSCALL_REQ",
                      "SYSCALL_RESP", "DUR_US"])
        return 0
    port = args.debug_port or DEFAULT_DEBUG_PORT
    if args.action == "latency":
        out = debug_request("latency", port=port,
                            **({"module": args.stage} if args.stage
                               else {}))
        if not out.get("ok"):
            print(f"error: {out.get('error')}", file=sys.stderr)
            return 1
        data = out["data"]
        if not data.get("enabled"):
            print("tracing disabled on this ingester "
                  "(IngesterConfig.trace_enabled)", file=sys.stderr)
        _table([[st, v["count"], round(v["p50_ms"], 3),
                 round(v["p95_ms"], 3), round(v["p99_ms"], 3),
                 round(v["max_ms"], 3), round(v["mean_ms"], 3)]
                for st, v in sorted(data["stages"].items())],
               ["STAGE", "COUNT", "P50_MS", "P95_MS", "P99_MS",
                "MAX_MS", "MEAN_MS"])
        occ = data.get("occupancy")
        if occ:
            # the continuous occupancy profiler's verdict:
            # is the chip busy, and who is at fault when it isn't
            print()
            _table([[occ.get("device_busy_fraction", 0.0),
                     occ.get("feed_overlap_efficiency", 0.0),
                     occ.get("feed_stall_seconds", 0.0)]],
                   ["DEVICE_BUSY_FRAC", "FEED_OVERLAP_EFF",
                    "FEED_STALL_S"])
        return 0
    if args.action == "export":
        # occupancy timeline -> Chrome-trace/Perfetto JSON (loads in
        # ui.perfetto.dev / chrome://tracing)
        out = debug_request("trace-export", port=port,
                            limit=args.count or 175)
        if not out.get("ok"):
            print(f"error: {out.get('error')}", file=sys.stderr)
            return 1
        doc = out["data"]["trace"]
        body = json.dumps(doc)
        if args.out and args.out != "-":
            with open(args.out, "w") as f:
                f.write(body)
            print(f"wrote {len(doc['traceEvents'])} events "
                  f"({out['data']['spans_recorded']} spans recorded) "
                  f"to {args.out}")
        else:
            print(body)
        return 0
    if args.action == "spans":
        req = {"count": args.count or 20}
        if args.stage:
            req["stage"] = args.stage
        if args.slow_ms is not None:
            req["slow_ms"] = args.slow_ms
        out = debug_request("spans", port=port, **req)
        if not out.get("ok"):
            print(f"error: {out.get('error')}", file=sys.stderr)
            return 1
        import time as _time
        _table([[_time.strftime("%H:%M:%S", _time.localtime(s["ts"])),
                 s["stage"], s["stream"] or "-", s["batch_id"],
                 round(s["dur_ms"], 3), s["rows"]]
                for s in out["data"]["spans"]],
               ["AT", "STAGE", "STREAM", "BATCH", "DUR_MS", "ROWS"])
        return 0
    # rrt: device transfer/kernel attribution
    out = debug_request("rrt", port=port)
    if not out.get("ok"):
        print(f"error: {out.get('error')}", file=sys.stderr)
        return 1
    data = out["data"]
    _table([[st, v["count"], round(v["p50_ms"], 3), round(v["p99_ms"], 3),
             round(v["mean_ms"], 3)]
            for st, v in sorted(data["kernel_stages"].items())],
           ["KERNEL_STAGE", "COUNT", "P50_MS", "P99_MS", "MEAN_MS"])
    for name, value in sorted(data["gauges"].items()):
        print(f"{name} = {round(value, 3)}")
    return 0


def _device(args) -> dict:
    """The Agent's `device` keyword where --device was given."""
    return {} if args.device is None else {"device": args.device}


def cmd_replay_pcap(args) -> int:
    """Replay a pcap fixture through a capture agent into an ingester
    (reference role: agent/resources/test replays + droplet send tools)."""
    from deepflow_tpu_torch.agent.pcap import PcapFrameSource
    from deepflow_tpu_torch.agent.trident import Agent, AgentConfig

    agent = Agent(AgentConfig(ingester_addr=args.ingester,
                              l7_enabled=not args.no_l7),
                  **_device(args))
    agent.set_vtap_id(args.vtap_id)
    src = PcapFrameSource(args.path)
    valid = src.feed_agent(agent, batch_size=args.batch)
    sent = agent.tick()
    agent.close()
    print(json.dumps({"frames": src.frames_read, "valid_packets": valid,
                      **sent}))
    return 0


def cmd_capture(args) -> int:
    """Live AF_PACKET capture -> agent -> ingester (reference role: the
    dispatcher recv_engine; requires CAP_NET_RAW)."""
    import time as _time

    from deepflow_tpu_torch.agent.afpacket import (AfPacketSource, CaptureLoop,
                                                   TpacketV3Source)
    from deepflow_tpu_torch.agent.trident import Agent, AgentConfig

    try:
        # open the capture socket FIRST: the common failure (missing
        # CAP_NET_RAW) must not leave a started agent behind
        if args.ring:
            source = TpacketV3Source(iface=args.iface)
        else:
            source = AfPacketSource(iface=args.iface)
    except PermissionError:
        print("error: live capture requires CAP_NET_RAW (run as root)",
              file=sys.stderr)
        return 1
    agent = Agent(AgentConfig(ingester_addr=args.ingester,
                              l7_enabled=not args.no_l7),
                  **_device(args))
    agent.set_vtap_id(args.vtap_id)
    agent.start()
    loop = CaptureLoop(source, agent)
    loop.start()
    try:
        deadline = _time.time() + args.seconds if args.seconds else None
        while deadline is None or _time.time() < deadline:
            _time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        # kernel drop stats come off the live socket: read BEFORE close
        stats = source.statistics() if hasattr(source, "statistics") \
            else None
        loop.close()
        agent.close()
    counters = {**loop.counters(), **agent.counters()}
    if stats is not None:
        counters["kernel_packets"], counters["kernel_drops"] = stats
    print(json.dumps(counters))
    return 0


def cmd_lint(args) -> int:
    """deepflow-lint (deepflow_tpu_torch/analysis/): AST invariant checks
    for the pipeline's concurrency / trace-safety / metrics disciplines.
    The zero-arg form self-scans the installed port package; --baseline
    gates on NEW findings only (the port's committed baseline is
    analysis/stores/lint-baseline.json); --twins/--ack-twin manage the
    host/device twin fingerprints (analysis/stores/lint-twins.json) the
    twin-drift rule gates on; --programs/--ack-programs and
    --schemas/--ack-schemas manage the jit cache-key store
    (lint-programs.json, retrace-hazard) and the durable-pytree schema
    store (lint-schemas.json, pytree-schema-drift) under exactly the
    twin-store contract; --sarif writes the gated findings as SARIF
    2.1.0 for CI annotation."""
    from deepflow_tpu_torch import analysis
    from deepflow_tpu_torch.analysis import core as _ana_core
    from deepflow_tpu_torch.analysis import devprog as _ana_devprog
    from deepflow_tpu_torch.analysis import twins as _ana_twins

    if args.list_rules:
        for name, cls in sorted(analysis.all_rules().items()):
            print(f"{name} [{cls.severity}]: {cls.description}")
        return 0
    rules = [r.strip() for r in args.rules.split(",") if r.strip()] \
        if args.rules else None
    twins_path = args.twins or _ana_core.default_twin_store_path()
    if args.ack_twin:
        # re-acknowledge every declared twin pair: recompute normalized
        # fingerprints from the CURRENT tree and rewrite the store. The
        # bit-identity tests in the same CI run are what make this an
        # informed signature, not a rubber stamp.
        files = _ana_core.load_path_sources(args.paths) if args.paths \
            else _ana_core.load_package_sources()
        _ctxs, index, errors = _ana_core.build_index(files)
        if errors:
            print(analysis.format_findings(errors), file=sys.stderr)
            return 2
        store, missing = _ana_twins.build_store(index)
        if missing:
            print("--ack-twin refuses unresolvable twin refs "
                  "(fix the registry first):", file=sys.stderr)
            for m in missing:
                print(f"  {m}", file=sys.stderr)
            return 2
        if args.paths:
            # partial scope: MERGE into the existing store — a scan
            # that never saw a pair must not silently un-acknowledge
            # it (only the full self-scan may drop pairs)
            try:
                prior = _ana_twins.load_store(twins_path)
            except FileNotFoundError:
                prior = None
            if prior is not None:
                merged = dict(prior.get("pairs", {}))
                merged.update(store["pairs"])
                store["pairs"] = merged
                print(f"note: path-scoped ack merged into "
                      f"{len(merged)} committed pair(s); only a full "
                      f"self-scan ack drops pairs", file=sys.stderr)
        _ana_twins.save_store(store, twins_path)
        print(f"twin store updated: {len(store['pairs'])} pair(s) "
              f"acknowledged -> {twins_path}")
        return 0
    programs_path = args.programs or _ana_core.default_programs_store_path()
    schemas_path = args.schemas or _ana_core.default_schemas_store_path()
    if args.ack_programs or args.ack_schemas:
        # the device-plane acks: recompute from the CURRENT tree and
        # rewrite the store(s) — same contract as --ack-twin, including
        # the partial-scope MERGE (a scan that never saw a site/schema
        # must not silently un-acknowledge it)
        files = _ana_core.load_path_sources(args.paths) if args.paths \
            else _ana_core.load_package_sources()
        _ctxs, index, errors = _ana_core.build_index(files)
        if errors:
            print(analysis.format_findings(errors), file=sys.stderr)
            return 2
        for enabled, build, load, save, key, path, what in (
                (args.ack_programs, _ana_devprog.build_programs_store,
                 _ana_devprog.load_programs_store,
                 _ana_devprog.save_programs_store, "programs",
                 programs_path, "jit program"),
                (args.ack_schemas, _ana_devprog.build_schemas_store,
                 _ana_devprog.load_schemas_store,
                 _ana_devprog.save_schemas_store, "schemas",
                 schemas_path, "schema")):
            if not enabled:
                continue
            store, missing = build(index)
            if missing:
                print(f"--ack-{key} refuses unresolvable refs "
                      f"(fix the registry first):", file=sys.stderr)
                for m in missing:
                    print(f"  {m}", file=sys.stderr)
                return 2
            if args.paths:
                try:
                    prior = load(path)
                except FileNotFoundError:
                    prior = None
                if prior is not None:
                    merged = dict(prior.get(key, {}))
                    merged.update(store[key])
                    store[key] = merged
                    print(f"note: path-scoped ack merged into "
                          f"{len(merged)} committed {what}(s); only a "
                          f"full self-scan ack drops entries",
                          file=sys.stderr)
            save(store, path)
            print(f"{key} store updated: {len(store[key])} {what}(s) "
                  f"acknowledged -> {path}")
        return 0
    twin_store = "auto"
    if args.twins:
        try:
            twin_store = _ana_twins.load_store(args.twins)
        except FileNotFoundError:
            twin_store = None       # no store yet: pairs read as unacked
    programs_store = "auto"
    if args.programs:
        try:
            programs_store = _ana_devprog.load_programs_store(args.programs)
        except FileNotFoundError:
            programs_store = None   # no store yet: sites read as unacked
    schemas_store = "auto"
    if args.schemas:
        try:
            schemas_store = _ana_devprog.load_schemas_store(args.schemas)
        except FileNotFoundError:
            schemas_store = None    # no store yet: schemas read as unacked
    findings = analysis.run_lint(args.paths or None, rules=rules,
                                 twin_store=twin_store,
                                 programs_store=programs_store,
                                 schemas_store=schemas_store)
    if args.update_baseline:
        if not args.baseline:
            print("--update-baseline requires --baseline FILE",
                  file=sys.stderr)
            return 2
        if rules:
            # a rule-subset scan rewriting the baseline would silently
            # delete every OTHER rule's grandfathered entries — the next
            # full gate then fails on all of them as "new"
            print("--update-baseline refuses --rules: a subset scan "
                  "would drop the other rules' grandfathered findings",
                  file=sys.stderr)
            return 2
        if args.paths:
            print("note: baseline updated from an explicit path scope — "
                  "gate with the same paths, or findings outside them "
                  "will read as new", file=sys.stderr)
        analysis.save_baseline(findings, args.baseline)
        print(f"baseline updated: {len(findings)} grandfathered "
              f"finding(s) -> {args.baseline}")
        return 0
    gated = findings
    if args.baseline:
        gated = analysis.new_findings(findings,
                                      analysis.load_baseline(args.baseline))
    if args.sarif:
        doc = analysis.findings_to_sarif(gated)
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
    if args.json:
        print(analysis.findings_to_json(gated))
    else:
        print(analysis.format_findings(gated))
        if args.baseline and len(findings) > len(gated):
            print(f"({len(findings) - len(gated)} baselined finding(s) "
                  f"suppressed)")
    return 1 if gated else 0


def cmd_verify(args) -> int:
    """deepflow-model (deepflow_tpu_torch/analysis/model/): exhaustive
    explicit-state checking of the pod epoch (single-host shard ladder
    AND the cross-host host ladder), spill/drain and sender retransmit
    protocols. The zero-flag form sweeps every model plus the
    conformance gate; --protocol pod covers both pod granularities
    (pod + hostpod); --mutants runs the seeded kill sweep
    (every mutant must die with a counterexample); --mutant NAME runs
    one mutant and prints its counterexample schedule; --ack-conform
    rewrites the committed analysis/stores/model-conform.json from the
    current tree
    (run AFTER a green `df-ctl verify` — the ack is the informed
    signature tying the models to the code).

    Exit codes: 0 = proven; 1 = violation / surviving mutant /
    conformance drift; 2 = budget exhausted (INCOMPLETE — a partial
    sweep is not a proof) or usage error."""
    import time as _time

    from deepflow_tpu_torch import analysis
    from deepflow_tpu_torch.analysis import core as _ana_core
    from deepflow_tpu_torch.analysis.model import (PROTOCOLS, check,
                                                   expand_protocol,
                                                   model_for, render_trace)
    from deepflow_tpu_torch.analysis.model import conform as _conform
    from deepflow_tpu_torch.analysis.model.mutate import (all_mutants,
                                                          kill_all)

    if args.list_mutants:
        for proto, name, why in all_mutants():
            print(f"{proto}/{name}: {why}")
        return 0

    if args.ack_conform:
        files = _ana_core.load_package_sources()
        _ctxs, index, errors = _ana_core.build_index(files)
        if errors:
            print(analysis.format_findings(errors), file=sys.stderr)
            return 2
        store, missing = _conform.build_store(index)
        if missing:
            print("--ack-conform refuses unresolvable model refs "
                  "(fix the CONFORMANCE contracts first):",
                  file=sys.stderr)
            for m in missing:
                print(f"  {m}", file=sys.stderr)
            return 2
        path = args.conform or _ana_core.default_conform_store_path()
        _conform.save_store(store, path)
        print(f"conformance store updated: "
              f"{len(store['protocols'])} protocol(s) acknowledged "
              f"-> {path}")
        return 0

    deadline = None
    if args.budget_s is not None:
        deadline = _time.monotonic() + args.budget_s

    def remaining():
        if deadline is None:
            return None
        return max(0.0, deadline - _time.monotonic())

    texts = []
    rc = 0

    def emit(text: str) -> None:
        texts.append(text)
        if not args.json:
            print(text)

    if args.mutant:
        cands = expand_protocol(args.protocol) if args.protocol else None
        protos = sorted({p for p, n, _w in all_mutants()
                         if n == args.mutant
                         and (cands is None or p in cands)}) \
            or list(cands or ())
        if len(protos) != 1:
            print(f"--mutant {args.mutant}: unknown mutant (see "
                  f"--list-mutants), or ambiguous without --protocol",
                  file=sys.stderr)
            return 2
        try:
            model = model_for(protos[0], args.mutant)
        except ValueError as e:
            # a typo'd protocol/mutant pair is a USAGE error (2) —
            # exit 1 is reserved for "the checker found the bug"
            print(f"error: {e}", file=sys.stderr)
            return 2
        res = check(model, max_faults=args.max_faults,
                    budget_s=remaining())
        emit(render_trace(res))
        results = [res]
        # for a mutant run, "found the bug" IS the expected outcome:
        # exit 1 (a violation was found), so a gate can assert the
        # checker kills a live injected bug
        rc = 2 if not res.complete and res.violation is None \
            else (1 if res.violation is not None else 0)
    elif args.mutants:
        report = kill_all(protocol=args.protocol,
                          max_faults=args.max_faults,
                          budget_s=args.budget_s)
        results = []
        for (proto, name), res in sorted(report.results.items()):
            results.append(res)
            v = res.violation
            verdict = "KILLED" if v is not None else (
                "INCOMPLETE" if not res.complete else "SURVIVED")
            detail = f" ({v.kind}/{v.name}, {len(v.trace)}-step trace)" \
                if v is not None else ""
            emit(f"mutant {proto}/{name}: {verdict}{detail}  "
                 f"[{res.states} states, {res.elapsed_s:.2f}s]")
        if report.survivors:
            emit(f"SURVIVING mutant(s): the checker has a blind spot: "
                 f"{report.survivors}")
            rc = 1
        elif report.incomplete:
            emit(f"INCOMPLETE mutant sweep(s) within the budget: "
                 f"{report.incomplete}")
            rc = 2
        else:
            emit(f"mutation self-test: all "
                 f"{len(report.results)} seeded mutants killed")
    else:
        protos = list(expand_protocol(args.protocol)) if args.protocol \
            else list(PROTOCOLS)
        results = []
        for proto in protos:
            res = check(model_for(proto), max_faults=args.max_faults,
                        budget_s=remaining())
            results.append(res)
            emit(render_trace(res))
            if not res.complete and res.violation is None:
                rc = max(rc, 2)
            elif res.violation is not None:
                rc = max(rc, 1)
        if args.protocol is None and rc == 0:
            # whole-sweep runs also gate model<->code conformance (the
            # same check the lint rule rides in CI)
            findings = analysis.run_lint(rules=["model-conform"])
            if findings:
                emit(analysis.format_findings(findings))
                rc = 1
            else:
                emit("conformance: models and code agree "
                     "(.model-conform.json acknowledged)")
    if args.trace_out:
        with open(args.trace_out, "w", encoding="utf-8") as fh:
            fh.write("\n\n".join(texts) + "\n")
    if args.json:
        print(json.dumps([r.to_dict() for r in results], indent=1))
    return rc


def cmd_promql(args) -> int:
    if (args.start is None) != (args.end is None):
        print("error: --start and --end must be given together",
              file=sys.stderr)
        return 1
    if args.time is not None and args.start is not None:
        print("error: --time conflicts with --start/--end",
              file=sys.stderr)
        return 1
    if args.start is not None and args.end is not None:
        qs = urllib.parse.urlencode({"query": args.expr, "start": args.start,
                                     "end": args.end, "step": args.step})
        out = _http(f"{args.querier}/api/v1/query_range?{qs}")
    else:
        qs = urllib.parse.urlencode(
            {"query": args.expr,
             **({"time": args.time} if args.time else {})})
        out = _http(f"{args.querier}/api/v1/query?{qs}")
    print(json.dumps(out, indent=2))
    return 0 if out.get("status") == "success" else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="df-ctl", description="deepflow-tpu ops CLI")
    p.add_argument("--controller", default=CONTROLLER)
    p.add_argument("--querier", default=QUERIER)
    # None = "not given": ingester commands fall back to the ingester's
    # well-known debug port; agent debug commands REQUIRE it (agents
    # have no default port — a colocated ingester would answer the same
    # protocol and its counters would masquerade as the agent's)
    p.add_argument("--debug-port", type=int, default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("agent", help="agent fleet + live-agent debug")
    a.add_argument("action",
                   choices=["list", "ping", "counters", "stacks",
                            "policy", "rpc", "platform", "plugins"],
                   help="list = fleet via controller; the rest query a "
                        "live agent's UDP debug server (--debug-port)")
    a.set_defaults(fn=cmd_agent)

    au = sub.add_parser("agent-upgrade",
                        help="staged fleet upgrade: push/status/cancel")
    au.add_argument("action", choices=["push", "status", "cancel"])
    au.add_argument("--group", default="default")
    au.add_argument("--package", help="package file to upload (push)")
    au.add_argument("--revision", help="target revision string (push)")
    au.set_defaults(fn=cmd_agent_upgrade)

    g = sub.add_parser("agent-group-config",
                       help="group config CRUD (yaml or KEY=VALUE)")
    g.add_argument("action", nargs="?", default="get",
                   choices=["get", "set", "example"])
    g.add_argument("--group", default="default")
    g.add_argument("--file", help="yaml config document for set")
    g.add_argument("--set", nargs="*", metavar="KEY=VALUE")
    g.set_defaults(fn=cmd_group_config)

    d = sub.add_parser("domain", help="push a domain resource snapshot")
    d.add_argument("name")
    d.add_argument("-f", "--file", required=True)
    d.set_defaults(fn=cmd_domain)

    c = sub.add_parser("cloud", help="cloud domain pollers")
    c.add_argument("action",
                   choices=["add", "list", "refresh", "delete"])
    c.add_argument("name", nargs="?", help="domain name")
    c.add_argument("--platform", default="filereader",
                   choices=["filereader", "http", "kubernetes_gather",
                            "aws", "aliyun", "tencent", "huawei",
                            "qingcloud", "baidubce"])
    c.add_argument("--path", help="resource document (filereader)")
    c.add_argument("--url", help="snapshot URL (http)")
    c.add_argument("--cluster", help="cluster name (kubernetes_gather)")
    c.add_argument("--config", help="JSON file merged into the domain "
                   "body (vendor credentials/regions/endpoints — "
                   "secrets stay off the command line)")
    c.add_argument("--interval", type=float, default=60.0)
    c.set_defaults(fn=cmd_cloud)

    r = sub.add_parser("resource", help="list resources")
    r.add_argument("--type")
    r.set_defaults(fn=cmd_resource)

    ge = sub.add_parser("genesis", help="agent-reported genesis resources")
    ge.set_defaults(fn=cmd_genesis)

    rec = sub.add_parser("recorder",
                         help="recorder counters + tombstones")
    rec.set_defaults(fn=cmd_recorder)

    i = sub.add_parser("ingester", help="ingester membership + debug")
    i.add_argument("action", choices=["set", "assignments", "counters",
                                      "vtap-status", "ping", "stacks",
                                      "artifacts", "datasource",
                                      "queues", "queue-tap",
                                      "supervisor", "breakers", "spill",
                                      "lint"])
    i.add_argument("addrs", nargs="*")
    i.add_argument("--module")
    i.add_argument("--op", default="list",
                   choices=["list", "add", "del", "retention"],
                   help="datasource: rollup-tier CRUD "
                        "(deepflow-ctl domain datasource role)")
    i.add_argument("--interval", type=int,
                   help="datasource tier in seconds (whole minutes)")
    i.add_argument("--ttl", type=int,
                   help="retention seconds (0 = keep forever)")
    i.add_argument("--count", type=int, default=3,
                   help="queue-tap: items to sample")
    i.add_argument("--keep-data", action="store_true",
                   help="datasource del: detach the tier but keep rows")
    i.set_defaults(fn=cmd_ingester)

    q = sub.add_parser("query", help="run DeepFlow-SQL")
    q.add_argument("sql")
    q.add_argument("-d", "--db")
    q.add_argument("--snapshots",
                   help="one-shot sketch point query off a snapshot "
                        "directory (the ingester's sketch_ckpt dir) — "
                        "no querier server needed")
    q.set_defaults(fn=cmd_query)

    pq = sub.add_parser("promql", help="run a PromQL instant/range query")
    pq.add_argument("expr")
    pq.add_argument("--time", type=int)
    pq.add_argument("--start", type=int)
    pq.add_argument("--end", type=int)
    pq.add_argument("--step", type=int, default=60)
    pq.set_defaults(fn=cmd_promql)

    cp = sub.add_parser("capture",
                        help="live AF_PACKET capture -> agent -> ingester")
    cp.add_argument("--iface", default=None,
                    help="interface (default: all)")
    cp.add_argument("--ingester", default="127.0.0.1:30033")
    cp.add_argument("--vtap-id", type=int, default=1)
    cp.add_argument("--seconds", type=float, default=0,
                    help="capture duration (0 = until interrupt)")
    cp.add_argument("--no-l7", action="store_true")
    cp.add_argument("--ring", action="store_true",
                    help="TPACKET_V3 mmap ring (zero per-packet "
                         "syscalls, kernel timestamps + drop counters)")
    cp.add_argument("--device", default=None,
                    help="where the agent's flow map runs (default: the "
                         "Agent's, the card)")
    cp.set_defaults(fn=cmd_capture)

    tr = sub.add_parser("trace",
                        help="l7 trace expansion + the ingester flight "
                             "recorder (latency/spans/rrt)")
    tr.add_argument("action", nargs="?", default="expand",
                    choices=["expand", "latency", "spans", "rrt",
                             "export"],
                    help="expand = assemble an l7 trace from --id; "
                         "latency = per-stage p50/p95/p99 tables + "
                         "occupancy row; "
                         "spans = recent (slow) batch spans; "
                         "rrt = device transfer/kernel attribution; "
                         "export = occupancy timeline as Chrome-trace/"
                         "Perfetto JSON")
    tr.add_argument("--id", type=int, default=None,
                    help="seed l7_flow_log row _id (expand)")
    tr.add_argument("--stage", help="stage filter (latency prefix / "
                                    "spans exact)")
    tr.add_argument("--count", type=int, default=None,
                    help="spans: max spans to list (default 20); "
                         "export: max events of each ring (default and "
                         "cap 175 — the one-datagram budget)")
    tr.add_argument("--slow-ms", type=float, default=None,
                    help="spans: only spans slower than this")
    tr.add_argument("--out", default="-",
                    help="export: output file ('-' = stdout)")
    tr.set_defaults(fn=cmd_trace)

    ln = sub.add_parser(
        "lint", help="deepflow-lint: AST invariant checks (concurrency /"
                     " trace-safety / metrics disciplines)")
    ln.add_argument("paths", nargs="*",
                    help="files or directories (default: the installed "
                         "package)")
    ln.add_argument("--baseline",
                    help="grandfathered-findings JSON; exit status gates "
                         "on NEW findings only")
    ln.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from the current findings "
                         "(review the diff: it should only shrink)")
    ln.add_argument("--rules", help="comma-separated rule subset")
    ln.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ln.add_argument("--sarif", metavar="FILE",
                    help="write gated findings as SARIF 2.1.0 (CI "
                         "annotation surfaces)")
    ln.add_argument("--twins", metavar="FILE",
                    help="twin-fingerprint store for the twin-drift "
                         "rule (default: the committed "
                         "analysis/stores/lint-twins.json)")
    ln.add_argument("--ack-twin", action="store_true",
                    help="re-acknowledge all declared host/device twin "
                         "pairs: recompute fingerprints and rewrite the "
                         "store (run the bit-identity tests first)")
    ln.add_argument("--programs", metavar="FILE",
                    help="jit cache-key store for the retrace-hazard "
                         "rule (default: the committed "
                         "analysis/stores/lint-programs.json)")
    ln.add_argument("--ack-programs", action="store_true",
                    help="re-acknowledge every jit site's cache-key "
                         "fingerprint and compiled-program bound "
                         "(review retrace risk first)")
    ln.add_argument("--schemas", metavar="FILE",
                    help="durable-pytree schema store for the "
                         "pytree-schema-drift rule (default: the "
                         "committed analysis/stores/lint-schemas.json)")
    ln.add_argument("--ack-schemas", action="store_true",
                    help="re-acknowledge every declared state pytree's "
                         "leaf layout (run the snapshot round-trip "
                         "tests first)")
    ln.add_argument("--list-rules", action="store_true",
                    help="list rules with their one-line descriptions")
    ln.set_defaults(fn=cmd_lint)

    vf = sub.add_parser(
        "verify", help="deepflow-model: exhaustive explicit-state "
                       "checking of the pod epoch / spill / sender "
                       "protocols (+ the code-conformance gate)")
    vf.add_argument("--protocol",
                    choices=["pod", "hostpod", "spill", "sender"],
                    help="check one protocol ('pod' covers both the "
                         "single-host and cross-host pod models; "
                         "default: all models + the conformance gate)")
    vf.add_argument("--budget-s", type=float, default=None,
                    help="total wall-clock budget; an unfinished sweep "
                         "exits 2 (INCOMPLETE), never a silent pass")
    vf.add_argument("--max-faults", type=int, default=2,
                    help="fault-injection budget per execution "
                         "(default 2 — the CI acceptance bound)")
    vf.add_argument("--trace-out", metavar="FILE",
                    help="write the verdicts + any counterexample "
                         "schedule to FILE")
    vf.add_argument("--mutants", action="store_true",
                    help="mutation self-test: every seeded mutant must "
                         "die with a counterexample")
    vf.add_argument("--mutant", metavar="NAME",
                    help="run ONE seeded mutant and print its "
                         "counterexample (exit 1 = killed, the "
                         "expected outcome)")
    vf.add_argument("--list-mutants", action="store_true",
                    help="list the seeded mutants per protocol")
    vf.add_argument("--ack-conform", action="store_true",
                    help="re-acknowledge the model<->code conformance "
                         "fingerprints (model-conform.json); run "
                         "after a green `df-ctl verify`")
    vf.add_argument("--conform", metavar="FILE",
                    help="conformance store path (default: the "
                         "committed analysis/stores/model-conform.json)")
    vf.add_argument("--json", action="store_true",
                    help="machine-readable results on stdout")
    vf.set_defaults(fn=cmd_verify)

    inc = sub.add_parser(
        "incident", help="flight-recorder bundles: list/show/export "
                         "off an incident directory (no live ingester "
                         "needed)")
    inc.add_argument("action", nargs="?", default="list",
                     choices=["list", "show", "export"])
    inc.add_argument("--dir", required=True,
                     help="incident directory (the ingester's "
                          "<store_path>/incidents, or incident_dir)")
    inc.add_argument("--id", help="bundle id (show/export)")
    inc.add_argument("--out",
                     help="export: output .tar.gz path "
                          "(default <id>.tar.gz)")
    inc.set_defaults(fn=cmd_incident)

    rp = sub.add_parser("replay-pcap",
                        help="replay a pcap through an agent -> ingester")
    rp.add_argument("path")
    rp.add_argument("--ingester", default="127.0.0.1:30033")
    rp.add_argument("--vtap-id", type=int, default=1)
    rp.add_argument("--batch", type=int, default=4096)
    rp.add_argument("--no-l7", action="store_true")
    rp.add_argument("--device", default=None,
                    help="where the agent's flow map runs (default: the "
                         "Agent's, the card)")
    rp.set_defaults(fn=cmd_replay_pcap)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
