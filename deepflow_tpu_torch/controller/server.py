"""Controller HTTP API (reference: server/controller/http/ routers).

Agent-facing (the trisolaris sync surface, JSON over HTTP instead of
gRPC — the reference's message/trident.proto Synchronizer service):
  POST /v1/sync             {ctrl_ip, host, revision?, boot?,
                             processes?: [{pid, name, start_time}]}
                            -> vtap_id, config, config_version,
                               platform_version, ingester,
                               gpids? (GPIDSync), upgrade? (staged)
  POST /v1/genesis          {ctrl_ip, host, interfaces: [...]}
  GET  /v1/genesis/export   locally-owned genesis domains (peer pull)

Ops-facing (driven by the CLI):
  GET  /v1/vtaps            fleet listing with liveness
  GET  /v1/vtap-groups      group names
  GET/POST /v1/vtap-group-config?group=g     config CRUD
  POST /v1/domains/<name>/resources          full domain snapshot
  GET  /v1/resources[?type=pod]
  GET  /v1/cloud/tasks      per-domain poller info + cost
  POST /v1/cloud/domains    {domain, platform: filereader|http|kubernetes_gather, ...}
  DELETE /v1/cloud/domains/<name>
  POST /v1/domains/<name>/refresh            trigger an immediate gather
  GET  /v1/platform-data    compiled enrichment tables + version
  GET  /v1/election         leader status
  POST /v1/ingesters        {addrs: [...]} membership for rebalancing
  GET  /v1/assignments
  POST /v1/upgrade-package  {name, data_b64} upload (sha256 returned)
  GET  /v1/upgrade-package?name=             download
  POST /v1/upgrade          {group, revision, package} target a group
  GET  /v1/upgrade          fleet convergence status
  DELETE /v1/upgrade/<group>

The port's own copy of the JAX package's `controller/server.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from deepflow_tpu_torch.controller.cloud import (CloudManager,
                                                 FileReaderPlatform,
                                                 HttpPlatform,
                                                 KubernetesGatherPlatform,
                                                 rows_to_resources)
from deepflow_tpu_torch.controller.election import Election
from deepflow_tpu_torch.controller.model import ResourceModel, make_resource
from deepflow_tpu_torch.controller.monitor import FleetMonitor
from deepflow_tpu_torch.controller.platform_compiler import \
    compile_platform_data
from deepflow_tpu_torch.controller.registry import VTapRegistry
from deepflow_tpu_torch.controller.tagrecorder import TagRecorder

DEFAULT_PORT = 20417   # reference controller HTTP is 20417 in-cluster


class ControllerServer:
    def __init__(self, model: ResourceModel, registry: VTapRegistry,
                 monitor: Optional[FleetMonitor] = None,
                 election: Optional[Election] = None,
                 tagrecorder: Optional[TagRecorder] = None,
                 genesis_domain: str = "genesis",
                 genesis_peers=None,
                 cloud_resource_dir: Optional[str] = None,
                 package_dir: Optional[str] = None,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1") -> None:
        self.model = model
        # filereader domains may only read documents under this directory
        # (None = anywhere, for single-user dev). Without the fence, the
        # unauthenticated ops API would be a file-probing primitive: any
        # controller-readable path could be fed to the gather loop and
        # its parse errors read back from /v1/cloud/tasks.
        self.cloud_resource_dir = (os.path.realpath(cloud_resource_dir)
                                   if cloud_resource_dir else None)
        from deepflow_tpu_torch.controller.genesis_sync import GenesisSync
        from deepflow_tpu_torch.controller.recorder import Recorder
        self.recorder = Recorder(model)
        self.cloud = CloudManager(self.recorder)
        self.process_record_errors = 0
        self._proc_record_calls = 0
        self.genesis_sync = GenesisSync(model, peers=genesis_peers or ())
        self.registry = registry
        self.monitor = monitor or FleetMonitor(registry)
        self.election = election
        self.tagrecorder = tagrecorder
        self.genesis_domain = genesis_domain
        # upgrade packages: memory cache, optional disk persistence —
        # the upgrade TARGET persists in the registry file, so the
        # package must survive a controller restart too or a
        # mid-rollout restart strands the fleet on 404s
        self._packages: Dict[str, bytes] = {}
        self.package_dir = package_dir
        if package_dir is not None:
            os.makedirs(package_dir, exist_ok=True)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length).decode() if length else "{}"
                return json.loads(raw or "{}")

            def do_GET(self) -> None:
                try:
                    url = urllib.parse.urlparse(self.path)
                    qs = {k: v[0] for k, v in
                          urllib.parse.parse_qs(url.query).items()}
                    self._send(200, outer._get(url.path, qs))
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def do_POST(self) -> None:
                try:
                    url = urllib.parse.urlparse(self.path)
                    qs = {k: v[0] for k, v in
                          urllib.parse.parse_qs(url.query).items()}
                    self._send(200, outer._post(url.path, qs, self._body()))
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def do_DELETE(self) -> None:
                try:
                    url = urllib.parse.urlparse(self.path)
                    self._send(200, outer._delete(url.path))
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- routing -----------------------------------------------------------
    def _get(self, path: str, qs: dict):
        if path == "/v1/health":
            # liveness/readiness for deploy probes (manifests/k8s): cheap,
            # no model access beyond version reads
            return {"ok": True, "is_leader": self.election.is_leader
                    if self.election is not None else True,
                    "model_version": self.model.version}
        if path == "/v1/vtaps":
            status = self.monitor.check()
            return [{**vars(v), "alive": f"{v.ctrl_ip}|{v.host}"
                     in status["alive"]} for v in self.registry.list()]
        if path == "/v1/vtap-groups":
            return self.registry.groups()
        if path == "/v1/vtap-group-config":
            return self.registry.get_config(qs.get("group", "default"))
        if path == "/v1/resources":
            return [{"type": r.type, "id": r.id, "name": r.name,
                     "domain": r.domain, **dict(r.attrs)}
                    for r in self.model.list(type=qs.get("type"))]
        if path == "/v1/platform-data":
            ifaces, cidrs, services, version = compile_platform_data(
                self.model)
            return {
                "version": version,
                "interfaces": [vars(i) for i in ifaces],
                "cidrs": [vars(c) for c in cidrs],
                "services": [vars(s) for s in services],
            }
        if path == "/v1/genesis/export":
            return {"domains": self.genesis_sync.export()}
        if path == "/v1/election":
            if self.election is None:
                return {"leader": True, "identity": "standalone"}
            return {"leader": self.election.is_leader,
                    "identity": self.election.identity}
        if path == "/v1/assignments":
            return self.monitor.assignments()
        if path == "/v1/cloud/tasks":
            return [vars(i) for i in self.cloud.tasks()]
        if path == "/v1/recorder":
            # recorder debug surface (reference: deepflow-ctl recorder):
            # counters + soft-deleted rows still inside retention
            return {**self.recorder.counters(),
                    "process_record_errors": self.process_record_errors,
                    "genesis": self.genesis_sync.counters(),
                    "tombstones_rows": [
                        {"type": r.type, "id": r.id, "name": r.name,
                         "domain": r.domain}
                        for r in self.recorder.deleted_resources()]}
        if path == "/v1/upgrade":
            return self.registry.upgrade_status()
        if path == "/v1/upgrade-package":
            import base64
            import hashlib
            data = self.package_bytes(qs.get("name", ""))
            if data is None:
                raise KeyError(qs.get("name", ""))
            sha = hashlib.sha256(data).hexdigest()
            if qs.get("meta"):
                # metadata-only probe: agents validate their plugin
                # cache against this without re-downloading the bytes
                return {"name": qs["name"], "size": len(data),
                        "sha256": sha}
            return {"name": qs["name"],
                    "data_b64": base64.b64encode(data).decode(),
                    "sha256": sha}
        if path == "/health":
            return {"status": "ok"}
        raise KeyError(path)

    def _post(self, path: str, qs: dict, body: dict):
        if path == "/v1/sync":
            resp = self.registry.sync(body["ctrl_ip"], body["host"],
                                      body.get("revision", ""),
                                      bool(body.get("boot")),
                                      processes=body.get("processes"))
            if body.get("processes") and resp.get("gpids"):
                self._record_processes(resp["vtap_id"],
                                       body["processes"],
                                       resp["gpids"])
            resp["platform_version"] = self.model.version
            resp["ingester"] = self.monitor.assign(body["ctrl_ip"],
                                                   body["host"])
            return resp
        if path == "/v1/upgrade-package":
            # package bytes ride base64 inside the JSON control plane
            # (reference: rpc Upgrade streams chunks; one body here).
            # Held in memory: packages are transient distribution
            # artifacts, not durable state.
            import base64
            import hashlib
            name = body["name"]
            if "/" in name or name.startswith("."):
                raise ValueError("package name must be a bare filename")
            data = base64.b64decode(body["data_b64"])
            self._packages[name] = data
            if self.package_dir is not None:
                tmp = os.path.join(self.package_dir, name + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, os.path.join(self.package_dir, name))
            return {"name": name, "size": len(data),
                    "sha256": hashlib.sha256(data).hexdigest()}
        if path == "/v1/upgrade":
            import hashlib
            pkg = body["package"]
            data = self.package_bytes(pkg)
            if data is None:
                raise KeyError(f"unknown package {pkg!r}")
            self.registry.set_upgrade(
                body.get("group", "default"), body["revision"], pkg,
                hashlib.sha256(data).hexdigest())
            return self.registry.upgrade_status()
        if path == "/v1/genesis":
            return self.genesis_report(body["host"],
                                       body.get("interfaces", []))
        if path == "/v1/vtap-group-config":
            version = self.registry.set_config(qs.get("group", "default"),
                                               body)
            return {"config_version": version}
        if path.startswith("/v1/domains/") and path.endswith("/resources"):
            domain = urllib.parse.unquote(
                path[len("/v1/domains/"):-len("/resources")])
            snapshot = rows_to_resources(body.get("resources", []), domain)
            diff = self.recorder.reconcile(domain, snapshot)
            return {"created": len(diff.created),
                    "deleted": len(diff.deleted),
                    "updated": len(diff.updated),
                    "orphaned": len(diff.orphaned),
                    "field_changes": [
                        {"type": c.type, "id": c.id, "field": c.field,
                         "old": c.old, "new": c.new}
                        for c in diff.field_changes],
                    "version": self.model.version}
        if path == "/v1/ingesters":
            self.monitor.set_ingesters(list(body.get("addrs", [])))
            return {"ingesters": self.monitor.ingesters()}
        if path == "/v1/cloud/domains":
            if not isinstance(body.get("domain"), str) or not body["domain"]:
                raise ValueError("domain must be a non-empty string")
            task = self.cloud.add(
                body["domain"], self._make_platform(body),
                interval_s=float(body.get("interval_s", 60.0)))
            return {"domain": task.domain, "platform": task.info.platform,
                    "auth_failed": task.info.auth_failed}
        if path.startswith("/v1/domains/") and path.endswith("/refresh"):
            domain = urllib.parse.unquote(
                path[len("/v1/domains/"):-len("/refresh")])
            task = self.cloud.get(domain)
            if task is None:
                raise KeyError(domain)
            ok = task.gather_once()   # synchronous: the CLI wants the diff
            return {"domain": domain, "ok": ok,
                    "error": task.info.last_error,
                    "resource_count": task.info.resource_count,
                    "version": self.model.version}
        raise KeyError(path)

    def genesis_report(self, host: str, interfaces: list) -> dict:
        """Agent-reported interfaces become resources in a PER-AGENT
        genesis domain (reference: controller/genesis sinks keyed by
        vtap) — one shared domain would let each agent's snapshot
        delete every other agent's rows. Ids must be restart-stable
        (content hash); only well-formed IPv4 addresses enter as host
        rows (a bad row would poison every later platform-data
        compile); mac-keyed ip-less entries (libvirt guest NICs) become
        vinterface rows. Shared by the JSON route and the trident gRPC
        GenesisSync rpc so the two ingest paths cannot diverge."""
        import ipaddress

        from deepflow_tpu_torch.store.dict_store import fnv1a32
        domain = f"{self.genesis_domain}/{host}"
        snapshot = []
        for i, itf in enumerate(interfaces):
            try:
                ipaddress.IPv4Address(itf["ip"])
            except (KeyError, ValueError):
                # no (valid) ip: a libvirt guest NIC report is
                # mac-keyed (agent libvirt_xml_extractor role) —
                # model it as a vinterface row under the owning VM
                if itf.get("mac") and itf.get("domain_name"):
                    key = f"{host}|{itf['mac']}"
                    snapshot.append(make_resource(
                        "vinterface",
                        2_000_000 + (fnv1a32(key.encode()) & 0xFFFFF),
                        f"{itf['domain_name']}:{itf.get('name', i)}",
                        domain=domain,
                        mac=itf["mac"],
                        vm_name=itf["domain_name"],
                        vm_uuid=itf.get("domain_uuid", ""),
                        host=host))
                continue
            snapshot.append(make_resource(
                "host",
                1_000_000 + (fnv1a32(
                    f"{host}|{itf['ip']}".encode()) & 0xFFFFF),
                f"{host}:{itf.get('name', i)}",
                domain=domain,
                ip=itf["ip"], epc_id=itf.get("epc_id", 0)))
        diff = self.model.update_domain(domain, snapshot)
        self.genesis_sync.mark_local(domain)
        return {"created": len(diff.created),
                "deleted": len(diff.deleted)}

    def package_bytes(self, name: str) -> Optional[bytes]:
        """Memory first, then the persisted copy (controller restart
        mid-rollout must not strand the fleet)."""
        data = self._packages.get(name)
        if data is None and self.package_dir is not None and name \
                and "/" not in name and not name.startswith("."):
            try:
                with open(os.path.join(self.package_dir, name),
                          "rb") as f:
                    data = f.read()
                self._packages[name] = data
            except OSError:
                return None
        return data

    def _delete(self, path: str):
        if path.startswith("/v1/upgrade/"):
            group = urllib.parse.unquote(path[len("/v1/upgrade/"):])
            if not self.registry.clear_upgrade(group):
                raise KeyError(group)
            return {"cleared": group}
        if path.startswith("/v1/cloud/domains/"):
            domain = urllib.parse.unquote(path[len("/v1/cloud/domains/"):])
            if not self.cloud.remove(domain):
                raise KeyError(domain)
            return {"deleted": domain, "version": self.model.version}
        raise KeyError(path)

    # one model domain holds every agent's reported processes; each
    # vtap owns a SUB-DOMAIN inside it so one agent's refresh can
    # never delete another's rows (the scoped-reconcile machinery
    # built for attached k8s clusters, reused)
    PROC_DOMAIN = "genesis-processes"

    def _record_processes(self, vtap_id: int, processes: list,
                          gpids: dict) -> None:
        """Agent-reported processes -> `process` resource rows keyed
        by their GLOBAL id (reference: the recorder's process updater
        + tagrecorder ch_gprocess — what makes gprocess_id columns
        humanize to process names in the querier). Failures are
        counted, never allowed to fail the sync RPC itself."""
        try:
            # O(1) idempotent upsert of THIS vtap's sub_domain row:
            # a whole-domain reconcile here would race concurrent
            # syncs (two first-syncs each reading the list before the
            # other's write -> mutual sub_domain deletion) and pay an
            # O(model) scan per sync
            self.model.upsert(make_resource(
                "sub_domain", vtap_id, f"vtap-{vtap_id}",
                domain=self.PROC_DOMAIN))
            proc_rows = []
            for p in processes[:4096]:
                gpid = gpids.get(str(p.get("pid")))
                if not gpid:
                    continue
                proc_rows.append(make_resource(
                    "process", int(gpid),
                    str(p.get("name") or p.get("pid")),
                    domain=self.PROC_DOMAIN,
                    sub_domain_id=vtap_id, pid=int(p["pid"]),
                    start_time=int(p.get("start_time", 0)),
                    vtap_id=vtap_id))
            self.recorder.reconcile_sub_domain(
                self.PROC_DOMAIN, vtap_id, proc_rows)
            # amortized dead-vtap sweep: a decommissioned host's
            # process inventory must not accumulate forever (its own
            # reconcile never comes again) — every 256th recording
            # sync pays one pruning pass
            self._proc_record_calls += 1
            if self._proc_record_calls % 256 == 0:
                self.prune_dead_vtap_processes()
        except (ValueError, KeyError, TypeError):
            self.process_record_errors += 1

    def prune_dead_vtap_processes(self,
                                  ttl_s: float = 3600.0) -> int:
        """Drop the process sub-domains of vtaps that no longer exist
        or haven't synced within `ttl_s`; returns pruned vtap count."""
        import time as _time
        now = _time.time()
        alive = {v.vtap_id for v in self.registry.list()
                 if now - v.last_seen < ttl_s}
        pruned = 0
        for sd in self.model.list(type="sub_domain",
                                  domain=self.PROC_DOMAIN):
            if sd.id in alive:
                continue
            self.recorder.reconcile_sub_domain(self.PROC_DOMAIN,
                                               sd.id, [])
            self.model.update_domain(
                self.PROC_DOMAIN,
                [r for r in self.model.list(domain=self.PROC_DOMAIN)
                 if not (r.type == "sub_domain" and r.id == sd.id)
                 and not r.attr("sub_domain_id", 0)])
            pruned += 1
        return pruned

    @staticmethod
    def _endpoint_template_kw(body: dict, required: str,
                              optional: tuple = ()) -> dict:
        """Validated endpoint_template pass-through shared by every
        vendor branch: http(s) scheme, the literal {required}
        placeholder present, and NO braces besides the allowed
        placeholders (a typo'd or attribute-access template —
        {regoin}, {region.__x__} — must 400 here, not fail on every
        later gather)."""
        if not body.get("endpoint_template"):
            return {}
        import re
        tmpl = body["endpoint_template"]
        scheme = urllib.parse.urlparse(tmpl).scheme
        if scheme not in ("http", "https"):
            raise ValueError("endpoint_template must be http(s)")
        names = "|".join(re.escape(n) for n in (required, *optional))
        if not re.fullmatch(r"[^{}]*(\{(%s)\}[^{}]*)+" % names, tmpl) \
                or ("{%s}" % required) not in tmpl:
            allowed = ", ".join(f"{{{n}}}" for n in (required,
                                                     *optional))
            raise ValueError(f"endpoint_template must contain "
                             f"{{{required}}} and no braces besides "
                             f"{allowed}")
        return {"endpoint_template": tmpl}

    def _make_platform(self, body: dict):
        kind = body.get("platform", "filereader")
        if kind == "filereader":
            if not body.get("path"):
                raise ValueError("filereader platform requires path")
            # validate the RESOLVED path and construct the platform with
            # it: passing the raw path would let a symlink inside the
            # fence be re-pointed outside it after creation, and every
            # later poll would follow it
            real = os.path.realpath(body["path"])
            if self.cloud_resource_dir is not None:
                if not (real == self.cloud_resource_dir
                        or real.startswith(self.cloud_resource_dir + os.sep)):
                    raise ValueError(
                        "filereader path outside cloud_resource_dir")
            return FileReaderPlatform(real, body["domain"])
        if kind == "http":
            if not body.get("url"):
                raise ValueError("http platform requires url")
            # urllib's default opener happily serves file:// — without
            # this check the 'http' platform would be a fence bypass
            scheme = urllib.parse.urlparse(body["url"]).scheme
            if scheme not in ("http", "https"):
                raise ValueError(f"http platform requires an http(s) url, "
                                 f"got scheme {scheme!r}")
            return HttpPlatform(body["url"], body["domain"],
                                headers=body.get("headers"))
        if kind == "kubernetes_gather":
            return KubernetesGatherPlatform(
                self.model, body.get("cluster", body["domain"]),
                body["domain"])
        if kind == "aws":
            # reference domain-config keys (aws.go NewAws): secret_id /
            # secret_key / region filters; endpoint override for
            # gov/china partitions or the test recorder
            from deepflow_tpu_torch.controller.cloud_aws import AwsPlatform
            if not body.get("secret_id") or not body.get("secret_key"):
                raise ValueError("aws platform requires secret_id and "
                                 "secret_key")
            kw = self._endpoint_template_kw(body, "region")
            return AwsPlatform(
                body["domain"], body["secret_id"], body["secret_key"],
                regions=tuple(body.get("regions", ())),
                api_default_region=body.get("api_default_region",
                                            "us-east-1"), **kw)
        if kind == "aliyun":
            # reference domain-config keys (aliyun.go NewAliyun):
            # secret_id/secret_key + region include list
            from deepflow_tpu_torch.controller.cloud_aliyun import \
                AliyunPlatform
            if not body.get("secret_id") or not body.get("secret_key"):
                raise ValueError("aliyun platform requires secret_id "
                                 "and secret_key")
            # {product} optional: the real vendor routes vpc/slb
            # actions to their own hosts (cloud_aliyun.py routing)
            kw = self._endpoint_template_kw(body, "region",
                                            optional=("product",))
            return AliyunPlatform(
                body["domain"], body["secret_id"], body["secret_key"],
                regions=tuple(body.get("regions", ())),
                api_default_region=body.get("api_default_region",
                                            "cn-hangzhou"), **kw)
        if kind == "tencent":
            # reference domain-config keys (tencent.go NewTencent);
            # endpoints are service-global ({service} placeholder, the
            # region rides the X-TC-Region header)
            from deepflow_tpu_torch.controller.cloud_tencent import \
                TencentPlatform
            if not body.get("secret_id") or not body.get("secret_key"):
                raise ValueError("tencent platform requires secret_id "
                                 "and secret_key")
            kw = self._endpoint_template_kw(body, "service")
            return TencentPlatform(
                body["domain"], body["secret_id"], body["secret_key"],
                regions=tuple(body.get("regions", ())), **kw)
        if kind == "huawei":
            # reference domain-config keys (huawei/config.go): IAM
            # password identity + project scoping; token-lifecycle
            # auth, so no secret_id/secret_key pair here
            from deepflow_tpu_torch.controller.cloud_huawei import \
                HuaweiPlatform
            for k in ("account_name", "iam_name", "password",
                      "project_name", "project_id", "iam_endpoint"):
                if not body.get(k):
                    raise ValueError(f"huawei platform requires {k}")
            scheme = urllib.parse.urlparse(body["iam_endpoint"]).scheme
            if scheme not in ("http", "https"):
                raise ValueError("iam_endpoint must be http(s)")
            kw = self._endpoint_template_kw(body, "service")
            if not kw:
                raise ValueError(
                    "huawei platform requires endpoint_template")
            return HuaweiPlatform(
                body["domain"], body["account_name"],
                body["iam_name"], body["password"],
                body["project_name"], body["project_id"],
                body["iam_endpoint"], kw["endpoint_template"])
        if kind == "qingcloud":
            from deepflow_tpu_torch.controller.cloud_qingcloud import \
                QingCloudPlatform
            if not body.get("secret_id") or not body.get("secret_key"):
                raise ValueError("qingcloud platform requires "
                                 "secret_id and secret_key")
            kw = {}
            if body.get("url"):
                scheme = urllib.parse.urlparse(body["url"]).scheme
                if scheme not in ("http", "https"):
                    raise ValueError("url must be http(s)")
                kw["url"] = body["url"]
            return QingCloudPlatform(
                body["domain"], body["secret_id"], body["secret_key"],
                zones=tuple(body.get("zones", ())), **kw)
        if kind == "baidubce":
            from deepflow_tpu_torch.controller.cloud_baidubce import \
                BaiduBcePlatform
            for k in ("secret_id", "secret_key", "endpoint"):
                if not body.get(k):
                    raise ValueError(f"baidubce platform requires {k}")
            scheme = body.get("scheme", "https")
            if scheme not in ("http", "https"):
                raise ValueError("scheme must be http or https")
            return BaiduBcePlatform(
                body["domain"], body["secret_id"], body["secret_key"],
                body["endpoint"],
                region_name=body.get("region_name", "baidu"),
                scheme=scheme, bcc_host=body.get("bcc_host"))
        raise ValueError(f"unknown platform kind {kind!r}")

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        # supervised: crash capture for the accept loop. deadman off —
        # serve_forever cannot beat without the querier's service_actions
        # subclass
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "controller-http",
            lambda: self._httpd.serve_forever(poll_interval=0.5),
            deadman_s=None)
        self.genesis_sync.start()
        self.cloud.start()

    def close(self) -> None:
        self.cloud.close()
        self.genesis_sync.close()
        if self._thread is not None:
            self._thread.stop()     # no restart on the way down
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
