"""The port's cloud pollers (deepflow_tpu_torch/controller/cloud*.py)
against the JAX package's, on the CPU.

Filereader, HTTP and kubernetes_gather domains through CloudTask and
CloudManager, and the six vendor clients (AWS, Aliyun, Tencent, Huawei,
QingCloud, Baidu BCE) against the fake endpoints of the JAX package's
own tests (tests/test_cloud_<vendor>.py, which verify every signature):
for each, both packages from the same inputs under one frozen clock and
one uuid sequence, with the resource lists, every request's bytes
(URL, method, headers, body) and the fakes' records equal. Also
ControllerServer's platform construction and its refusals for every
kind, and the JAX package's tests/test_cloud.py bodies on the port."""

import datetime
import importlib
import json
import threading
import urllib.request
import uuid
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import torch_ctl_pair as cp

# vendor: (client module, class, JAX test module)
VENDORS = {
    "aws": ("cloud_aws", "AwsPlatform", "test_cloud_aws"),
    "aliyun": ("cloud_aliyun", "AliyunPlatform", "test_cloud_aliyun"),
    "tencent": ("cloud_tencent", "TencentPlatform", "test_cloud_tencent"),
    "huawei": ("cloud_huawei", "HuaweiPlatform", "test_cloud_huawei"),
    "qingcloud": ("cloud_qingcloud", "QingCloudPlatform",
                  "test_cloud_qingcloud"),
    "baidubce": ("cloud_baidubce", "BaiduBcePlatform",
                 "test_cloud_baidubce"),
}


def _same(out):
    assert json.dumps(out[1], sort_keys=True, default=str) == \
        json.dumps(out[0], sort_keys=True, default=str)
    return out[1]


class _Frozen:
    """One frozen wall clock (time and datetime) and one uuid4 sequence,
    restarted for each package's run; every request through
    urllib.request.urlopen recorded."""

    def __init__(self, monkeypatch):
        self.clock = cp.FrozenClock(monkeypatch)
        self.monkeypatch = monkeypatch
        self.n = 0
        self.requests = []
        monkeypatch.setattr(uuid, "uuid4", self._uuid4)
        real = urllib.request.urlopen

        def urlopen(req, *a, **k):
            if isinstance(req, urllib.request.Request):
                self.requests.append([
                    req.full_url, req.get_method(),
                    sorted(req.header_items()),
                    None if req.data is None else req.data.decode()])
            else:
                self.requests.append([req])
            return real(req, *a, **k)
        monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def _uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n * 0x9E3779B97F4A7C15 % (1 << 128))

    def restart(self, module):
        """A fresh run: the clock back at its start, the uuid sequence
        and the request log emptied, `module`'s datetime frozen too."""
        self.clock.now = 1_700_000_000.0
        self.n = 0
        self.requests = []
        now = self.clock.now

        class FrozenDateTime(datetime.datetime):
            @classmethod
            def now(cls, tz=None):
                return datetime.datetime.fromtimestamp(now, tz)
        if hasattr(module, "datetime"):
            shim = type(datetime)("datetime")
            shim.__dict__.update(vars(datetime))
            shim.datetime = FrozenDateTime
            self.monkeypatch.setattr(module, "datetime", shim)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _reset(srv):
    """The fake's per-run records back to empty."""
    for k, v in list(vars(srv).items()):
        if isinstance(v, (list, set, dict)) and k != "socket":
            setattr(srv, k, type(v)())
        elif isinstance(v, int) and not isinstance(v, bool) \
                and k not in ("request_queue_size", "timeout"):
            setattr(srv, k, 0)


@pytest.mark.parametrize("vendor", sorted(VENDORS))
def test_vendor_client_matches_jax(vendor, monkeypatch):
    modname, cls, refname = VENDORS[vendor]
    ref = importlib.import_module(refname)
    frozen = _Frozen(monkeypatch)
    srv = _serve(ref._Recorder())
    out = []
    try:
        for pkg in cp.PKGS:
            mod = importlib.import_module(f"{pkg}.controller.{modname}")
            frozen.restart(mod)
            _reset(srv)
            monkeypatch.setattr(ref, cls, getattr(mod, cls))
            p = ref._platform(srv)
            p.check_auth()
            gathers = [cp.rows(p.get_cloud_data()) for _ in range(2)]
            state = {k: (sorted(map(str, v)) if isinstance(v, set) else v)
                     for k, v in vars(srv).items()
                     if isinstance(v, (list, set, int)) and k != "socket"}
            out.append({"rows": gathers, "requests": frozen.requests,
                        "fake": json.loads(json.dumps(state, default=str))})
    finally:
        srv.shutdown()
        srv.server_close()
    got = _same(out)
    assert got["rows"][0] and got["rows"][0] == got["rows"][1]
    assert got["requests"]
    assert not any(v for k, v in got["fake"].items()
                   if k.startswith("bad") and isinstance(v, int))


# every kind ControllerServer builds, and the bodies it refuses
PLATFORMS = [
    {"platform": "filereader"},
    {"platform": "filereader", "path": "/nonexistent/doc.json"},
    {"platform": "http", "url": "ftp://x"},
    {"platform": "http", "url": "http://127.0.0.1:1/snap",
     "headers": {"X-Token": "t"}},
    {"platform": "kubernetes_gather", "cluster": "c1"},
    {"platform": "aws", "secret_id": "a"},
    {"platform": "aws", "secret_id": "a", "secret_key": "b",
     "regions": ["us-east-1"], "endpoint_template": "http://x/{regoin}"},
    {"platform": "aws", "secret_id": "a", "secret_key": "b",
     "endpoint_template": "http://x/{region}"},
    {"platform": "aliyun", "secret_id": "a", "secret_key": "b",
     "endpoint_template": "http://{product}.x/{region}"},
    {"platform": "tencent", "secret_id": "a", "secret_key": "b",
     "endpoint_template": "https://{service}.x"},
    {"platform": "huawei", "account_name": "acc", "iam_name": "u",
     "password": "p", "project_name": "cn-1", "project_id": "pid",
     "iam_endpoint": "http://iam", "endpoint_template": "http://{service}"},
    {"platform": "huawei", "account_name": "acc"},
    {"platform": "qingcloud", "secret_id": "a", "secret_key": "b",
     "url": "file:///x"},
    {"platform": "qingcloud", "secret_id": "a", "secret_key": "b",
     "zones": ["pek3"]},
    {"platform": "baidubce", "secret_id": "a", "secret_key": "b",
     "endpoint": "bj", "scheme": "gopher"},
    {"platform": "baidubce", "secret_id": "a", "secret_key": "b",
     "endpoint": "bj", "region_name": "bj"},
    {"platform": "openstack"},
]


def _describe(p):
    return [type(p).__name__, {k: v for k, v in sorted(vars(p).items())
                               if isinstance(v, (str, int, float, tuple,
                                                 list, dict, type(None)))}]


@pytest.mark.parametrize("i", range(len(PLATFORMS)))
def test_make_platform_matches_jax(i, tmp_path):
    body = {"domain": "dom", **PLATFORMS[i]}
    out = []
    for m in cp.both():
        srv = m.server.ControllerServer(
            m.model.ResourceModel(), m.registry.VTapRegistry(), port=0)
        try:
            out.append(_describe(srv._make_platform(body)))
        except ValueError as e:
            out.append(["ValueError", str(e)])
        finally:
            srv._httpd.server_close()
    _same(out)


DOC = {
    "regions": [{"name": "r1"}],
    "azs": [{"name": "az1", "region": "r1"}],
    "vpcs": [{"name": "vpc1"}],
    "subnets": [{"name": "s1", "vpc": "vpc1", "cidr": "10.0.0.0/24",
                 "epc_id": 3}],
    "hosts": [{"name": "h1", "az": "az1", "ip": "10.0.0.7"}],
    "services": [{"name": "svc1", "vpc": "vpc1", "ip": "10.0.0.100",
                  "port": 443}],
}


def _domains_run(m, tmp, monkeypatch):
    """Filereader, HTTP and kubernetes_gather domains through a
    CloudManager: gathers, regathers, a failed gather, removal."""
    cp.FrozenClock(monkeypatch)
    rng = np.random.default_rng(11)
    d = tmp / m.pkg
    d.mkdir()
    (d / "doc.json").write_text(json.dumps(cp.make_doc(rng, n_pods=24)))
    (d / "small.json").write_text(json.dumps(DOC))
    model = m.model.ResourceModel()
    rec = m.recorder.Recorder(model)
    mgr = m.cloud.CloudManager(rec)
    snap = {"resources": [{"type": "vpc", "name": "vpc-a"},
                          {"type": "pod_cluster", "name": "c1"},
                          {"type": "region", "id": 9, "name": "r9"}]}

    class Handler(__import__("http.server").server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps(snap).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
    httpd = _serve(ThreadingHTTPServer(("127.0.0.1", 0), Handler))
    out = {}
    try:
        model.update_domain("genesis/n1", [
            m.model.make_resource("host", 1, "n1:eth0", "genesis/n1",
                                  ip="10.1.1.1"),
            m.model.make_resource("host", 2, "n1:veth3", "genesis/n1",
                                  ip="10.244.0.9"),
            m.model.make_resource("host", 4, "n1:docker0", "genesis/n1",
                                  ip="172.17.0.1")])
        model.update_domain("genesis/n2", [
            m.model.make_resource("host", 3, "n2:eth0", "genesis/n2",
                                  ip="10.1.1.2")])
        tasks = {
            "file": mgr.add("file", m.cloud.FileReaderPlatform(
                str(d / "doc.json"), "file"), interval_s=3600),
            "small": mgr.add("small", m.cloud.FileReaderPlatform(
                str(d / "small.json"), "small"), interval_s=3600),
            "http": mgr.add("http", m.cloud.HttpPlatform(
                f"http://127.0.0.1:{httpd.server_address[1]}/s", "http"),
                interval_s=3600),
            "k8s": mgr.add("k8s", m.cloud.KubernetesGatherPlatform(
                model, "prod", "k8s"), interval_s=3600),
        }
        out["first"] = {k: t.gather_once() for k, t in tasks.items()}
        (d / "small.json").write_text("{not json: [")
        snap["resources"].pop(0)
        model.update_domain("genesis/n2", [])
        out["second"] = {k: t.gather_once() for k, t in tasks.items()}
        out["infos"] = [{k: v for k, v in vars(i).items()
                         if k != "last_cost_s"} for i in mgr.tasks()]
        out["counters"] = {k: v for k, v in mgr.counters().items()
                           if "cost" not in k}
        out["model"] = cp.rows(model.list())
        out["removed"] = [mgr.remove("http"), mgr.remove("http")]
        out["after"] = cp.rows(model.list())
        try:
            mgr.add("bad", m.cloud.FileReaderPlatform("x", "bad"),
                    interval_s=0)
        except ValueError as e:
            out["bad_interval"] = str(e)
        out["rows_to_resources"] = cp.rows(m.cloud.rows_to_resources(
            snap["resources"], "x"))
        try:
            m.cloud.parse_resource_doc({"azs": [{"name": "a",
                                                 "region": "no"}]}, "d")
        except ValueError as e:
            out["dangling"] = str(e)
    finally:
        mgr.close()
        httpd.shutdown()
        httpd.server_close()
    return out


def test_cloud_domains_match_jax(tmp_path, monkeypatch):
    out = _same([_domains_run(m, tmp_path, monkeypatch)
                 for m in cp.both()])
    assert all(out["first"].values())
    assert not out["second"]["small"]
    assert out["removed"] == [True, False]


# -- the JAX package's own cloud tests, on the port -----------------------
_REF, _ = cp.reference_tests(cp.TESTS / "test_cloud.py")


@pytest.mark.parametrize("name", sorted(_REF))
def test_reference_cloud_tests_on_port(name, tmp_path):
    """tests/test_cloud.py's test bodies, compiled against the port's
    modules (torch_ctl_pair.port_source), pass on the port."""
    import inspect
    fn = _REF[name]
    fn(**({"tmp_path": tmp_path}
          if "tmp_path" in inspect.signature(fn).parameters else {}))
