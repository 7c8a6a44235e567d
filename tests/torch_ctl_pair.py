"""Helpers for the controller tests that hold deepflow_tpu_torch's
controller against the JAX package's: both packages' modules by name, a
seeded filereader document, resources as JSON, a frozen clock, and the
JAX package's own controller test bodies compiled against the port."""

import importlib
import time
import types
from pathlib import Path

PKGS = ("deepflow_tpu", "deepflow_tpu_torch")
TESTS = Path(__file__).resolve().parent

_CONTROLLER = ("model", "recorder", "registry", "monitor", "election",
               "tagrecorder", "platform_compiler", "genesis_sync", "cloud",
               "server", "trident_grpc")


def mods(pkg):
    """The controller modules of `pkg`, and its enrich/platform_data."""
    ns = types.SimpleNamespace(pkg=pkg)
    for name in _CONTROLLER:
        setattr(ns, name,
                importlib.import_module(f"{pkg}.controller.{name}"))
    ns.platform_data = importlib.import_module(f"{pkg}.enrich.platform_data")
    return ns


def both():
    return [mods(p) for p in PKGS]


def res(r):
    """A Resource as JSON."""
    return [r.type, r.id, r.name, r.domain, [list(a) for a in r.attrs]]


def rows(resources):
    return sorted(res(r) for r in resources)


def diff_json(d):
    return {k: [res(r) for r in getattr(d, k)]
            for k in ("created", "deleted", "updated", "orphaned")
            if hasattr(d, k)}


def make_doc(rng, n_pods=48, n_nodes=6, n_services=8, prefix="",
             subnet_id=101):
    """A filereader document: a region, 2 azs, a vpc, 2 subnets, a
    cluster, nodes, namespaces, groups, pods with ip/epc/subnet links and
    services, drawn from `rng`."""
    p = prefix
    doc = {
        "regions": [{"name": f"{p}r1"}],
        "azs": [{"name": f"{p}az-{i}", "region": f"{p}r1"}
                for i in range(2)],
        "vpcs": [{"name": f"{p}vpc-1", "region": f"{p}r1"}],
        "subnets": [{"name": f"{p}sn-{i}", "id": subnet_id + i,
                     "vpc": f"{p}vpc-1", "az": f"{p}az-{i}",
                     "cidr": c, "epc_id": 0}
                    for i, c in enumerate(("172.16.0.0/12",
                                           "10.0.0.0/8"))],
        "pod_clusters": [{"name": f"{p}c1", "vpc": f"{p}vpc-1"}],
        "pod_nodes": [{"name": f"{p}node-{i}", "pod_cluster": f"{p}c1",
                       "ip": f"10.{i}.0.1"} for i in range(n_nodes)],
        "pod_namespaces": [{"name": f"{p}ns-{i}", "pod_cluster": f"{p}c1"}
                           for i in range(3)],
        "pod_groups": [{"name": f"{p}grp-{i}", "pod_ns": f"{p}ns-{i % 3}"}
                       for i in range(6)],
    }
    ips = rng.choice(1 << 20, n_pods, replace=False) + (172 << 24 | 16 << 16)
    doc["pods"] = [{
        "name": f"{p}pod-{i}", "pod_node": f"{p}node-{i % n_nodes}",
        "pod_ns": f"{p}ns-{i % 3}", "pod_group": f"{p}grp-{i % 6}",
        "ip": ".".join(str(int(ip) >> s & 255) for s in (24, 16, 8, 0)),
        "epc_id": 0, "subnet_id": subnet_id, "az": f"{p}az-0",
        "region": f"{p}r1",
    } for i, ip in enumerate(ips.tolist())]
    doc["services"] = [{"name": f"{p}svc-{i}", "ip": doc["pods"][i]["ip"],
                        "port": int(rng.choice([80, 443, 8080])),
                        "protocol": 6, "epc_id": 0}
                       for i in range(min(n_services, n_pods))]
    return doc


class FrozenClock:
    """time.time / time.gmtime / time.strftime read a clock that starts
    at `t0` and moves only when told to."""

    def __init__(self, monkeypatch, t0=1_700_000_000.0):
        self.now = t0
        real_gmtime = time.gmtime
        real_strftime = time.strftime
        monkeypatch.setattr(time, "time", lambda: self.now)
        monkeypatch.setattr(time, "time_ns", lambda: int(self.now * 1e9))
        monkeypatch.setattr(
            time, "gmtime",
            lambda s=None: real_gmtime(self.now if s is None else s))
        monkeypatch.setattr(
            time, "strftime",
            lambda fmt, t=None: real_strftime(
                fmt, real_gmtime(self.now) if t is None else t))

    def advance(self, s):
        self.now += s


# what the JAX package's tests reach that the port holds, rewritten to
# the port's module; everything else (the pipelines' Ingester, helpers
# imported from other JAX test files such as test_ebpf_source's tracer)
# stays the JAX package's, which talks to the port over the wire or
# hands it plain records
_PORT_PREFIXES = ("controller", "wire.gen", "enrich", "server", "agent",
                  "querier", "store", "decode", "cli")


def port_source(path, replace=()):
    """A JAX-package test file's source, its imports of the modules the
    port holds rewritten to deepflow_tpu_torch, then each (old, new) of
    `replace` substituted in order."""
    src = Path(path).read_text()
    for p in _PORT_PREFIXES:
        src = src.replace(f"deepflow_tpu.{p}", f"deepflow_tpu_torch.{p}")
    # the port's store package exports nothing (its rollup imports torch,
    # which the host-only modules that import the store must not pull)
    src = src.replace(
        "from deepflow_tpu_torch.store import AggKind, ColumnSpec, Store, "
        "TableSchema",
        "from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, "
        "TableSchema; from deepflow_tpu_torch.store.db import Store")
    for old, new in replace:
        assert old in src, f"{Path(path).name} has no {old!r}"
        src = src.replace(old, new)
    return src


def reference_tests(path, skip=(), replace=()):
    """{name: function} of a JAX-package test file compiled against the
    port (port_source), its fixtures included, minus `skip`."""
    mod = types.ModuleType(f"_port_{Path(path).stem}")
    mod.__file__ = str(path)
    exec(compile(port_source(path, replace), str(path), "exec"),
         mod.__dict__)
    return {k: v for k, v in vars(mod).items()
            if k.startswith("test_") and k not in skip}, mod


def adopt_reference_tests(namespace, path, only=None, skip=(),
                          replace=()):
    """Put a JAX-package test file's tests, compiled against the port
    (port_source), into a test module's `namespace` as `test_ref_<name>`,
    with the file's fixtures under their own names and its module-level
    marks (`pytestmark`) on each test, so pytest collects and runs them
    there. `only` names the tests to take (all, minus `skip`, when None);
    `replace` goes to port_source. Returns the compiled module."""
    tests, mod = reference_tests(path, skip=skip, replace=replace)
    if only is not None:
        missing = set(only) - set(tests)
        assert not missing, f"{Path(path).name} has no {sorted(missing)}"
        tests = {k: v for k, v in tests.items() if k in only}
    marks = getattr(mod, "pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    for name, obj in vars(mod).items():
        if hasattr(obj, "_pytestfixturefunction") or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[name] = obj
    for name, fn in sorted(tests.items()):
        for mark in marks:
            fn = mark(fn)
        namespace[f"test_ref_{name[len('test_'):]}"] = fn
    return mod


def reference_function(path, name):
    """One test function of a JAX-package test file, compiled against
    the port (port_source) with the file's imports and nothing else of
    its module-level code (no marks, no probes run at import)."""
    import ast
    tree = ast.parse(port_source(path), str(path))
    tree.body = [n for n in tree.body
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 or (isinstance(n, ast.FunctionDef) and n.name == name)]
    ns = {"__file__": str(path)}
    exec(compile(tree, str(path), "exec"), ns)
    return ns[name]
