"""deepflow_tpu_torch, chip_smoke.py and chip_pod_probe.py stand alone: no
import of jax or of the deepflow_tpu package (host-only helpers are kept
as the port's own copies), no path to a source or library file under
deepflow_tpu/ (the native decoder builds the port's own copy), and
chip_smoke.py refuses to report a result without a card."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "deepflow_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py", REPO / "chip_pod_probe.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "deepflow_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "flow_suite.py", "flow_dict.py",
            "cuda_hist.py", "cuda_sketch.py", "convert.py", "supervisor.py",
            "faults.py", "queues.py", "exporters.py", "feed.py",
            "staging.py", "snapbus.py", "tpu_sketch.py", "pca.py",
            "matrix_profile.py", "detectors.py", "alerts.py",
            "audit.py", "ddsketch.py", "app_suite.py", "app_red.py",
            "table.py", "db.py", "writer.py", "metrics_suite.py", "mesh.py",
            "sharded.py", "rollup.py", "migrate.py", "monitor.py",
            "schema.py", "tag_code.py", "schemas.py",
            "flow_metrics.py", "pod.py", "multihost.py", "tracing.py",
            "profiler.py", "stats.py", "breaker.py", "framing.py",
            "codec.py", "columnar_wire.py", "flow_log_pb2.py",
            "metric_pb2.py", "columnar.py", "dict_store.py",
            "platform_data.py", "geo.py", "throttler.py", "receiver.py",
            "flow_log.py", "autotune.py", "ingester.py", "spill.py",
            "timeline.py", "incident.py", "promexpo.py", "debug.py",
            "cuda_gate.py", "twinmark.py", "snappy.py", "telemetry_pb2.py",
            "sql.py", "metrics.py", "engine.py", "promql.py", "tempo.py",
            "tracing_adapter.py", "profile.py", "server.py", "cache.py",
            "tables.py", "anomaly.py", "otel_pb2.py", "stats_pb2.py",
            "packet_sequence.py", "sender.py", "otlp_exporter.py",
            "ext_metrics.py", "event.py", "droplet.py",
            "checkpoint.py", "native.py", "packet.py", "tcp_perf.py",
            "flow_map.py", "quadruple.py", "trident.py"} <= names
    assert (REPO / "deepflow_tpu_torch" / "decode" / "native_src"
            / "decoder.cc").is_file()
    for proto in ("telemetry", "otel", "stats"):
        assert (REPO / "deepflow_tpu_torch" / "wire" / "protos"
                / f"{proto}.proto").is_file()
    assert (REPO / "deepflow_tpu_torch" / "server.py") in PORT_FILES
    for pkg in ("wire", "wire/gen", "decode", "enrich", "serving", "querier",
                "utils", "agent"):
        assert (REPO / "deepflow_tpu_torch" / pkg / "__init__.py") \
            in PORT_FILES
    assert (REPO / "deepflow_tpu_torch" / "anomaly" / "__init__.py") \
        in PORT_FILES
    assert (REPO / "deepflow_tpu_torch" / "parallel" / "__init__.py") \
        in PORT_FILES
    assert (REPO / "deepflow_tpu_torch" / "pipelines" / "__init__.py") \
        in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_deepflow_tpu_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# a source or library file of the JAX package, named in a string
_JAX_PKG_FILE = re.compile(r"(^|[^\w])deepflow_tpu/\S*\.(cc|cpp|c|h|cu|so)\b")


def _strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value
        elif isinstance(node, ast.JoinedStr):
            yield node.lineno, "".join(
                v.value for v in node.values
                if isinstance(v, ast.Constant) and isinstance(v.value, str))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_path_into_deepflow_tpu(path):
    """No string of a port file names a source or library file under
    deepflow_tpu/, nor the package directory as a path component."""
    bad = [(line, s) for line, s in _strings(path)
           if _JAX_PKG_FILE.search(s) or s == "deepflow_tpu"]
    assert not bad, f"{path.relative_to(REPO)} names {bad}"


def test_native_decoder_builds_its_own_source():
    """The native decoder's source and library live in the port's tree
    and build directory; neither resolves into deepflow_tpu/."""
    from deepflow_tpu_torch.decode import native
    from deepflow_tpu_torch.ops import _build
    jax_pkg = REPO / "deepflow_tpu"
    assert native.SRC.resolve().is_relative_to(REPO / "deepflow_tpu_torch")
    assert native.BUILD_DIR == _build.BUILD_DIR
    for p in (native.SRC.resolve(), native.BUILD_DIR.resolve()):
        assert not p.is_relative_to(jax_pkg), p
    assert all(src.suffix == ".cu" for src in _build.sources())


def test_port_imports_leave_jax_unloaded():
    code = ("import sys, pkgutil, importlib, deepflow_tpu_torch\n"
            "for m in pkgutil.walk_packages(deepflow_tpu_torch.__path__, "
            "'deepflow_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepflow_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _port_callables():
    import importlib
    import inspect
    import pkgutil

    import deepflow_tpu_torch
    for m in pkgutil.walk_packages(deepflow_tpu_torch.__path__,
                                   "deepflow_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isclass(obj):
                obj = obj.__init__
            if callable(obj):
                try:
                    params = inspect.signature(obj).parameters
                except (TypeError, ValueError):
                    continue
                default = params["device"].default \
                    if "device" in params else inspect.Parameter.empty
                if default is not inspect.Parameter.empty:
                    yield f"{mod.__name__}.{name}", default


def test_every_entry_point_defaults_to_cuda():
    found = dict(_port_callables())
    assert "deepflow_tpu_torch.runtime.tpu_sketch.TpuSketchExporter" in found
    assert "deepflow_tpu_torch.convert.state_from_numpy" in found
    assert {"deepflow_tpu_torch.anomaly.alerts.AnomalyPlane",
            "deepflow_tpu_torch.anomaly.detectors.init",
            "deepflow_tpu_torch.ops.pca.init",
            "deepflow_tpu_torch.ops.matrix_profile.init",
            "deepflow_tpu_torch.convert.anomaly_from_numpy",
            "deepflow_tpu_torch.runtime.app_red.AppRedExporter",
            "deepflow_tpu_torch.models.app_suite.init",
            "deepflow_tpu_torch.ops.ddsketch.init",
            "deepflow_tpu_torch.convert.app_from_numpy",
            "deepflow_tpu_torch.models.metrics_suite.init",
            "deepflow_tpu_torch.convert.metrics_from_numpy",
            "deepflow_tpu_torch.parallel.mesh.make_mesh",
            "deepflow_tpu_torch.store.rollup.group_reduce",
            "deepflow_tpu_torch.store.rollup.group_reduce_device",
            "deepflow_tpu_torch.store.rollup.RollupManager",
            "deepflow_tpu_torch.pipelines.flow_metrics.FlowMetricsPipeline",
            "deepflow_tpu_torch.parallel.pod.PodFlowSuite",
            "deepflow_tpu_torch.parallel.multihost.HostPodCoordinator",
            "deepflow_tpu_torch.pipelines.ingester.Ingester",
            "deepflow_tpu_torch.querier.engine.QueryEngine",
            "deepflow_tpu_torch.querier.promql.PromEngine",
            "deepflow_tpu_torch.querier.server.QuerierServer",
            "deepflow_tpu_torch.server.Server"
            } <= set(found)
    bad = {k: v for k, v in found.items() if v != "cuda"}
    assert not bad, bad


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    import torch
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        res = _run_smoke(REPO, env)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
