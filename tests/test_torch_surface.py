"""The port's public surface: every public name a module of the JAX
package binds resolves at the same dotted path in deepflow_tpu_torch, on
the CPU.

For each `.py` under deepflow_tpu/ the names are collected with `ast`:
top-level `def`, `class` and assignment targets, the strings of
`__all__`, and for an `__init__.py` every name it binds by import. A
package's names are resolved in a fresh interpreter that imports only
that package, so a name that resolves only because another module was
imported first does not count."""

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "deepflow_tpu"

# modules and names of the JAX package the port leaves out by design
EXCLUDED_MODULES = {
    "ops/pallas_hist.py": "Pallas kernel: the port's is CUDA, csrc/hist.cu",
    "ops/pallas_sketch.py":
        "Pallas kernels: the port's are CUDA, csrc/fused_sketch.cu",
}
EXCLUDED_NAMES = {
    ("anomaly/detectors.py", "make_window_step"):
        "a jit-compiled window step; the port calls window_step eagerly",
    ("parallel/__init__.py", "JaxDcnTransport"):
        "the DCN over jax.distributed; the port's is TorchDcnTransport",
    ("parallel/multihost.py", "JaxDcnTransport"):
        "the DCN over jax.distributed; the port's is TorchDcnTransport",
}

JAX_FILES = sorted(
    p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
    if "__pycache__" not in p.parts)
CHECKED = [f for f in JAX_FILES if f not in EXCLUDED_MODULES]


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    init = path.name == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
                        if n.id == "__all__":
                            names.update(ast.literal_eval(node.value))
        elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    return {n for n in names if not n.startswith("_")}


def port_module(rel: str) -> str:
    parts = ("deepflow_tpu_torch",) + Path(rel).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def wanted(rel: str) -> list:
    return sorted(n for n in public_names(JAX_PKG / rel)
                  if (rel, n) not in EXCLUDED_NAMES)


def missing_in_fresh_process(module: str, names: list) -> list:
    code = ("import importlib, json, sys\n"
            f"m = importlib.import_module({module!r})\n"
            f"print(json.dumps([n for n in {names!r} "
            "if not hasattr(m, n)]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rel", CHECKED)
def test_public_names_resolve(rel):
    names = wanted(rel)
    module = port_module(rel)
    if rel.endswith("__init__.py"):
        missing = missing_in_fresh_process(module, names)
    else:
        mod = importlib.import_module(module)
        missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"


def test_exclusions_are_exact():
    """Every exclusion names a file or name of the JAX package that the
    port indeed lacks, so the list cannot hide a name the port has."""
    for rel in EXCLUDED_MODULES:
        assert (JAX_PKG / rel).is_file()
        assert not (REPO / "deepflow_tpu_torch" / rel).exists()
    for rel, name in EXCLUDED_NAMES:
        assert name in public_names(JAX_PKG / rel), (rel, name)
        assert not hasattr(importlib.import_module(port_module(rel)), name)
    assert len(EXCLUDED_MODULES) + len(EXCLUDED_NAMES) == 5


@pytest.mark.parametrize("name", ["SKETCH_L4_SCHEMA", "SKETCH_LANES_SCHEMA",
                                  "SKETCH_HITS_SCHEMA", "SKETCH_NEWS_SCHEMA"])
def test_sketch_schemas_match_reference(name):
    from deepflow_tpu.batch import schema as jschema
    from deepflow_tpu_torch.batch import schema as tschema
    j, t = getattr(jschema, name), getattr(tschema, name)
    assert t.name == j.name
    assert [(c, np.dtype(d)) for c, d in t.columns] \
        == [(c, np.dtype(d)) for c, d in j.columns]
    assert t.row_bytes() == j.row_bytes()


def test_ops_import_loads_no_library():
    """`import deepflow_tpu_torch.ops` and its six op modules build
    nothing and map no library of the build directory."""
    code = ("import json\n"
            "import deepflow_tpu_torch.ops as ops\n"
            "mods = [getattr(ops, n) for n in ops.__all__]\n"
            "from deepflow_tpu_torch.ops import _build\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert str(_build.BUILD_DIR) not in maps\n"
            "assert not _build._libs and not _build.build_log\n"
            "print(json.dumps([m.__name__ for m in mods]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == [
        f"deepflow_tpu_torch.ops.{n}"
        for n in ("cms", "entropy", "hashing", "hll", "pca", "topk")]
