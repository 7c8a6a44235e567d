"""Nothing the benchmark runs loads JAX or the JAX package. Names are
compared by their whole top-level part (the text before the first dot),
so the port, deepflow_tpu_torch, passes while deepflow_tpu does not."""

import ast
import json
import subprocess
import sys

from harness import run_cell, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "deepflow_tpu"}


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        bad = set(_top_imports(path)) & FORBIDDEN
        assert not bad, f"{path}: imports {bad}"


def test_the_check_compares_whole_top_level_names():
    ok = ["deepflow_tpu_torch", "deepflow_tpu_torch.runtime.tpu_sketch",
          "jaxtyping", "flaxen", "numpy"]
    assert run_cell.forbidden_modules(ok) == []
    bad = ok + ["jax.numpy", "deepflow_tpu.models", "jaxlib", "flax.linen"]
    assert run_cell.forbidden_modules(bad) == sorted(FORBIDDEN)


_PROBE = """
import io, json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import run_cell
from traffic.generator import load_mix
for cell, mix in (("l4_zipf_steady", "zipf_steady"),
                  ("red_zipf_services", "red_services")):
    m = load_mix(mix)
    m["bank_records"] = 1 << 16
    r = run_cell.run(cell, 31, 1.0, cell.startswith("red"), device="cpu",
                     mix=m, log=io.StringIO())
    assert r is not None
import control
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    code = _PROBE.format(bench=str(spec.BENCH_DIR), root=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "deepflow_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
