"""The port's documented drives (examples/torch/) against the JAX
package's (examples/), on the CPU.

The e2e drive: `run()` of examples/torch/e2e_l4_topk.py with
`device="cpu"` against examples/e2e_l4_topk.py at the same flags, in a
subprocess on 4 forced CPU devices (its window output taken at
`ShardedFlowSuite.flush`): rows, the top-K keys and estimates and the
service cardinality equal, the entropies within rtol 1e-5.

The all-in-one demo: both demos in this process with `bpf.available`
patched to False in each package (step 3b opens an AF_PACKET socket), to
"demo OK"; the top flows and the per-service RED rows they print equal.
Each demo's controller binds its trident bridge on an ephemeral port
instead of the fixed 30035, which tests in other workers bind, and the
parsers its agent registers are unloaded after it (`clean_registries`).
No compared field depends on the wall clock: the agent's packets are
stamped at a wall-clock start plus fixed offsets, and the RED lane's
rrt is a difference of two stamps. The printed ports are the OS's
choice and are not compared."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_plugin_pair import clean_registries  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
RECORDS, BATCH, TOP_K = 4096, 1024, 20


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_E2E = """
import json, runpy, sys
import numpy as np
from deepflow_tpu.parallel import ShardedFlowSuite
outs = []
flush = ShardedFlowSuite.flush
def capture(self, state):
    state, out = flush(self, state)
    outs.append({k: np.asarray(v).tolist() for k, v in out._asdict().items()})
    return state, out
ShardedFlowSuite.flush = capture
for devices in sys.argv[1:]:
    sys.argv = ["e2e_l4_topk.py", "--records", "%d", "--batch", "%d",
                "--top-k", "%d", "--devices", devices]
    runpy.run_path("examples/e2e_l4_topk.py", run_name="__main__")
print("OUTS " + json.dumps(outs))
""" % (RECORDS, BATCH, TOP_K)


@pytest.fixture(scope="module")
def jax_e2e():
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", JAX_E2E, "1", "4"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("OUTS ")]
    outs = json.loads(line[-1][5:])
    return {1: outs[0], 4: outs[1]}


@pytest.mark.parametrize("devices", [1, 4])
def test_e2e_drive_matches_jax_example(jax_e2e, devices):
    e2e = load(REPO / "examples" / "torch" / "e2e_l4_topk.py", "t_e2e")
    out, truth, report = e2e.run(RECORDS, devices, BATCH, TOP_K, "cpu")
    ref = jax_e2e[devices]
    assert report["devices"] == devices
    assert int(out.rows) == ref["rows"] == RECORDS == report["rows"]
    assert out.topk_keys.view(np.uint32).tolist() == ref["topk_keys"]
    assert out.topk_counts.tolist() == ref["topk_counts"]
    np.testing.assert_array_equal(
        out.service_cardinality,
        np.asarray(ref["service_cardinality"], np.float32))
    np.testing.assert_allclose(out.entropies, ref["entropies"], rtol=1e-5)
    # the report scores the same output against the exact GROUP BY
    assert sum(truth.values()) == RECORDS
    assert [k for k, _, _ in report["top"]] == ref["topk_keys"]
    assert all(est >= exact for _, est, exact in report["top"])


def test_e2e_drive_raises_without_a_card():
    """No --device: the drive asks for the card and raises where there is
    none, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    res = subprocess.run(
        [sys.executable, "examples/torch/e2e_l4_topk.py", "--records", "64"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert "CUDA device requested" in res.stderr
    assert "rows counted" not in res.stdout


def section(text: str, header: str) -> list:
    rows = []
    for line in text.split(header, 1)[1].splitlines()[1:]:
        if not line.strip():
            break
        rows.append(line.strip())
    return rows


def test_all_in_one_demo_matches_jax_demo(monkeypatch, capsys):
    from deepflow_tpu import server as jserver
    from deepflow_tpu.agent import bpf as jbpf
    from deepflow_tpu_torch import server as tserver
    from deepflow_tpu_torch.agent import bpf as tbpf
    monkeypatch.setattr(jbpf, "available", lambda: False)
    monkeypatch.setattr(tbpf, "available", lambda: False)
    for mod in (jserver, tserver):
        def load_config(path, _load=mod.load_config):
            cfg = _load(path)
            cfg["controller"]["grpc_port"] = 0
            return cfg
        monkeypatch.setattr(mod, "load_config", load_config)

    load(REPO / "examples" / "all_in_one_demo.py", "j_demo").main()
    jax_out = capsys.readouterr().out
    answers = load(REPO / "examples" / "torch" / "all_in_one_demo.py",
                   "t_demo").run("cpu")
    port_out = capsys.readouterr().out

    assert jax_out.rstrip().endswith("demo OK")
    assert port_out.rstrip().endswith("demo OK")
    assert "kernel eBPF filter: not run" in port_out
    for header in ("top flows (device sketches, resolved 5-tuples):",
                   "per-service RED (DDSketch quantiles):"):
        rows = section(port_out, header)
        assert rows and rows == section(jax_out, header), header
    assert answers["topk"]["values"] and answers["red"]["values"]
