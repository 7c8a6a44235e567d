"""The port's analyzer (deepflow_tpu_torch/analysis/) against the JAX
package's, on the CPU.

The JAX package's `tests/test_analysis.py` runs against the port
(`torch_ctl_pair.adopt_reference_tests`, its repo-level checks pointed
at the port's tree and its own stores under `analysis/stores/`: the
port's self-scan gates clean on its baseline, its twin store is in
lockstep with its tree). Beside them: `fingerprint` gives the JAX
package's result on every def of the JAX tree; both analyzers find the
same findings on the JAX tree's sources with no stores (the port's scan
reads them relabeled to `deepflow_tpu_torch/`), rule by rule and line
by line; the port's default store paths lie inside the port, and a
`--ack-*` run in a temporary copy of the repo writes only its own
store."""

import hashlib
import os
import shutil
import subprocess
import sys
from collections import Counter

import torch_analysis_pair as ap
import torch_ctl_pair as cp

from deepflow_tpu import analysis as janalysis
from deepflow_tpu.analysis import core as jcore
from deepflow_tpu.analysis import twins as jtwins
from deepflow_tpu_torch import analysis as tanalysis
from deepflow_tpu_torch.analysis import core as tcore
from deepflow_tpu_torch.analysis import twins as ttwins

cp.adopt_reference_tests(
    globals(), ap.TESTS / "test_analysis.py",
    replace=ap.REPLACE + ap.repo_replace("lint-baseline", "lint-twins") + (
        ("from deepflow_tpu.utils.twinmark",
         "from deepflow_tpu_torch.utils.twinmark"),
        ('str(REPO_ROOT / "deepflow_tpu")',
         'str(REPO_ROOT / "deepflow_tpu_torch")'),
    ))


def test_fingerprint_equal_on_every_def_of_the_jax_tree():
    _ctxs, index, errors = jcore.build_index(ap.tree_sources("deepflow_tpu"))
    assert errors == []
    n = 0
    for defs in index.defs_by_path.values():
        for node in defs.values():
            assert ttwins.fingerprint(node) == jtwins.fingerprint(node)
            n += 1
    assert n > 1000, n


def test_same_findings_on_the_jax_tree():
    """Every rule over the JAX package's sources with no stores, its
    README in scope: the port's scan of the same sources relabeled to
    deepflow_tpu_torch/ finds the same findings, line by line."""
    sources = dict(ap.tree_sources("deepflow_tpu"))
    readme = (ap.REPO_ROOT / "README.md").read_text()
    jf = janalysis.run_on_sources(sources, doc_text=readme)
    tf = tanalysis.run_on_sources(
        {ap.relabel(p): ap.relabel(s) for p, s in sources.items()},
        doc_text=readme)
    assert set(tanalysis.all_rules()) == set(janalysis.all_rules())
    assert ap.finding_rows(tf) == ap.finding_rows(jf, swap=True)
    # with no stores every declared twin pair, schema and model reads
    # as unacknowledged: the comparison covers those rules too
    by_rule = Counter(f.rule for f in jf)
    for rule in ("twin-drift", "pytree-schema-drift", "model-conform"):
        assert by_rule[rule] > 0, by_rule


def _digests(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = (
                    hashlib.sha256(fh.read()).hexdigest(),
                    os.stat(p).st_mtime_ns)
    return out


def test_store_paths_are_the_ports_own(tmp_path):
    stores = {
        "baseline": tcore.default_baseline_path(),
        "twins": tcore.default_twin_store_path(),
        "programs": tcore.default_programs_store_path(),
        "schemas": tcore.default_schemas_store_path(),
        "conform": tcore.default_conform_store_path(),
    }
    port_dir = str(ap.REPO_ROOT / ap.STORES)
    root_files = {str(ap.REPO_ROOT / f) for f in (
        ".lint-baseline.json", ".lint-twins.json", ".lint-programs.json",
        ".lint-schemas.json", ".model-conform.json")}
    for key, path in stores.items():
        assert os.path.dirname(path) == port_dir, (key, path)
        assert path not in root_files and os.path.exists(path), key
    assert {jcore.default_twin_store_path(),
            jcore.default_conform_store_path(),
            jcore.default_programs_store_path(),
            jcore.default_schemas_store_path()} <= root_files
    # every --ack-* in a copy of the repo writes only its own store
    repo = tmp_path / "repo"
    shutil.copytree(ap.REPO_ROOT / "deepflow_tpu_torch",
                    repo / "deepflow_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in sorted(root_files) + [str(ap.REPO_ROOT / "README.md")]:
        shutil.copy2(f, repo)
    before = _digests(repo)
    script = (
        "import sys\n"
        "from deepflow_tpu_torch.cli import main\n"
        "pkg = 'deepflow_tpu_torch'\n"
        "scope = [pkg + '/utils/u32.py', pkg + '/serving/tables.py']\n"
        "for argv in (['lint', *scope, '--ack-twin'],\n"
        "             ['lint', *scope, '--ack-programs', '--ack-schemas'],\n"
        "             ['verify', '--ack-conform']):\n"
        "    assert main(argv) == 0, argv\n")
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.run([sys.executable, "-c", script], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("twin store updated", "programs store updated",
                 "schemas store updated", "conformance store updated"):
        assert line in proc.stdout, proc.stdout
    assert f"-> {repo / ap.STORES}/" in proc.stdout
    after = _digests(repo)
    assert set(after) == set(before)
    changed = sorted(p for p in after if after[p] != before[p])
    assert changed == [f"{ap.STORES}/{n}.json" for n in (
        "lint-programs", "lint-schemas", "lint-twins", "model-conform")]
    # the copy's tree is this tree: the rewritten stores read the same
    for name in ("lint-programs", "lint-schemas", "lint-twins",
                 "model-conform"):
        rel = f"{ap.STORES}/{name}.json"
        assert (repo / rel).read_text() == (ap.REPO_ROOT / rel).read_text()
