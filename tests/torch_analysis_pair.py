"""Shared harness of the analyzer tests (`tests/test_torch_analysis.py`,
`test_torch_devprog.py`, `test_torch_model.py`): the rewrites that compile
the JAX package's analyzer tests against the port's `analysis/`
(`torch_ctl_pair.adopt_reference_tests`), and both packages' trees as
(path, source) pairs.

The JAX tests' repo-level checks read the JAX package's stores at the
repo root and scan `deepflow_tpu/`; their port counterparts read the
port's own stores under `deepflow_tpu_torch/analysis/stores/` and scan
the port's tree."""

from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO_ROOT = TESTS.parent
STORES = "deepflow_tpu_torch/analysis/stores"

# the analyzer, the twin marker and the fault registry the fixtures
# import, rewritten to the port (the CLI already is: torch_ctl_pair)
REPLACE = (
    ("from deepflow_tpu import analysis",
     "from deepflow_tpu_torch import analysis"),
    ("deepflow_tpu.analysis", "deepflow_tpu_torch.analysis"),
)

def repo_replace(*names):
    """The repo-level checks' store paths (`REPO_ROOT / ".<name>.json"`)
    as the port's own stores."""
    return tuple((f'REPO_ROOT / ".{n}.json"',
                  f'REPO_ROOT / "{STORES}/{n}.json"') for n in names)


def tree_sources(pkg):
    """(posix path from the repo root, source) of every .py file of the
    package directory `pkg`, sorted."""
    out = []
    for f in sorted((REPO_ROOT / pkg).rglob("*.py")):
        if "__pycache__" in f.parts:
            continue
        out.append((f.relative_to(REPO_ROOT).as_posix(), f.read_text()))
    return out


def relabel(text):
    """The JAX package's name in paths, refs and imports, as the port's."""
    return text.replace("deepflow_tpu/", "deepflow_tpu_torch/") \
        .replace("deepflow_tpu.", "deepflow_tpu_torch.")


def finding_rows(findings, swap=False):
    """Comparable rows of findings; `swap` relabels the JAX package's
    paths and messages."""
    f = relabel if swap else (lambda s: s)
    return [(x.rule, f(x.path), x.line, x.col, f(x.message), x.severity)
            for x in findings]
