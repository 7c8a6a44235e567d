"""The port's device-plane rules (deepflow_tpu_torch/analysis/devprog.py)
on the CPU: the JAX package's `tests/test_devprog.py` runs against the
port (`torch_ctl_pair.adopt_reference_tests`), its repo-level checks
pointed at the port's tree and its own stores under `analysis/stores/`.

The port has no `jax.jit` site, so the rules keyed on jit sites
(donation-use-after-donate, retrace-hazard, u32-overflow's jnp side, the
per-value host-sync pass) find nothing in its tree by the analyzer's
"proven absence only" posture: the port's programs store is committed
empty, where the JAX package's holds its twenty-odd programs. Every
fixture case runs as in the JAX package."""

import torch_analysis_pair as ap
import torch_ctl_pair as cp

cp.adopt_reference_tests(
    globals(), ap.TESTS / "test_devprog.py",
    replace=ap.REPLACE + ap.repo_replace("lint-programs", "lint-schemas") + (
        ("from deepflow_tpu.utils.u32", "from deepflow_tpu_torch.utils.u32"),
        # no jit site in the port: its store holds no program
        ('    assert len(store["programs"]) >= 20\n',
         '    assert store["programs"] == {}\n'),
    ))
