"""deepflow-lint: AST invariant checks for the pipeline's disciplines.

Entry points: `df-ctl lint` (deepflow_tpu_torch/cli.py) and the `lint`
debug command (runtime/debug.py), gated against the port's own committed
stores under `analysis/stores/` (lint-baseline, lint-twins,
lint-programs, lint-schemas, model-conform). See core.py for the framework,
checkers.py for the per-file rules, concurrency.py for the whole-program
lock/race rules, twins.py for the host/device twin registry behind the
twin-drift gate, docdrift.py for the README knob/gauge coverage rule,
and model/ for deepflow-model — the explicit-state protocol checker
behind `df-ctl verify` and the model-conform gate. Rule modules are
discovered dynamically (core.all_rules walks the package), so a new
checker file registers itself.
"""

from deepflow_tpu_torch.analysis.core import (Finding, all_rules,
                                              default_baseline_path,
                                              default_conform_store_path,
                                              default_doc_path,
                                              default_twin_store_path,
                                              findings_to_json,
                                              findings_to_sarif,
                                              format_findings, load_baseline,
                                              new_findings, run_lint,
                                              run_on_sources, save_baseline,
                                              scan_package)
from deepflow_tpu_torch.analysis.twins import host_twin_of

__all__ = ["Finding", "all_rules", "default_baseline_path",
           "default_conform_store_path",
           "default_doc_path", "default_twin_store_path",
           "findings_to_json", "findings_to_sarif", "format_findings",
           "host_twin_of", "load_baseline", "new_findings", "run_lint",
           "run_on_sources", "save_baseline", "scan_package"]
