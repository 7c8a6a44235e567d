"""deepflow-model: exhaustive explicit-state checking of the repo's
three hardest protocols.

The pod epoch protocol (parallel/pod.py), the spill/drain durability
ladder (runtime/spill.py) and the sender retransmit ring / receiver
dedup pair (agent/sender.py + runtime/receiver.py) each promise an
invariant in prose — conservation ledgers exact in every state, at most
one unsynced segment lost to a SIGKILL, exactly-once delivery into
`_dispatch`. The chaos tests exercise the interleavings their seeds
happen to drive; this package proves the invariants over ALL
interleavings of a small, faithful abstraction:

- `spec.py` — the modeling vocabulary: guarded atomic actions over
  dict states, a fault alphabet named by the REAL `runtime/faults.py`
  site strings, invariants that return messages instead of booleans.
- `explore.py` — the BFS explorer: invariant checking in every reached
  state, deadlock detection, goal-reachability livelock detection
  (weak fairness), counterexample traces rendered as readable
  schedules, state hashing + symmetry reduction over shard ids.
- `pod_epoch.py` / `spill_drain.py` / `sender_ring.py` — the three
  original committed models, each with seeded mutants the checker must
  kill — joined by `host_pod.py`, the 2-host DCN-coordinated
  epoch ladder over the single-host pod, proven BEFORE its runtime
  (`parallel/multihost.py::HostPodCoordinator`) was written.
- `mutate.py` — the self-test harness: flip one model transition at a
  time and assert every mutant dies with a counterexample.
- `conform.py` — the conformance layer: the models' ledger alphabets
  (counter names, fault sites, twin'd transition qualnames) are
  extracted from the CODE through the lint ProjectIndex and gated on
  the committed `.model-conform.json`, exactly like `.lint-twins.json`
  — so the proof cannot rot silently when pod.py gains a counter.

Entry point: `df-ctl verify` (deepflow_tpu_torch/cli.py); the
`model-conform` rule rides the normal lint gate. The committed store is
the port's own, `analysis/stores/model-conform.json`.
"""

from deepflow_tpu_torch.analysis.model.spec import (Action, Model,
                                                    freeze_state)
from deepflow_tpu_torch.analysis.model.explore import (CheckResult, Violation,
                                                       check, render_trace)
from deepflow_tpu_torch.analysis.model.mutate import (all_mutants, kill_all,
                                                      model_for)

__all__ = ["Action", "Model", "freeze_state", "CheckResult",
           "Violation", "check", "render_trace", "all_mutants",
           "kill_all", "model_for", "expand_protocol"]

PROTOCOLS = ("pod", "hostpod", "spill", "sender")


def expand_protocol(name: str) -> tuple:
    """CLI protocol names -> model names. 'pod' covers BOTH pod
    granularities — the single-host shard ladder and the cross-host
    host ladder stacked on it — so `df-ctl verify --protocol pod`
    proves the whole pod story; every other name maps to itself."""
    return ("pod", "hostpod") if name == "pod" else (name,)
