"""Self-test by mutation: prove the checker can actually
see the bug classes it claims to guard.

Each protocol model ships a MUTANTS table — named single-transition
flips of exactly the shape a bad refactor would introduce (double-count
the late merge, skip the dedup seq check, drop the fsync-on-roll). The
harness builds each mutant, runs the same exhaustive check CI runs, and
demands a counterexample: a mutant that SURVIVES means the model (or
the explorer) has a blind spot, and the whole `df-ctl verify` verdict
is worth nothing — so `df-ctl verify --mutants` runs the kill sweep.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from deepflow_tpu_torch.analysis.model import explore
from deepflow_tpu_torch.analysis.model.explore import CheckResult

__all__ = ["model_for", "all_mutants", "kill_all", "KillReport"]


def _modules():
    from deepflow_tpu_torch.analysis.model import (host_pod, pod_epoch,
                                                   sender_ring, spill_drain)
    return {"pod": pod_epoch, "hostpod": host_pod,
            "spill": spill_drain, "sender": sender_ring}


def model_for(protocol: str, mutation: Optional[str] = None):
    """The (optionally mutated) Model for one protocol name."""
    mods = _modules()
    if protocol not in mods:
        raise ValueError(f"unknown protocol {protocol!r} "
                         f"(know: {', '.join(sorted(mods))})")
    mod = mods[protocol]
    if mutation is not None and mutation not in mod.MUTANTS:
        raise ValueError(
            f"unknown mutant {mutation!r} for {protocol} "
            f"(know: {', '.join(sorted(mod.MUTANTS))})")
    return mod.build(mutation)


def all_mutants() -> List[Tuple[str, str, str]]:
    """[(protocol, mutant name, what it should break), ...]"""
    out = []
    for proto, mod in sorted(_modules().items()):
        for name, why in sorted(mod.MUTANTS.items()):
            out.append((proto, name, why))
    return out


class KillReport:
    def __init__(self) -> None:
        # (protocol, mutant) -> CheckResult
        self.results: Dict[Tuple[str, str], CheckResult] = {}
        self.survivors: List[Tuple[str, str]] = []
        self.incomplete: List[Tuple[str, str]] = []

    @property
    def ok(self) -> bool:
        return not self.survivors and not self.incomplete


def kill_all(protocol: Optional[str] = None, max_faults: int = 2,
             budget_s: Optional[float] = None) -> KillReport:
    """Run every seeded mutant (of one protocol, or all) and collect
    the verdicts. A mutant is KILLED when the checker finds a
    counterexample; an incomplete sweep is NOT a kill. `budget_s` is
    the TOTAL wall clock for the whole sweep (the same contract as
    `df-ctl verify --budget-s`): each mutant gets whatever remains, so
    an overrun surfaces as INCOMPLETE instead of multiplying the
    budget by the mutant count."""
    import time
    deadline = None if budget_s is None else time.monotonic() + budget_s
    from deepflow_tpu_torch.analysis.model import expand_protocol
    report = KillReport()
    for proto, name, _why in all_mutants():
        if protocol is not None and proto not in expand_protocol(protocol):
            continue
        remaining = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        res = explore.check(model_for(proto, name),
                            max_faults=max_faults, budget_s=remaining)
        report.results[(proto, name)] = res
        if not res.complete and res.violation is None:
            report.incomplete.append((proto, name))
        elif res.violation is None:
            report.survivors.append((proto, name))
    return report
