"""The explicit-state explorer behind `df-ctl verify`.

Breadth-first search over a Model's reachable states:

- every reached state is checked against every invariant; the first
  violation stops the search with a counterexample — BFS means the
  trace is a SHORTEST schedule to the bug, which is what makes the
  output readable as a post-mortem instead of a core dump;
- fault actions draw from a per-execution budget (`max_faults`), the
  "N shards, <= 2 concurrent faults" bound that keeps CI honest; a
  state reached with fewer faults spent dominates the same state
  reached with more (more remaining budget = strictly more behaviors),
  so each canonical state is expanded once, at its cheapest fault cost;
- symmetry reduction: successors are canonicalized through the model's
  `symmetry` hook before hashing, so schedules that differ only by a
  shard-id permutation collapse into one state;
- a state with no enabled action that the model does not bless as
  `done` is a DEADLOCK;
- after the (violation-free) sweep, the liveness pass: every reachable
  state must be able to reach a `goal` state through NON-fault actions.
  A state that cannot is a LIVELOCK under weak fairness — in these
  models every progress action stays enabled once enabled (queues
  don't spontaneously drain, deadlines don't un-expire), so "goal
  unreachable" is exactly "some fair schedule never resolves the
  ledger", without the full machinery of Büchi acceptance. Progress
  may not DEPEND on injecting further faults, hence the non-fault
  restriction; non-fault transitions never consult the fault budget,
  so the goal-reachability graph is well-defined per canonical state.

The wall-clock budget (`budget_s`) returns an INCOMPLETE result rather
than lying: `CheckResult.complete` is False and the CLI exits 2 — a
partial sweep is not a proof (no-silent-caps).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from deepflow_tpu_torch.analysis.model.spec import Model, State

__all__ = ["Violation", "CheckResult", "check", "render_trace"]

# (canonical state, faults spent) — the trace-tree node identity
_Key = Tuple[tuple, int]


class Violation:
    """One counterexample: what broke, and the schedule that breaks it."""

    def __init__(self, kind: str, name: str, message: str,
                 trace: List[str], state: State) -> None:
        self.kind = kind          # "invariant" | "deadlock" | "livelock"
        self.name = name
        self.message = message
        self.trace = trace        # action labels, init -> violating state
        self.state = state


class CheckResult:
    def __init__(self, model: Model, ok: bool, complete: bool,
                 states: int, transitions: int, elapsed_s: float,
                 max_faults: int,
                 violation: Optional[Violation] = None) -> None:
        self.model_name = model.name
        self.ok = ok
        self.complete = complete
        self.states = states
        self.transitions = transitions
        self.elapsed_s = elapsed_s
        self.max_faults = max_faults
        self.violation = violation

    def to_dict(self) -> dict:
        out = {"model": self.model_name, "ok": self.ok,
               "complete": self.complete, "states": self.states,
               "transitions": self.transitions,
               "elapsed_s": round(self.elapsed_s, 3),
               "max_faults": self.max_faults}
        if self.violation is not None:
            v = self.violation
            out["violation"] = {"kind": v.kind, "name": v.name,
                                "message": v.message,
                                "trace_len": len(v.trace)}
        return out


def check(model: Model, max_faults: int = 2,
          budget_s: Optional[float] = None,
          max_states: int = 2_000_000,
          symmetry: bool = True) -> CheckResult:
    """Exhaustively explore `model` within the fault budget.

    `symmetry=False` disables the reduction (the state-count-bound test
    proves the reduction actually reduces)."""
    t0 = time.monotonic()
    sym = model.symmetry if symmetry else None

    def canon_state(state: State) -> State:
        return dict(sym(state)) if sym is not None else state

    init = canon_state(dict(model.init))
    init_canon = tuple(sorted(init.items()))

    # canon -> fewest faults it was reached with (domination pruning);
    # every canon in here is expanded exactly once, at that cost
    best: Dict[tuple, int] = {init_canon: 0}
    # trace tree: (canon, faults) -> (parent node, action label)
    parent: Dict[_Key, Tuple[Optional[_Key], Optional[str]]] = {
        (init_canon, 0): (None, None)}
    # non-fault edges REVERSED, canon-level, for the liveness pass
    rev: Dict[tuple, List[tuple]] = {}
    goal_canons: Set[tuple] = set()
    queue: deque = deque([(init, 0)])
    transitions = 0
    expanded = 0

    def trace_of(key: _Key) -> List[str]:
        steps: List[str] = []
        cur: Optional[_Key] = key
        while cur is not None:
            p, label = parent[cur]
            if label is not None:
                steps.append(label)
            cur = p
        steps.reverse()
        return steps

    def result(ok: bool, complete: bool,
               violation: Optional[Violation] = None) -> CheckResult:
        return CheckResult(model, ok, complete, len(best), transitions,
                           time.monotonic() - t0, max_faults, violation)

    # the initial state must satisfy the invariants too
    bad = model.check_invariants(init)
    if bad is not None:
        return result(False, True, Violation(
            "invariant", bad[0], bad[1], [], init))

    while queue:
        expanded += 1
        if budget_s is not None and (expanded & 0x1FF) == 0 \
                and time.monotonic() - t0 > budget_s:
            return result(True, False)
        state, faults = queue.popleft()
        canon = tuple(sorted(state.items()))
        if best.get(canon, max_faults + 1) < faults:
            continue              # dominated while queued
        key: _Key = (canon, faults)
        if model.goal is not None and model.goal(state):
            goal_canons.add(canon)
        any_enabled = False
        for action in model.enabled(state):
            if action.fault is not None and faults >= max_faults:
                continue          # budget spent: this fault can't fire
            any_enabled = True
            nf = faults + (1 if action.fault is not None else 0)
            for succ in action.successors(state):
                transitions += 1
                succ = canon_state(succ)
                scanon = tuple(sorted(succ.items()))
                skey: _Key = (scanon, nf)
                if skey not in parent:
                    parent[skey] = (key, action.label())
                if action.fault is None:
                    rev.setdefault(scanon, []).append(canon)
                bad = model.check_invariants(succ)
                if bad is not None:
                    return result(False, True, Violation(
                        "invariant", bad[0], bad[1],
                        trace_of(skey), succ))
                prior = best.get(scanon)
                if prior is None or nf < prior:
                    best[scanon] = nf
                    if len(best) > max_states:
                        return result(True, False)
                    queue.append((succ, nf))
        if not any_enabled and not model.done(state):
            return result(False, True, Violation(
                "deadlock", "deadlock",
                "no action is enabled and the model is not done — "
                "the protocol wedged", trace_of(key), state))

    # -- liveness: every state reaches a goal via non-fault steps ----------
    if model.goal is not None:
        reaches = set(goal_canons)
        frontier = list(goal_canons)
        while frontier:
            nxt: List[tuple] = []
            for node in frontier:
                for pred in rev.get(node, ()):
                    if pred not in reaches:
                        reaches.add(pred)
                        nxt.append(pred)
            frontier = nxt
        for canon, faults in sorted(best.items(),
                                    key=lambda kv: kv[1]):
            if canon in reaches:
                continue
            stuck = dict(canon)
            enabled = [a.label() for a in model.enabled(stuck)
                       if a.fault is None]
            return result(False, True, Violation(
                "livelock", "goal-unreachable",
                "no sequence of protocol steps from here ever reaches "
                "the goal (ledger resolved / epoch quiet) — a "
                "weakly-fair schedule spins forever; enabled non-fault "
                f"steps: {enabled or ['<none>']}",
                trace_of((canon, faults)), stuck))
    return result(True, True)


def render_trace(result: CheckResult) -> str:
    """The counterexample as a readable schedule (the `--trace-out`
    artifact). Registry-armable fault steps carry their real
    runtime/faults.py site string, so a trace reads like the chaos
    spec that would replay it (process-level events like SIGKILL are
    named as such — never site-shaped)."""
    lines: List[str] = []
    r = result
    lines.append(f"model: {r.model_name}  "
                 f"(states={r.states}, transitions={r.transitions}, "
                 f"max_faults={r.max_faults}, "
                 f"elapsed={r.elapsed_s:.2f}s, "
                 f"complete={'yes' if r.complete else 'NO — budget'})")
    if r.violation is None:
        lines.append("result: OK — every invariant holds in every "
                     "reachable state; every state resolves")
        return "\n".join(lines)
    v = r.violation
    lines.append(f"result: {v.kind.upper()} [{v.name}]")
    lines.append(f"  {v.message}")
    lines.append("schedule (shortest):")
    if not v.trace:
        lines.append("  <initial state>")
    for i, step in enumerate(v.trace, 1):
        lines.append(f"  {i:3d}. {step}")
    lines.append("state at violation:")
    for k in sorted(v.state):
        lines.append(f"  {k} = {v.state[k]!r}")
    return "\n".join(lines)
