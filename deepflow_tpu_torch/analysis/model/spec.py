"""The modeling vocabulary for deepflow-model.

A model is a set of PROCESSES (the producer, shard workers, the epoch
coordinator, the drain thread...) whose steps are guarded ATOMIC
actions over one global state dict — the same granularity the real
code's ledger-lock sections establish ("absorb + booking + enqueue are
ONE atomic step", pod.py). Nondeterminism is explicit: an effect may
return several successor states (a frame in flight when the connection
dies was either delivered or not), and the explorer tries them all.

Faults are actions too, tagged with the REAL fault-site string from
`runtime/faults.py` (``shard.device_error``, ``merge.stall``, ...), so
a counterexample schedule reads like a chaos spec and the conformance
layer can diff the model's fault alphabet against the registry.
Process-level events the registry cannot arm (a SIGKILL) still count
against the fault budget but carry a deliberately non-site-shaped
label, so a trace never names a chaos spec that would silently no-op. The
explorer bounds how many fault actions any single execution may take
(the "N shards, <= 2 concurrent faults" budget that keeps the state
space inside CI).

States are plain dicts of ints/strs/bools/tuples (tuples all the way
down — effects must never mutate, they rebuild). `freeze_state` is the
canonical hashable form; a model's `symmetry` hook canonicalizes
before freezing (sorting the per-shard tuple makes shard ids
interchangeable, which is sound exactly when every per-shard fact
lives inside that shard's own sub-state).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Action", "Model", "freeze_state", "updated"]

State = Dict[str, object]


def freeze_state(state: State) -> tuple:
    """Canonical hashable form of a state dict. Values must already be
    immutable (ints/strs/bools/tuples/frozensets) — the models are
    written that way so freezing is a sorted-items walk, not a deep
    conversion pass."""
    return tuple(sorted(state.items()))


def updated(state: State, **changes) -> State:
    """Copy-with-changes — the one-liner every effect is built from."""
    out = dict(state)
    out.update(changes)
    return out


class Action:
    """One guarded atomic step of one process.

    - `guard(state) -> bool`: enabled?
    - `effect(state) -> state | [state, ...]`: successor(s); returning
      a list models nondeterministic outcomes of ONE step.
    - `fault`: the runtime/faults.py site string when this action IS a
      fault injection — or a non-site-shaped event name (``SIGKILL``)
      for process-level faults the registry cannot arm. Either way it
      counts against the explorer's fault budget and renders as
      `!! fault <label>` in schedules; None for protocol steps.
    - `process`: the owning process label, for schedule readability
      ("shard1", "coordinator", "drain").
    """

    __slots__ = ("name", "guard", "effect", "process", "fault")

    def __init__(self, name: str,
                 guard: Callable[[State], bool],
                 effect: Callable[[State], object],
                 process: str = "",
                 fault: Optional[str] = None) -> None:
        self.name = name
        self.guard = guard
        self.effect = effect
        self.process = process
        self.fault = fault

    def successors(self, state: State) -> List[State]:
        out = self.effect(state)
        return out if isinstance(out, list) else [out]

    def label(self) -> str:
        base = f"{self.process}.{self.name}" if self.process else self.name
        if self.fault is not None:
            return f"!! fault {self.fault} ({base})"
        return base


class Model:
    """One protocol: initial state, actions, invariants, liveness goal.

    - `invariants`: [(name, fn)] where fn(state) returns None when the
      state is fine and a MESSAGE when it is not — the message lands in
      the counterexample verbatim, so write it as the post-mortem line.
    - `done(state)`: terminal-OK predicate; a state with no enabled
      action that is not `done` is a deadlock.
    - `goal(state)`: the liveness target ("everything sent was
      delivered or counted; the epoch machinery is quiet"). The
      explorer reports a livelock when some reachable state cannot
      reach ANY goal state through non-fault actions — under weak
      fairness that is exactly a schedule that runs forever without
      ever resolving the ledger. None skips the liveness pass.
    - `symmetry(state) -> state`: canonical representative under the
      model's symmetry group (shard-id permutation); identity by
      default.
    """

    def __init__(self, name: str, init: State,
                 actions: Sequence[Action],
                 invariants: Sequence[Tuple[str, Callable[[State],
                                                          Optional[str]]]],
                 done: Callable[[State], bool],
                 goal: Optional[Callable[[State], bool]] = None,
                 symmetry: Optional[Callable[[State], State]] = None,
                 ) -> None:
        self.name = name
        self.init = init
        self.actions = list(actions)
        self.invariants = list(invariants)
        self.done = done
        self.goal = goal
        self.symmetry = symmetry

    def canon(self, state: State) -> tuple:
        if self.symmetry is not None:
            state = self.symmetry(state)
        return freeze_state(state)

    def enabled(self, state: State) -> Iterable[Action]:
        for a in self.actions:
            if a.guard(state):
                yield a

    def check_invariants(self, state: State) -> Optional[Tuple[str, str]]:
        """(invariant name, message) of the first violated invariant."""
        for name, fn in self.invariants:
            msg = fn(state)
            if msg is not None:
                return name, msg
        return None
