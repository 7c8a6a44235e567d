"""The pod epoch protocol model (parallel/pod.py).

A faithful small-world abstraction of `PodFlowSuite`: N shards, each a
fault domain with its own bounded queue, device row count, rollback
snapshot and status ladder (ACTIVE -> DEGRADED -> LOST), plus the
epoch coordinator (marker post, deadline-bounded merge, auto-rejoin).
Rows are unit tokens — the ledger arithmetic is what the real protocol
promises, and it is independent of batch widths.

State-space discipline: the four monotone ledger counters (sent /
delivered / host / lost) would multiply every physical configuration
by its whole counter HISTORY, so the model carries only their derived
``debt = sent - delivered - host - lost`` — the rows the ledger still
owes an answer for. The pod's conservation equality ``sent ==
delivered + host + lost + pending`` is exactly ``debt == pending`` in
every reachable state, checked against the pending rows the model can
SEE (queued + on-device + in-flight + posted + restorable). Any
double-merge inflates `delivered` (debt under-runs pending), any
uncounted loss strands pending above debt — both shapes are seeded as
mutants and both die.

Transition <-> code map (the conformance layer gates these qualnames;
see CONFORMANCE below):

- ``send``        <-> ``PodFlowSuite.put_lanes`` / ``_book_locked`` /
                      ``_enqueue_locked`` (book + enqueue atomic; LOST
                      or full-queue slices drop COUNTED)
- ``work``        <-> ``PodFlowSuite._apply_device`` (ACTIVE) /
                      ``_absorb_host`` (DEGRADED)
- ``snapshot``    <-> ``PodFlowSuite._snapshot_shard``
- ``contribute``  <-> ``PodFlowSuite._contribute`` (marker reached:
                      copy rows out, reset state, invalidate snapshot)
- ``post_stalled``<-> the post after a ``merge.stall`` woke up: misses
                      its deadline, delivers LATE
- ``close_epoch`` <-> ``PodFlowSuite.close_epoch`` marker post
- ``deadline_merge`` <-> ``_close_epoch_serialized`` take +
                      ``_merge_epoch`` + ``rejoin``
- faults: ``shard.device_error`` (rollback-to-snapshot, degrade past
  the ladder), ``merge.stall`` (contribution copied, post delayed past
  the deadline), ``shard.lost`` (kill; rows past the snapshot lost,
  snapshot restorable at rejoin) — a superset of runtime/faults.py's
  shard sites, matched by site string.

Invariants checked in EVERY reachable state:

- **conservation** (``debt == pending``): the pod ledger over all
  interleavings; a double merge or an uncounted drop breaks it;
- **ledger-sane**: debt never negative, a snapshot never covers more
  rows than the shard accumulated (a rollback must not resurrect rows
  that were never applied).

Liveness goal (weak fairness): every excluded/late/restorable row
eventually merges or is counted lost — ``pending == 0`` with the
coordinator back in ``open`` is reachable from every state, i.e.
epochs always close and nothing is stranded.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from deepflow_tpu_torch.runtime.faults import (FAULT_MERGE_STALL,
                                               FAULT_SHARD_DEVICE_ERROR,
                                               FAULT_SHARD_LOST)
from deepflow_tpu_torch.analysis.model.spec import Action, Model, State, updated

__all__ = ["build", "MUTANTS", "CONFORMANCE"]

# small-world bounds: the N=3-shard, <=2-fault acceptance
# configuration. Two row tokens + queue depth 2 keeps every ordering
# interleaving (rows behind markers, markers skipped on a full queue)
# while the sweep fits the gate's time budget (~54k canonical states);
# the ledger arithmetic is unit-row, so wider batches add states, not
# new behaviors. The tests re-check at SENDS=3 under the slow marker.
N_SHARDS = 3
QCAP = 2
SENDS = 2
DEGRADE_AFTER = 2

# the conformance contract (conform.py): the ledger counters this model
# is an abstraction OF (must stay keys of PodFlowSuite.counters()), the
# fault alphabet (must cover every faults.py site matching the
# prefixes), and the code transitions the model twins (fingerprinted
# into .model-conform.json — editing one without re-ack fails lint)
CONFORMANCE = {
    "protocol": "pod",
    "ledgers": [
        {"src": "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite.counters",
         "counters": ["pod_rows_sent", "pod_rows_delivered",
                      "pod_rows_host", "pod_rows_lost",
                      "pod_rows_pending", "pod_rows_excluded",
                      "pod_merge_missed", "pod_late_merges",
                      "pod_rejoins"]},
    ],
    "fault_sites": ["shard.device_error", "merge.stall", "shard.lost"],
    "site_prefixes": ["shard.", "merge."],
    "twins": {
        "send": "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite.put_lanes",
        "work": "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._apply_device",
        "snapshot":
            "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._snapshot_shard",
        "contribute":
            "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._contribute",
        "device_error":
            "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._on_device_error",
        "kill": "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._mark_lost",
        "deadline":
            "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite._close_epoch_serialized",
        "rejoin": "deepflow_tpu_torch/parallel/pod.py:PodFlowSuite.rejoin",
    },
}


class Sh(NamedTuple):
    """One shard fault domain. Tokens in q: 'r' row, 'mf' fresh epoch
    marker, 'ms' stale marker (its epoch already closed — contributing
    past it is a LATE delivery). snap == 0 means no valid rollback
    snapshot (contribution and kill both invalidate it, the code's
    `gen` bump)."""

    q: Tuple[str, ...] = ()
    rows: int = 0            # rows applied to the device state
    snap: int = 0            # rows covered by the latest valid snapshot
    status: str = "A"        # A(ctive) | D(egraded) | L(ost)
    errs: int = 0            # consecutive device errors (ACTIVE only)
    infl: Tuple[int, ...] = ()   # stalled (rows, late); () = none
    posted: Tuple[int, int] = (0, 0)   # rows posted for merge: (fresh, late)
    rest: int = 0            # restorable rows after a kill


def _rows_q(sh: Sh) -> int:
    return sum(1 for t in sh.q if t == "r")


def _sh_pending(sh: Sh) -> int:
    infl = sh.infl[0] if sh.infl else 0
    return (_rows_q(sh) + sh.rows + infl + sh.rest
            + sh.posted[0] + sh.posted[1])


def pending_rows(state: State) -> int:
    return sum(_sh_pending(sh) for sh in state["shards"])


def _set(state: State, i: int, sh: Sh) -> State:
    shards = list(state["shards"])
    shards[i] = sh
    return updated(state, shards=tuple(shards))


def build(mutation: Optional[str] = None) -> Model:
    """The pod epoch model; `mutation` flips exactly one transition
    (see MUTANTS) for the self-test harness."""
    m = mutation

    init: State = {
        "shards": tuple(Sh() for _ in range(N_SHARDS)),
        "sends": SENDS,
        "phase": "open",          # open | wait (markers posted)
        "debt": 0,                # sent - delivered - host - lost
    }

    actions: List[Action] = []

    # -- producer ----------------------------------------------------------
    def send_g(i):
        return lambda s: s["sends"] > 0

    def send_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            s = updated(s, sends=s["sends"] - 1)
            if sh.status == "L" or len(sh.q) >= QCAP:
                # booked drop (LOST shard / straggler back-pressure):
                # sent+1 and lost+1 cancel in the debt
                return s
            return _set(updated(s, debt=s["debt"] + 1), i,
                        sh._replace(q=sh.q + ("r",)))
        return eff

    # -- shard worker ------------------------------------------------------
    def work_g(i):
        def g(s: State) -> bool:
            sh = s["shards"][i]
            return bool(sh.q) and sh.q[0] == "r" and sh.status != "L"
        return g

    def work_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            sh = sh._replace(q=sh.q[1:])
            if sh.status == "D":
                # host fallback absorb: rows_host moves immediately
                return updated(_set(s, i, sh), debt=s["debt"] - 1)
            return _set(s, i, sh._replace(rows=sh.rows + 1, errs=0))
        return eff

    def snap_g(i):
        def g(s: State) -> bool:
            sh = s["shards"][i]
            return sh.status == "A" and sh.rows > sh.snap
        return g

    def snap_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            return _set(s, i, sh._replace(snap=sh.rows))
        return eff

    # -- faults ------------------------------------------------------------
    def dev_err_g(i):
        def g(s: State) -> bool:
            sh = s["shards"][i]
            return sh.status == "A" and bool(sh.q) and sh.q[0] == "r"
        return g

    def dev_err_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            lost = sh.rows - sh.snap + 1        # + the failed batch row
            errs = sh.errs + 1
            if errs >= DEGRADE_AFTER:
                sh = sh._replace(q=sh.q[1:], rows=sh.snap, errs=0,
                                 status="D")
            else:
                sh = sh._replace(q=sh.q[1:], rows=sh.snap, errs=errs)
            return updated(_set(s, i, sh), debt=s["debt"] - lost)
        return eff

    def kill_g(i):
        return lambda s: s["shards"][i].status != "L"

    def kill_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            lost = sh.rows - sh.snap
            if m == "kill-uncounted":
                lost = 0                         # MUTANT: silent loss
            sh = sh._replace(rows=0, snap=0, status="L", errs=0,
                             rest=sh.snap)
            return updated(_set(s, i, sh), debt=s["debt"] - lost)
        return eff

    # -- the epoch protocol (worker side) ----------------------------------
    def contrib_g(i):
        def g(s: State) -> bool:
            sh = s["shards"][i]
            return (bool(sh.q) and sh.q[0] in ("mf", "ms")
                    and sh.status != "L" and not sh.infl)
        return g

    def contrib_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            fresh, late = sh.posted
            if sh.q[0] == "ms":
                late += sh.rows
            else:
                fresh += sh.rows
            sh = sh._replace(q=sh.q[1:], rows=0, snap=0,
                             posted=(fresh, late))
            return _set(s, i, sh)
        return eff

    def stall_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            late = sh.q[0] == "ms"
            sh = sh._replace(q=sh.q[1:], rows=0, snap=0,
                             infl=(sh.rows, late))
            return _set(s, i, sh)
        return eff

    def post_g(i):
        def g(s: State) -> bool:
            if m == "stalled-post-dropped":      # MUTANT: stranded rows
                return False
            sh = s["shards"][i]
            # a stalled post wakes AFTER its deadline passed (the stall
            # is what MADE it miss) — it delivers late, next epoch
            return bool(sh.infl) and bool(sh.infl[1])
        return g

    def post_e(i):
        def eff(s: State) -> State:
            sh = s["shards"][i]
            fresh, late = sh.posted
            sh = sh._replace(infl=(), posted=(fresh, late + sh.infl[0]))
            return _set(s, i, sh)
        return eff

    # -- the coordinator ---------------------------------------------------
    def close_g(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) > 0

    def close_e(s: State) -> State:
        shards = []
        for sh in s["shards"]:
            if sh.status != "L" and len(sh.q) < QCAP:
                sh = sh._replace(q=sh.q + ("mf",))
            # full queue: marker skipped — already a deep straggler,
            # reads as missed (the code's put_nowait/_queue.Full pass)
            shards.append(sh)
        return updated(s, phase="wait", shards=tuple(shards))

    def deadline_g(s: State) -> bool:
        return s["phase"] == "wait"

    def deadline_e(s: State) -> State:
        merged = 0
        lost = 0
        shards = []
        for sh in s["shards"]:
            fresh, late = sh.posted
            merged += fresh + late
            if m == "double-merge-late":
                merged += late                   # MUTANT: double-count
            sh = sh._replace(posted=(0, 0))
            # a fresh marker still queued (or a fresh stalled copy) at
            # the deadline: the shard MISSED — its contribution is late
            q = tuple("ms" if t == "mf" else t for t in sh.q)
            infl = sh.infl
            if infl and not infl[1]:
                infl = (infl[0], True)
            sh = sh._replace(q=q, infl=infl)
            if sh.status == "L":
                # rejoin-by-snapshot at the epoch boundary: queued rows
                # the dead worker stranded are counted lost, the bus
                # snapshot re-enters as a LATE contribution
                lost += _rows_q(sh)
                posted = (0, sh.rest)
                rest = sh.rest if m == "rejoin-restorable-leak" else 0
                sh = sh._replace(q=(), status="A", errs=0, rest=rest,
                                 posted=posted)
            shards.append(sh)
        return updated(s, phase="open", shards=tuple(shards),
                       debt=s["debt"] - merged - lost)

    for i in range(N_SHARDS):
        p = f"shard{i}"
        actions.append(Action("send", send_g(i), send_e(i),
                              process=f"producer->{p}"))
        actions.append(Action("work", work_g(i), work_e(i), process=p))
        actions.append(Action("snapshot", snap_g(i), snap_e(i), process=p))
        actions.append(Action("contribute", contrib_g(i), contrib_e(i),
                              process=p))
        actions.append(Action("post_stalled", post_g(i), post_e(i),
                              process=p))
        actions.append(Action("device_error", dev_err_g(i), dev_err_e(i),
                              process=p, fault=FAULT_SHARD_DEVICE_ERROR))
        actions.append(Action("stall", contrib_g(i), stall_e(i),
                              process=p, fault=FAULT_MERGE_STALL))
        actions.append(Action("kill", kill_g(i), kill_e(i),
                              process=p, fault=FAULT_SHARD_LOST))
    actions.append(Action("close_epoch", close_g, close_e,
                          process="coordinator"))
    actions.append(Action("deadline_merge", deadline_g, deadline_e,
                          process="coordinator"))

    # -- invariants --------------------------------------------------------
    def conservation(s: State) -> Optional[str]:
        pend = pending_rows(s)
        if s["debt"] != pend:
            how = ("a pending row was dropped from the ledger "
                   "uncounted" if s["debt"] > pend else
                   "a row was delivered or loss-counted TWICE "
                   "(double merge / double count)")
            return (f"conservation ledger broken: sent - delivered - "
                    f"host - lost = {s['debt']} but the pipeline "
                    f"holds {pend} pending row(s) — {how}")
        return None

    def sane(s: State) -> Optional[str]:
        if s["debt"] < 0:
            return (f"ledger debt went negative ({s['debt']}): more "
                    f"rows delivered+host+lost than were ever sent")
        for idx, sh in enumerate(s["shards"]):
            if sh.snap > sh.rows:
                return (f"shard{idx} snapshot covers {sh.snap} rows but "
                        f"only {sh.rows} accumulated — a rollback would "
                        f"resurrect rows that were never applied")
        return None

    def done(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) == 0

    def goal(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) == 0

    def symmetry(s: State) -> State:
        # shard ids are interchangeable: every per-shard fact lives in
        # its own sub-state, so sorting is a sound canonical form
        return updated(s, shards=tuple(sorted(s["shards"])))

    return Model("pod-epoch", init, actions,
                 [("conservation", conservation), ("ledger-sane", sane)],
                 done=done, goal=goal, symmetry=symmetry)


# name -> what the flipped transition breaks (the seeded self-test:
# every entry must die with a counterexample)
MUTANTS = {
    "double-merge-late": "late contribution merged twice at the "
                         "deadline (conservation)",
    "kill-uncounted": "shard.lost stops counting unsnapshotted rows "
                      "as lost (conservation)",
    "stalled-post-dropped": "a stalled contribution is never posted — "
                            "its rows strand in pending (livelock)",
    "rejoin-restorable-leak": "rejoin re-posts the snapshot but keeps "
                              "it restorable too (conservation: the "
                              "same rows pend twice)",
}
