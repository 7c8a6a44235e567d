"""The cross-host pod epoch protocol model (parallel/multihost.py)
— in the reference, proven BEFORE the runtime was written.

A faithful small-world abstraction of `HostPodCoordinator`: two host
lanes, each a whole-host fault domain (its own ingest queue, local
shard accumulation, local merged-bus snapshot and ALIVE -> LOST
ladder), coordinated over a LOSSY DCN channel — the epoch marker
travels host-ward in DCN transit and may be dropped
(``dcn.marker_loss``) or held by a severed link (``dcn.partition``); a
host's epoch contribution travels leader-ward the same way. The
per-shard machinery below each host is the single-host `pod_epoch`
model, already proven — this model checks the HOST-granularity ladder
stacked on top: marker broadcast, contribution aggregation, deadline
exclusion of a whole host, host kill + rejoin-by-snapshot, and
partition heal with late-contribution merge-next-epoch.

State-space discipline is pod_epoch's: the model carries only ``debt =
sent - delivered - host - lost`` and checks it equals the pending rows
the model can SEE (queued + accumulated + in DCN transit + posted at
the leader + restorable). ``delivered`` at THIS level means merged
into a published CROSS-HOST epoch — rows a host merged locally but the
leader has not merged yet are still pending (the in-flight residual
the runtime tracks per lane). A healed host's late contribution merged
twice, or an excluded host's rows discarded uncounted, both break the
equality — and both are seeded as mutants below.

Transition <-> code map (gated by the conformance layer; see
CONFORMANCE):

- ``send``          <-> ``HostPodCoordinator.put_lanes`` (flow-hash
                        host routing; a LOST host's slice drops COUNTED)
- ``work``          <-> the host lane's local shard apply
                        (``PodFlowSuite._apply_device``, proven in the
                        pod model)
- ``snapshot``      <-> ``HostPodCoordinator.snapshot_host`` (local
                        epoch close: accumulation -> the host's merged
                        bus, restorable after a kill)
- ``marker_arrive`` <-> ``HostPodCoordinator._pump_host`` (host agent
                        takes the DCN marker off its link)
- ``contribute``    <-> ``HostPodCoordinator._host_contribute`` (close
                        the local epoch, ship the merged leaves
                        leader-ward)
- ``deliver``       <-> ``HostPodCoordinator._collect`` (leader takes
                        one contribution off the DCN channel)
- ``close_epoch``   <-> ``HostPodCoordinator.close_epoch`` marker
                        broadcast
- ``deadline_merge``<-> ``HostPodCoordinator._merge_global`` + the
                        epoch-boundary ``rejoin_host``
- ``heal``          <-> ``SimulatedDcnTransport.heal``
- faults: ``host.lost`` (kill: unsnapshotted rows counted lost, the
  snapshot restorable at rejoin, an in-transit contribution either
  survives in the transport or is counted lost — BOTH outcomes
  explored), ``dcn.partition`` (link severed; marker and contribution
  delivery gate on it), ``dcn.marker_loss`` (the in-transit marker
  vanishes; the host misses this epoch and merges at the next marker).

Invariants in EVERY reachable state:

- **conservation** (``debt == pending``): the pod-wide ledger across
  both hosts, exact at every instant — a double merge of a healed
  host's late contribution or an uncounted exclusion both break it;
- **ledger-sane**: debt never negative; a host snapshot never covers
  more rows than the host accumulated.

Liveness goal (weak fairness over non-fault actions): every marker
loss, partition and kill resolves — ``pending == 0`` with the
coordinator back in ``open`` stays reachable, so no row is stranded
behind a severed link or a dead host forever.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from deepflow_tpu_torch.runtime.faults import (FAULT_DCN_MARKER_LOSS,
                                               FAULT_DCN_PARTITION,
                                               FAULT_HOST_LOST)
from deepflow_tpu_torch.analysis.model.spec import Action, Model, State, updated

__all__ = ["build", "MUTANTS", "CONFORMANCE"]

# small-world bounds: 2 hosts (the acceptance configuration), two row
# tokens, host ingest queue depth 2 — every marker/row/partition
# ordering survives while the sweep stays inside the gate's time budget; the
# ledger arithmetic is unit-row, so wider batches add states, not new
# behaviors. The tests re-check at SENDS=3 under the slow marker.
N_HOSTS = 2
QCAP = 2
SENDS = 2

# the conformance contract (conform.py): the coordinator ledger this
# model abstracts, the DCN/host fault alphabet (a checked superset of
# every faults.py site under the prefixes), and the runtime transitions
# the model twins (fingerprinted into .model-conform.json)
CONFORMANCE = {
    "protocol": "hostpod",
    "ledgers": [
        {"src":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.counters",
         "counters": ["pod_rows_sent", "pod_rows_delivered",
                      "pod_rows_host", "pod_rows_lost",
                      "pod_rows_pending", "pod_hosts_missed",
                      "pod_host_rows_excluded", "pod_host_late_merges",
                      "pod_host_rejoins", "dcn_markers_sent",
                      "dcn_markers_lost"]},
    ],
    "fault_sites": ["host.lost", "dcn.partition", "dcn.marker_loss"],
    "site_prefixes": ["host.", "dcn."],
    "twins": {
        "send":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.put_lanes",
        "snapshot":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.snapshot_host",
        "marker_arrive":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator._pump_host",
        "contribute":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator._host_contribute",
        "deliver":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator._collect",
        "close_epoch":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.close_epoch",
        "deadline_merge":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator._merge_global",
        "kill":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.kill_host",
        "rejoin":
            "deepflow_tpu_torch/parallel/multihost.py:HostPodCoordinator.rejoin_host",
        "heal":
            "deepflow_tpu_torch/parallel/multihost.py:SimulatedDcnTransport.heal",
    },
}


class Ho(NamedTuple):
    """One host fault domain plus its two DCN channel ends.

    ``mk`` is the epoch marker's position: '' none, 'tf'/'tl' in DCN
    transit (fresh / demoted-late), 'qf'/'ql' arrived at the host
    agent. ``wire`` is the host's epoch contribution in leader-ward
    transit: () or (rows, late01). ``posted`` are contribution rows the
    leader holds, split (fresh, late). ``link`` models the host's DCN
    connectivity — marker arrival and contribution delivery both gate
    on it; a severed link holds messages back (the transport's
    holdback), it never loses them."""

    q: int = 0               # rows queued at the host's local lanes
    rows: int = 0            # rows in the host's local shard states
    snap: int = 0            # rows covered by the host's bus snapshot
    status: str = "A"        # A(live) | L(ost)
    mk: str = ""             # '' | tf | tl | qf | ql
    wire: Tuple[int, ...] = ()       # (rows, late01) in transit; () none
    posted: Tuple[int, int] = (0, 0)  # at the leader: (fresh, late)
    rest: int = 0            # restorable rows after a kill
    link: int = 1            # 1 connected | 0 partitioned


def _ho_pending(h: Ho) -> int:
    wire = h.wire[0] if h.wire else 0
    return h.q + h.rows + wire + h.rest + h.posted[0] + h.posted[1]


def pending_rows(state: State) -> int:
    return sum(_ho_pending(h) for h in state["hosts"])


def _set(state: State, i: int, h: Ho) -> State:
    hosts = list(state["hosts"])
    hosts[i] = h
    return updated(state, hosts=tuple(hosts))


def build(mutation: Optional[str] = None) -> Model:
    """The cross-host pod epoch model; `mutation` flips exactly one
    transition (see MUTANTS) for the self-test harness."""
    m = mutation

    init: State = {
        "hosts": tuple(Ho() for _ in range(N_HOSTS)),
        "sends": SENDS,
        "phase": "open",          # open | wait (markers broadcast)
        "debt": 0,                # sent - delivered - host - lost
    }

    actions: List[Action] = []

    # -- producer (the per-host agent firehose) ----------------------------
    def send_g(i):
        return lambda s: s["sends"] > 0

    def send_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            s = updated(s, sends=s["sends"] - 1)
            if h.status == "L" or h.q >= QCAP:
                # booked drop (LOST host / back-pressure): sent+1 and
                # lost+1 cancel in the debt
                return s
            return _set(updated(s, debt=s["debt"] + 1), i,
                        h._replace(q=h.q + 1))
        return eff

    # -- host worker (the local shard pod, proven in pod_epoch) ------------
    def work_g(i):
        def g(s: State) -> bool:
            h = s["hosts"][i]
            return h.q > 0 and h.status != "L"
        return g

    def work_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            return _set(s, i, h._replace(q=h.q - 1, rows=h.rows + 1))
        return eff

    def snap_g(i):
        def g(s: State) -> bool:
            h = s["hosts"][i]
            return h.status == "A" and h.rows > h.snap
        return g

    def snap_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            return _set(s, i, h._replace(snap=h.rows))
        return eff

    # -- the DCN channel ---------------------------------------------------
    def arrive_g(i):
        def g(s: State) -> bool:
            h = s["hosts"][i]
            return h.mk in ("tf", "tl") and bool(h.link) \
                and h.status != "L"
        return g

    def arrive_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            mk = "qf" if h.mk == "tf" else "ql"
            return _set(s, i, h._replace(mk=mk))
        return eff

    def contrib_g(i):
        def g(s: State) -> bool:
            h = s["hosts"][i]
            return h.mk in ("qf", "ql") and h.status != "L" \
                and not h.wire
        return g

    def contrib_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            late = 1 if h.mk == "ql" else 0
            h = h._replace(mk="", wire=(h.rows, late), rows=0, snap=0)
            return _set(s, i, h)
        return eff

    def deliver_g(i):
        def g(s: State) -> bool:
            h = s["hosts"][i]
            return bool(h.wire) and bool(h.link)
        return g

    def deliver_e(i):
        def eff(s: State) -> State:
            h = s["hosts"][i]
            rows, late = h.wire
            fresh_p, late_p = h.posted
            if late:
                late_p += rows
            else:
                fresh_p += rows
            return _set(s, i, h._replace(wire=(),
                                         posted=(fresh_p, late_p)))
        return eff

    def heal_g(i):
        return lambda s: not s["hosts"][i].link

    def heal_e(i):
        def eff(s: State) -> State:
            return _set(s, i, s["hosts"][i]._replace(link=1))
        return eff

    # -- faults ------------------------------------------------------------
    def kill_g(i):
        return lambda s: s["hosts"][i].status != "L"

    def kill_e(i):
        def eff(s: State):
            h = s["hosts"][i]
            lost = h.rows - h.snap        # unsnapshotted accumulation
            # the restorable set ACCUMULATES: a prior rejoin's still
            # un-shipped snapshot lives on the bus, which outlives the
            # host — a second kill must not clobber it
            base = h._replace(rows=0, snap=0, status="L", mk="",
                              rest=h.rest + h.snap)
            out = []
            if h.wire:
                # an in-transit contribution's fate is the channel's,
                # not the host's: it either survives in the transport
                # (delivered when the link allows) or the kill tore it
                # — COUNTED lost. Both outcomes are explored.
                out.append(_set(updated(s, debt=s["debt"] - lost), i,
                                base))
                torn = lost if m == "kill-wire-uncounted" \
                    else lost + h.wire[0]
                out.append(_set(updated(s, debt=s["debt"] - torn), i,
                                base._replace(wire=())))
            else:
                out.append(_set(updated(s, debt=s["debt"] - lost), i,
                                base))
            return out
        return eff

    def part_g(i):
        return lambda s: bool(s["hosts"][i].link)

    def part_e(i):
        def eff(s: State) -> State:
            return _set(s, i, s["hosts"][i]._replace(link=0))
        return eff

    def mkloss_g(i):
        return lambda s: s["hosts"][i].mk in ("tf", "tl")

    def mkloss_e(i):
        def eff(s: State) -> State:
            return _set(s, i, s["hosts"][i]._replace(mk=""))
        return eff

    # -- the coordinator ---------------------------------------------------
    def close_g(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) > 0

    def close_e(s: State) -> State:
        hosts = []
        for h in s["hosts"]:
            if h.status != "L" and h.mk == "":
                # a host still chewing a prior marker (or with one in
                # transit) is already a deep straggler: skipped, reads
                # as missed, merges at its own marker — late
                h = h._replace(mk="tf")
            hosts.append(h)
        return updated(s, phase="wait", hosts=tuple(hosts))

    def deadline_g(s: State) -> bool:
        return s["phase"] == "wait"

    def deadline_e(s: State) -> State:
        merged = 0
        lost = 0
        hosts = []
        for h in s["hosts"]:
            fresh, late = h.posted
            merged += fresh + late
            if m == "double-merge-healed-host":
                merged += late               # MUTANT: double-count
            h = h._replace(posted=(0, 0))
            # a marker (or a fresh contribution) still in flight at the
            # deadline: the host MISSED this epoch — everything it
            # ships from here is late, merged next epoch
            if h.mk == "tf":
                h = h._replace(mk="tl")
            elif h.mk == "qf":
                h = h._replace(mk="ql")
            if h.wire and not h.wire[1]:
                h = h._replace(wire=(h.wire[0], 1))
            if h.status == "L":
                # rejoin at the epoch boundary: rows the dead host's
                # queue stranded are counted lost; the host restarts
                q_lost = 0 if m == "exclude-uncounted-host-rows" \
                    else h.q
                lost += q_lost
                h = h._replace(q=0, status="A")
            if h.rest and not h.wire:
                # rejoin-by-snapshot: the restorable bus snapshot
                # re-enters as a LATE contribution over DCN as soon as
                # the leader-ward channel is free — delivered, never
                # silently dropped (a surviving in-transit contribution
                # keeps the channel busy until the next boundary)
                rest = h.rest if m == "rejoin-restorable-leak" else 0
                h = h._replace(wire=(h.rest, 1), rest=rest)
            hosts.append(h)
        return updated(s, phase="open", hosts=tuple(hosts),
                       debt=s["debt"] - merged - lost)

    for i in range(N_HOSTS):
        p = f"host{i}"
        actions.append(Action("send", send_g(i), send_e(i),
                              process=f"firehose->{p}"))
        actions.append(Action("work", work_g(i), work_e(i), process=p))
        actions.append(Action("snapshot", snap_g(i), snap_e(i),
                              process=p))
        actions.append(Action("marker_arrive", arrive_g(i), arrive_e(i),
                              process=p))
        actions.append(Action("contribute", contrib_g(i), contrib_e(i),
                              process=p))
        actions.append(Action("deliver", deliver_g(i), deliver_e(i),
                              process=f"dcn->{p}"))
        actions.append(Action("heal", heal_g(i), heal_e(i),
                              process=f"dcn->{p}"))
        actions.append(Action("kill", kill_g(i), kill_e(i),
                              process=p, fault=FAULT_HOST_LOST))
        actions.append(Action("partition", part_g(i), part_e(i),
                              process=f"dcn->{p}",
                              fault=FAULT_DCN_PARTITION))
        actions.append(Action("marker_loss", mkloss_g(i), mkloss_e(i),
                              process=f"dcn->{p}",
                              fault=FAULT_DCN_MARKER_LOSS))
    actions.append(Action("close_epoch", close_g, close_e,
                          process="leader"))
    actions.append(Action("deadline_merge", deadline_g, deadline_e,
                          process="leader"))

    # -- invariants --------------------------------------------------------
    def conservation(s: State) -> Optional[str]:
        pend = pending_rows(s)
        if s["debt"] != pend:
            how = ("a pending row was dropped from the ledger "
                   "uncounted (host exclusion / kill)" if
                   s["debt"] > pend else
                   "a row was delivered or loss-counted TWICE "
                   "(double merge of a healed host's late "
                   "contribution)")
            return (f"pod-wide conservation broken: sent - delivered "
                    f"- host - lost = {s['debt']} but the two hosts "
                    f"hold {pend} pending row(s) — {how}")
        return None

    def sane(s: State) -> Optional[str]:
        if s["debt"] < 0:
            return (f"ledger debt went negative ({s['debt']}): more "
                    f"rows delivered+host+lost than were ever sent")
        for idx, h in enumerate(s["hosts"]):
            if h.snap > h.rows:
                return (f"host{idx} snapshot covers {h.snap} rows but "
                        f"only {h.rows} accumulated — a rejoin would "
                        f"resurrect rows that were never applied")
        return None

    def done(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) == 0

    def goal(s: State) -> bool:
        return s["phase"] == "open" and pending_rows(s) == 0

    def symmetry(s: State) -> State:
        # host ids are interchangeable: every per-host fact (including
        # both DCN channel ends) lives in its own sub-state, so sorting
        # is a sound canonical form
        return updated(s, hosts=tuple(sorted(s["hosts"])))

    return Model("host-pod", init, actions,
                 [("conservation", conservation), ("ledger-sane", sane)],
                 done=done, goal=goal, symmetry=symmetry)


# name -> what the flipped transition breaks (the seeded self-test:
# every entry must die with a counterexample)
MUTANTS = {
    "double-merge-healed-host": "a healed host's late contribution is "
                                "merged twice at the deadline "
                                "(conservation)",
    "exclude-uncounted-host-rows": "the epoch-boundary rejoin discards "
                                   "a dead host's stranded queue rows "
                                   "without counting them lost "
                                   "(conservation)",
    "kill-wire-uncounted": "host.lost tears the in-transit "
                           "contribution without counting its rows "
                           "lost (conservation)",
    "rejoin-restorable-leak": "rejoin re-ships the bus snapshot but "
                              "keeps it restorable too (conservation: "
                              "the same rows pend twice)",
}
