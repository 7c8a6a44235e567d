"""The spill/drain durability ladder model (runtime/spill.py).

Abstracts one `SpillQueue` over one `OverwriteQueue`: put-path overflow
past the watermark diverts to CRC-framed segment files, segments roll
(flush + **fsync**) at `segment_bytes`, the drain thread replays whole
segments oldest-first and deletes only AFTER a complete re-inject, and
the disk budget evicts the oldest closed segment COUNTED. The model
adds the two events the prose guarantees are about: a SIGKILL at any
instant (worst-case durability: every unsynced byte is gone, the torn
tail is CRC-detected and skipped, a mid-drain segment file survives
whole and replays fully on restart) and the ``spill.write`` fault
(disk full / EIO: the undurable remainder books as counted loss).

Transition <-> code map (gated by conform.py):

- ``produce``     <-> ``SpillQueue._sink`` / ``SegmentStore.append``
- ``roll`` rides produce <-> ``SegmentStore._roll_locked`` (fsync)
- ``evict`` rides produce <-> ``SegmentStore._enforce_budget_locked``
- ``drain_take``  <-> ``SegmentStore.take_oldest``
- ``drain_step``  <-> ``OverwriteQueue.reinject`` via ``_drain_loop``
- ``drain_done``  <-> ``SegmentStore.delete`` (only after the full
                      re-inject — a crash before it replays the whole
                      segment again: at-least-once, <= 1 segment of
                      duplicates)
- ``kill`` (SIGKILL) / ``restart`` <-> process death + the next
  process arming the same directory

Invariants in EVERY reachable state:

- **conservation**: ``produced + duplicates == consumed + ring +
  on_disk + evicted + kill_lost`` — every record is somewhere, every
  loss is counted, and the only over-delivery is the explicitly
  tracked replay-after-kill duplication;
- **kill-bound**: any single SIGKILL loses at most ONE unsynced
  segment (``<= SEGCAP`` records) — the fsync-on-roll contract; the
  drop-fsync mutant piles up unsynced closed segments and dies here;
- **dup-bound**: duplicates never exceed one segment per kill, and a
  kill-free execution has ZERO duplicates (replay never duplicates).

Liveness goal: everything produced eventually resolves — ring, disk
and drain all empty with the process alive (replay always completes).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from deepflow_tpu_torch.analysis.model.spec import Action, Model, State, updated

__all__ = ["build", "MUTANTS", "CONFORMANCE"]

RCAP = 1          # ring capacity past the watermark (spill threshold)
SEGCAP = 2        # records per segment before the fsync roll
BUDGET_SEGS = 1   # closed segments the disk budget allows
PRODUCE = 5       # producer budget

CONFORMANCE = {
    "protocol": "spill",
    "ledgers": [
        {"src": "deepflow_tpu_torch/runtime/spill.py:SpillQueue.counters",
         "counters": ["spilled_records", "replayed", "spill_evicted",
                      "spill_write_errors", "torn_segments",
                      "pending_segments"]},
    ],
    "fault_sites": ["spill.write"],
    "twins": {
        "produce": "deepflow_tpu_torch/runtime/spill.py:SpillQueue._sink",
        "roll": "deepflow_tpu_torch/runtime/spill.py:SegmentStore._roll_locked",
        "evict":
            "deepflow_tpu_torch/runtime/spill.py:SegmentStore._enforce_budget_locked",
        "drain": "deepflow_tpu_torch/runtime/spill.py:SpillQueue._drain_loop",
        "take": "deepflow_tpu_torch/runtime/spill.py:SegmentStore.take_oldest",
        "torn": "deepflow_tpu_torch/runtime/spill.py:read_segment",
    },
}


def _disk(s: State) -> int:
    """Primary (not-yet-reinjected) records on disk: the open segment,
    closed segments, and the un-reinjected remainder of a mid-drain
    segment (its already-reinjected prefix lives in ring/consumed; the
    file keeps it only as potential duplication until the delete)."""
    drain_left = s["drain"][0] if s["drain"] else 0
    return s["open"] + sum(r for r, _sync in s["closed"]) + drain_left


def build(mutation: Optional[str] = None) -> Model:
    m = mutation

    init: State = {
        "sends": PRODUCE,
        "alive": True,
        "ring": 0,
        "open": 0,                  # records in the open (unsynced) segment
        "closed": (),               # ((records, synced), ...) oldest first
        "drain": (),                # (left, done, synced) or ()
        "produced": 0, "consumed": 0, "evicted": 0,
        "kill_lost": 0, "dup": 0, "kills": 0, "wfaults": 0,
        "last_kill_lost": 0,        # unsynced records THIS kill lost
    }

    def _budget(closed: tuple, evicted: int) -> Tuple[tuple, int]:
        """Oldest-closed eviction past the budget, COUNTED — unless the
        evict-uncounted mutant forgets the counter."""
        closed = tuple(closed)
        while len(closed) > BUDGET_SEGS:
            recs, _sync = closed[0]
            closed = closed[1:]
            if m != "evict-uncounted":
                evicted += recs
        return closed, evicted

    # -- producer (put path) -----------------------------------------------
    def produce_g(s: State) -> bool:
        return s["alive"] and s["sends"] > 0

    def produce_e(s: State) -> State:
        s = updated(s, sends=s["sends"] - 1, produced=s["produced"] + 1)
        if s["ring"] < RCAP:
            return updated(s, ring=s["ring"] + 1)
        # overflow past the watermark: divert to the open segment
        open_recs = s["open"] + 1
        closed, evicted = s["closed"], s["evicted"]
        if open_recs >= SEGCAP:
            # the roll: flush + fsync + close (drop-fsync mutant leaves
            # the rolled segment unsynced — a later kill eats it)
            synced = m != "drop-fsync-on-roll"
            closed, evicted = _budget(closed + ((open_recs, synced),),
                                      evicted)
            open_recs = 0
        return updated(s, open=open_recs, closed=closed, evicted=evicted)

    def wfault_g(s: State) -> bool:
        # the spill-path write is what the fault tears: only armable
        # when a produce would actually hit the segment store
        return s["alive"] and s["sends"] > 0 and s["ring"] >= RCAP

    def wfault_e(s: State) -> State:
        # SpillWriteError: the undurable remainder is COUNTED loss,
        # never an exception into the producer
        return updated(s, sends=s["sends"] - 1,
                       produced=s["produced"] + 1,
                       evicted=s["evicted"] + 1,
                       wfaults=s["wfaults"] + 1)

    # -- consumer ----------------------------------------------------------
    def consume_g(s: State) -> bool:
        return s["alive"] and s["ring"] > 0

    def consume_e(s: State) -> State:
        return updated(s, ring=s["ring"] - 1,
                       consumed=s["consumed"] + 1)

    # -- drain thread ------------------------------------------------------
    def take_g(s: State) -> bool:
        return (s["alive"] and not s["drain"] and s["ring"] == 0
                and (bool(s["closed"]) or s["open"] > 0))

    def take_e(s: State) -> State:
        closed = s["closed"]
        open_recs = s["open"]
        if not closed:
            # only the open segment holds data: roll it first so the
            # drain never starves behind the writer's open handle
            synced = m != "drop-fsync-on-roll"
            closed = ((open_recs, synced),)
            open_recs = 0
        (recs, synced), closed = closed[0], closed[1:]
        return updated(s, open=open_recs, closed=closed,
                       drain=(recs, 0, synced))

    def step_g(s: State) -> bool:
        return (s["alive"] and bool(s["drain"]) and s["drain"][0] > 0
                and s["ring"] < RCAP)

    def step_e(s: State) -> State:
        left, done, synced = s["drain"]
        return updated(s, ring=s["ring"] + 1,
                       drain=(left - 1, done + 1, synced))

    def done_g(s: State) -> bool:
        return s["alive"] and bool(s["drain"]) and s["drain"][0] == 0

    def done_e(s: State) -> State:
        if m == "replay-redeliver":
            # MUTANT: the delete is skipped — the fully-reinjected
            # segment goes back on disk and will replay AGAIN
            _left, done, synced = s["drain"]
            return updated(s, drain=(),
                           closed=((done, synced),) + s["closed"])
        return updated(s, drain=())

    # -- SIGKILL + restart -------------------------------------------------
    def kill_g(s: State) -> bool:
        return s["alive"]

    def kill_e(s: State) -> State:
        # worst-case durability: every unsynced record on disk is gone
        # (open segment + any roll the fsync mutant left unsynced); the
        # in-memory ring dies with the process (OverwriteQueue loss,
        # counted here as kill_lost too); a mid-drain segment FILE
        # survives whole — its already-reinjected prefix becomes
        # duplication when the next process replays it
        lost_seg = s["open"]
        closed = []
        for recs, synced in s["closed"]:
            if synced:
                closed.append((recs, synced))
            else:
                lost_seg += recs
        dup = s["dup"]
        if s["drain"]:
            left, done, synced = s["drain"]
            if synced:
                closed.insert(0, (left + done, synced))
                dup += done
            else:
                # unsynced file gone: only its un-reinjected remainder
                # was a primary copy (the done prefix lives in the
                # ring/consumed ledger already)
                lost_seg += left
        return updated(s, alive=False, ring=0, open=0,
                       closed=tuple(closed), drain=(),
                       kill_lost=s["kill_lost"] + lost_seg + s["ring"],
                       last_kill_lost=lost_seg,
                       dup=dup, kills=s["kills"] + 1)

    def restart_g(s: State) -> bool:
        return not s["alive"]

    def restart_e(s: State) -> State:
        return updated(s, alive=True)

    actions: List[Action] = [
        Action("produce", produce_g, produce_e, process="producer"),
        Action("consume", consume_g, consume_e, process="decoder"),
        Action("drain_take", take_g, take_e, process="drain"),
        Action("drain_step", step_g, step_e, process="drain"),
        Action("drain_done", done_g, done_e, process="drain"),
        Action("write_fail", wfault_g, wfault_e, process="producer",
               fault="spill.write"),
        # SIGKILL is a process-level event, not a runtime/faults.py
        # site: the label is deliberately NOT site-shaped so a trace
        # can never be pasted into a chaos spec as a silent no-op
        Action("sigkill", kill_g, kill_e, process="os",
               fault="SIGKILL"),
        Action("restart", restart_g, restart_e, process="os"),
    ]

    # -- invariants --------------------------------------------------------
    def conservation(s: State) -> Optional[str]:
        lhs = s["produced"] + s["dup"]
        rhs = (s["consumed"] + s["ring"] + _disk(s) + s["evicted"]
               + s["kill_lost"])
        if lhs != rhs:
            return (f"durability ledger broken: produced={s['produced']} "
                    f"+ dup={s['dup']} != consumed={s['consumed']} + "
                    f"ring={s['ring']} + disk={_disk(s)} + "
                    f"evicted={s['evicted']} + "
                    f"kill_lost={s['kill_lost']} — a record was lost "
                    f"uncounted or replayed beyond the dup ledger")
        return None

    def kill_bound(s: State) -> Optional[str]:
        if s["last_kill_lost"] > SEGCAP:
            return (f"a single SIGKILL lost {s['last_kill_lost']} "
                    f"records > one segment ({SEGCAP}) — fsync-on-roll "
                    f"is broken: closed segments were not durable")
        return None

    def dup_bound(s: State) -> Optional[str]:
        if s["kills"] == 0 and s["dup"] != 0:
            return (f"{s['dup']} duplicate(s) with no kill — replay "
                    f"must never duplicate in a crash-free run")
        if s["dup"] > SEGCAP * s["kills"]:
            return (f"dup={s['dup']} exceeds one segment per kill "
                    f"({SEGCAP} * {s['kills']})")
        return None

    def done(s: State) -> bool:
        return (s["sends"] == 0 and s["ring"] == 0 and _disk(s) == 0
                and not s["drain"])

    def goal(s: State) -> bool:
        return (s["alive"] and s["sends"] == 0 and s["ring"] == 0
                and _disk(s) == 0 and not s["drain"])

    return Model("spill-drain", init, actions,
                 [("conservation", conservation),
                  ("kill-bound", kill_bound),
                  ("dup-bound", dup_bound)],
                 done=done, goal=goal)


MUTANTS = {
    "drop-fsync-on-roll": "the roll stops fsyncing — one SIGKILL can "
                          "lose more than the open segment (kill-bound)",
    "replay-redeliver": "drain_done forgets the delete — a drained "
                        "segment replays again (conservation)",
    "evict-uncounted": "budget eviction stops counting — silent loss "
                       "(conservation)",
}
