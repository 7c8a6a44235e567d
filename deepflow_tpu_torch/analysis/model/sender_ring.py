"""The sender retransmit ring / receiver dedup pair model
(agent/sender.py + runtime/receiver.py).

One `UniformSender` talking to one receiver `VtapStatus` over a FIFO
connection that the ``sender.disconnect`` fault can kill at a frame
boundary — with the delivery of the in-flight frame left UNKNOWN (both
outcomes explored). The sender's ring holds every framed batch until
capacity evicts it; on reconnect the whole sent prefix re-sends
FLAGGED (`FLOW_HEADER_RETRANSMIT`), and the receiver suppresses a
flagged frame at `seq <= last_seq` as a duplicate — the at-least-once
ring plus the dedup belt is what makes delivery into `_dispatch`
exactly-once.

Transition <-> code map (gated by conform.py):

- ``send_new``   <-> ``UniformSender.send`` / ``_ring_push_locked``
                     (eviction: a sent entry is free, an unsent entry
                     is COUNTED ``retransmit_shed``)
- ``pump``       <-> ``UniformSender._pump_ring_locked``
- ``reconnect``  <-> ``UniformSender._transmit_locked`` (flag the sent
                     prefix, reset it, re-send everything)
- ``deliver``    <-> ``Receiver._dispatch`` + ``VtapStatus.observe``
                     (dup suppression / gap inference / agent-restart
                     reset)
- fault ``sender.disconnect`` <-> the chaos site in
  ``_pump_ring_locked``

Safety invariant (every reachable state): **exactly-once** — no
sequence number is ever dispatched twice (`multi` stays False). The
skip-dedup and reconnect-without-flag mutants both die here.

Liveness goal: the system quiesces with every frame ACCOUNTED —
dispatched, counted shed (never-sent eviction / close), inferred lost
by the receiver's sequence-gap ledger, or the documented residual of
evicting an already-sent frame whose delivery stayed unknowable. The
evict-unsent-silently mutant makes the goal unreachable: a frame
vanishes from every ledger at once.
"""

from __future__ import annotations

from typing import List, Optional

from deepflow_tpu_torch.runtime.faults import FAULT_SENDER_DISCONNECT
from deepflow_tpu_torch.analysis.model.spec import Action, Model, State, updated

__all__ = ["build", "MUTANTS", "CONFORMANCE"]

MAXF = 3      # frames the producer creates (seq 1..MAXF)
RING = 2      # retransmit ring capacity (frames)
CHCAP = 1     # frames in flight on the connection

CONFORMANCE = {
    "protocol": "sender",
    "ledgers": [
        {"src": "deepflow_tpu_torch/agent/sender.py:UniformSender.counters",
         "counters": ["sent_records", "retransmit_shed",
                      "retransmitted_frames", "disconnects",
                      "ring_pending_frames"]},
        {"src": "deepflow_tpu_torch/runtime/receiver.py:Receiver.counters",
         "counters": ["rx_duplicate", "seq_dropped"]},
    ],
    "fault_sites": ["sender.disconnect"],
    "twins": {
        "send_new": "deepflow_tpu_torch/agent/sender.py:UniformSender.send",
        "evict":
            "deepflow_tpu_torch/agent/sender.py:UniformSender._ring_push_locked",
        "pump":
            "deepflow_tpu_torch/agent/sender.py:UniformSender._pump_ring_locked",
        "reconnect":
            "deepflow_tpu_torch/agent/sender.py:UniformSender._transmit_locked",
        "observe": "deepflow_tpu_torch/runtime/receiver.py:VtapStatus.observe",
        "dispatch": "deepflow_tpu_torch/runtime/receiver.py:Receiver._dispatch",
    },
}


def build(mutation: Optional[str] = None) -> Model:
    m = mutation

    init: State = {
        "next_seq": 0,
        "ring": (),          # ((seq, retransmit_flag), ...) send order
        "prefix": 0,         # entries [0, prefix) already on the wire
        "conn": True,
        "chan": (),          # in-flight ((seq, flag), ...) FIFO
        "seen": False,       # receiver saw any frame yet
        "last": 0,           # receiver last_seq
        "disp": frozenset(), # seqs delivered into _dispatch
        "multi": False,      # GHOST: some seq dispatched twice
        "shed": 0,           # counted never-sent eviction
        "gap": 0,            # receiver-inferred upstream loss
        "dup": 0,            # suppressed retransmits (rx_duplicate)
        "evs": 0,            # GHOST: sent entries evicted, fate unknown
    }

    # -- sender ------------------------------------------------------------
    def send_g(s: State) -> bool:
        return s["next_seq"] < MAXF

    def send_e(s: State) -> State:
        seq = s["next_seq"] + 1
        ring, prefix = list(s["ring"]), s["prefix"]
        shed, evs = s["shed"], s["evs"]
        while len(ring) >= RING:
            ring.pop(0)
            if prefix > 0:
                prefix -= 1          # evicting a sent entry is free...
                evs += 1             # ...but its fate is now unknowable
            elif m != "evict-unsent-silently":
                shed += 1            # the ONLY counted sender-side loss
        ring.append((seq, False))
        return updated(s, next_seq=seq, ring=tuple(ring), prefix=prefix,
                       shed=shed, evs=evs)

    def pump_g(s: State) -> bool:
        return (s["conn"] and s["prefix"] < len(s["ring"])
                and len(s["chan"]) < CHCAP)

    def pump_e(s: State) -> State:
        entry = s["ring"][s["prefix"]]
        return updated(s, prefix=s["prefix"] + 1,
                       chan=s["chan"] + (entry,))

    def reconnect_g(s: State) -> bool:
        return not s["conn"]

    def reconnect_e(s: State) -> State:
        ring = s["ring"]
        if m != "reconnect-no-flag":
            # delivery of the whole sent prefix is unknown: re-send it
            # all, FLAGGED, so the dedup belt can tell a ring replay
            # from an agent restart
            ring = tuple((seq, True) if i < s["prefix"] else (seq, f)
                         for i, (seq, f) in enumerate(ring))
        return updated(s, conn=True, ring=ring, prefix=0)

    def disconnect_g(s: State) -> bool:
        return s["conn"]

    def disconnect_e(s: State) -> List[State]:
        dead = updated(s, conn=False)
        if dead["chan"]:
            # the in-flight frame's fate is exactly what a dead
            # connection cannot tell the sender: explore both
            return [dead, updated(dead, chan=())]
        return [dead]

    # -- receiver ----------------------------------------------------------
    def deliver_g(s: State) -> bool:
        return bool(s["chan"])

    def _dispatch(s: State, seq: int) -> State:
        return updated(s,
                       multi=s["multi"] or seq in s["disp"],
                       disp=s["disp"] | {seq},
                       last=max(s["last"], seq), seen=True)

    def deliver_e(s: State) -> State:
        (seq, flag), chan = s["chan"][0], s["chan"][1:]
        s = updated(s, chan=chan)
        if s["seen"] and seq <= s["last"]:
            if flag and m != "skip-dedup-seq-check":
                # a flagged frame at or below last_seq was already
                # dispatched here (or counted into the gap ledger):
                # suppress, count rx_duplicate
                return updated(s, dup=s["dup"] + 1)
            # unflagged backwards = agent restart (reset tracking and
            # deliver) — or the mutant skipping the dedup check
            return _dispatch(updated(s, last=0, seen=False), seq)
        gap = s["gap"]
        if s["seen"] and seq > s["last"] + 1:
            gap += seq - s["last"] - 1     # upstream loss, inferred
        return _dispatch(updated(s, gap=gap), seq)

    actions = [
        Action("send_new", send_g, send_e, process="sender"),
        Action("pump", pump_g, pump_e, process="sender"),
        Action("reconnect", reconnect_g, reconnect_e, process="sender"),
        Action("deliver", deliver_g, deliver_e, process="receiver"),
        Action("disconnect", disconnect_g, disconnect_e,
               process="wire", fault=FAULT_SENDER_DISCONNECT),
    ]

    # -- invariants --------------------------------------------------------
    def exactly_once(s: State) -> Optional[str]:
        if s["multi"]:
            return ("a sequence number was delivered into _dispatch "
                    "twice — at-least-once retransmit leaked through "
                    "the receiver dedup belt (double-counted sketches)")
        return None

    def sane(s: State) -> Optional[str]:
        if not (0 <= s["prefix"] <= len(s["ring"])):
            return (f"sent prefix {s['prefix']} outside the ring "
                    f"(len {len(s['ring'])})")
        return None

    def quiesced(s: State) -> bool:
        return (s["next_seq"] == MAXF and not s["chan"]
                and s["prefix"] == len(s["ring"]))

    def done(s: State) -> bool:
        return quiesced(s)

    def goal(s: State) -> bool:
        accounted = len(s["disp"]) + s["shed"] + s["gap"] + s["evs"]
        return s["conn"] and quiesced(s) and accounted >= MAXF

    return Model("sender-ring", init, actions,
                 [("exactly-once", exactly_once), ("ring-sane", sane)],
                 done=done, goal=goal)


MUTANTS = {
    "skip-dedup-seq-check": "the receiver dispatches flagged "
                            "retransmits without the seq check — "
                            "double delivery (exactly-once)",
    "reconnect-no-flag": "the ring replays unflagged after a "
                         "reconnect — the receiver reads it as an "
                         "agent restart and re-dispatches "
                         "(exactly-once)",
    "evict-unsent-silently": "ring overflow evicts a never-sent frame "
                             "without counting retransmit_shed — the "
                             "frame leaves every ledger (livelock)",
}
