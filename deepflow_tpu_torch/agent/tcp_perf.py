"""Vectorized TCP perf engine: continuous RTT / SRT / ART / CIT.

A copy of the JAX package's `agent/tcp_perf.py` (numpy only: the
engine's state is host arrays indexed by `FlowMap`'s slots in both
packages).

Reference: agent/src/flow_generator/perf/tcp.rs — a per-packet state
machine (SessionPeer pair) that arms/clears "calculable" flags as
packets alternate direction and emits TimeStats samples:

- rtt_server (rtt_1): each SYN_ACK replying to the first SYN samples
  ts(SYN_ACK) - ts(first SYN)                       (tcp.rs:741-762)
- rtt_client (rtt_0): each handshake ACK (ack == synack.seq+1) samples
  ts(ACK) - ts(first SYN_ACK)
- rtt (full): ts(handshake ACK) - ts(first SYN), only when the SYN
  arrived before the SYN_ACK (rtt_full_precondition, tcp.rs:654-658);
  last sample wins (calc_rtt_full overwrites, tcp.rs:458)
- srt: a PSH/ACK data packet arms the opposite direction; a plain-ACK
  packet replying to it (ack == data.seq+payload) samples the delta
  (tcp.rs:826-837). Every packet kind except the arming PSH/ACK clears
  both sides, so "armed" == "the immediately previous packet was
  opposite-direction PSH data".
- art: a PSH/ACK data packet arms the opposite direction; the first
  payload packet there whose seq continues its own side's last segment
  samples against the last opposite-direction packet's timestamp
  (tcp.rs:839-850). Pure ACKs in the sampling direction do not break
  the chain; anything else does.
- cit (client idle time): client PSH data with payload > 1 after the
  handshake ACK (base = latest packet either side) or after a server
  response (base = last server packet) samples the client's think time
  (tcp.rs:892-912).
- zero-window / SYN-retrans counters (tcp.rs:878-891, 635-663).

The reference walks packets one at a time. This engine is columnar: a
batch is sorted by (flow slot, ts) once, every "previous packet" /
"last packet of class C before i" relation becomes a segmented
maximum.accumulate over positions, and the tiny per-flow chain state
(armed bits, last-packet attrs per direction) is carried across batches
in slot-indexed arrays so batch boundaries are invisible. All caps
follow the reference: SRT <= 10s, RTT/ART <= 30s (tcp.rs:36-38,
perf/mod.rs:68); zero-length samples are dropped (adjust_rtt).

Accumulators reset per report window (the reference std::mem::take's
PerfData at report); chain-state carries persist for the flow's life.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_SRT_MAX_NS = 10 * 1_000_000_000
_RTT_MAX_NS = 30 * 1_000_000_000
_ART_MAX_NS = 30 * 1_000_000_000

# tcp flag bits (agent/packet.py)
_FIN, _SYN, _RST, _PSH, _ACK, _URG = 0x01, 0x02, 0x04, 0x08, 0x10, 0x20

# packet kinds, ordered so tests read naturally
K_OTHER = 0      # interested but chain-breaking (e.g. URG data)
K_ACK = 1        # flags exactly ACK, no payload
K_DATA_PLAIN = 2  # payload, flags exactly ACK (no PSH)
K_DATA_PSH = 3   # payload, flags exactly PSH|ACK
K_SYN = 4
K_SYNACK = 5

_NONE = np.int64(-1)
_BIG = np.int64(1 << 62)


def classify(flags: np.ndarray, payload: np.ndarray):
    """(interested, kind) per packet — tcp.rs is_interested_tcp_flags:
    SYN packets must not carry FIN/RST; everything else needs ACK and no
    FIN/RST (FIN/RST are the flow machine's business, not perf's)."""
    f = flags.astype(np.int64)
    syn = (f & _SYN) > 0
    interested = np.where(
        syn, (f & (_FIN | _RST)) == 0,
        ((f & _ACK) > 0) & ((f & (_FIN | _RST)) == 0))
    pure = (f & (_SYN | _FIN | _RST | _PSH | _URG)) == 0
    psh_only = (f & (_SYN | _FIN | _RST | _PSH | _URG)) == _PSH
    kind = np.full(len(f), K_OTHER, np.int8)
    kind[syn & ((f & _ACK) == 0)] = K_SYN
    kind[syn & ((f & _ACK) > 0)] = K_SYNACK
    kind[~syn & pure & (payload == 0)] = K_ACK
    kind[~syn & pure & (payload > 0)] = K_DATA_PLAIN
    kind[~syn & psh_only & (payload > 0)] = K_DATA_PSH
    return interested, kind


class TcpPerf:
    """Slot-indexed perf accumulators + cross-batch chain carry.

    Owned by FlowMap: slots are FlowMap's slot numbers, lifecycle events
    (allocate / grow / window reset) are forwarded here.
    """

    def __init__(self, cap: int) -> None:
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        self.cap = cap
        z = lambda *s: np.zeros(s, np.int64)  # noqa: E731
        # report-window accumulators (ns sums; reported as us)
        self.rtt_cli = z(cap, 3)   # sum, count, max
        self.rtt_srv = z(cap, 3)
        self.srt = z(cap, 2, 3)    # per canonical direction
        self.art = z(cap, 2, 3)
        self.cit = z(cap, 3)
        self.rtt_full = z(cap)     # ns, last-wins
        self.zero_win = z(cap, 2)
        self.syn_ct = z(cap, 2)
        self.synack_ct = z(cap, 2)
        self.retrans_syn = z(cap)
        self.retrans_synack = z(cap)
        # chain carry (persists across windows)
        self.last_kind = np.full(cap, -1, np.int8)
        self.last_dir = np.full(cap, -1, np.int8)
        self.last_ts = z(cap)
        self.last_seq_end = z(cap)
        self.dir_ts = z(cap, 2)         # last packet ts per direction
        self.dir_seq_end = z(cap, 2)    # seq+payload of last pkt per dir
        self.dir_plen = z(cap, 2)       # payload of last pkt per dir
        self.art_armed = np.zeros((cap, 2), np.bool_)
        self.rtt_armed = np.zeros(cap, np.bool_)
        self.cit_armed = np.zeros(cap, np.bool_)
        self.syn_seen = np.zeros((cap, 2), np.bool_)
        self.synack_seen = np.zeros((cap, 2), np.bool_)
        self.syn_ack_expect = z(cap)     # first SYN seq+1 (0 = unset)
        self.synack_ack_expect = z(cap)  # first SYN_ACK seq+1 (0 = unset)
        self.syn_first = np.zeros(cap, np.bool_)  # SYN before SYN_ACK
        self.first_dir = np.full(cap, -1, np.int8)

    _FIELDS = ("rtt_cli", "rtt_srv", "srt", "art", "cit", "rtt_full",
               "zero_win", "syn_ct", "synack_ct", "retrans_syn",
               "retrans_synack", "last_kind", "last_dir", "last_ts",
               "last_seq_end", "dir_ts", "dir_seq_end", "dir_plen",
               "art_armed", "rtt_armed", "cit_armed", "syn_seen",
               "synack_seen", "syn_ack_expect", "synack_ack_expect",
               "syn_first", "first_dir")

    def grow(self, cap: int) -> None:
        old = {k: getattr(self, k) for k in self._FIELDS}
        n = self.cap
        self._alloc(cap)
        for k, v in old.items():
            getattr(self, k)[:n] = v

    def reset_slot(self, s: int) -> None:
        for k in self._FIELDS:
            a = getattr(self, k)
            a[s] = -1 if a.dtype == np.int8 and k in (
                "last_kind", "last_dir", "first_dir") else 0

    # -- ingest ------------------------------------------------------------
    def inject(self, slot: np.ndarray, d: np.ndarray, ts: np.ndarray,
               flags: np.ndarray, seq: np.ndarray, ack: np.ndarray,
               payload: np.ndarray, win: np.ndarray,
               syn_ts: np.ndarray, synack_ts: np.ndarray) -> None:
        """Fold one TCP packet batch (already flow-resolved) in.

        slot/d: FlowMap slot and canonical direction per packet;
        syn_ts/synack_ts: the flow table's first-SYN / first-SYN_ACK
        stamps per packet's slot (post-merge, so in-batch handshakes
        resolve too). Arrays must cover the same packets.
        """
        interested, kind = classify(flags, payload)
        keep = interested
        if not keep.any():
            return
        slot = slot[keep].astype(np.int64)
        d = d[keep].astype(np.int64)
        ts = ts[keep].astype(np.int64)
        kind = kind[keep]
        seq = seq[keep].astype(np.int64)
        ack = ack[keep].astype(np.int64)
        payload = payload[keep].astype(np.int64)
        win = win[keep].astype(np.int64)
        syn_ts = syn_ts[keep].astype(np.int64)
        synack_ts = synack_ts[keep].astype(np.int64)
        n = len(slot)
        seq_end = (seq + payload) & 0xFFFFFFFF

        order = np.lexsort((ts, slot))
        slot, d, ts, kind, seq, ack, payload, win, seq_end = (
            a[order] for a in (slot, d, ts, kind, seq, ack, payload, win,
                               seq_end))
        syn_ts, synack_ts = syn_ts[order], synack_ts[order]
        pos = np.arange(n, dtype=np.int64)
        new_run = np.empty(n, np.bool_)
        new_run[0] = True
        new_run[1:] = slot[1:] != slot[:-1]
        run_start = np.maximum.accumulate(np.where(new_run, pos, 0))

        def last_pos(cond, inclusive=False):
            """Segmented 'position of last packet where cond' — strictly
            before i by default; -1 where none in this run."""
            acc = np.maximum.accumulate(np.where(cond, pos, _NONE))
            if not inclusive:
                shifted = np.empty(n, np.int64)
                shifted[0] = _NONE
                shifted[1:] = acc[:-1]
                acc = shifted
            return np.where(acc >= run_start, acc, _NONE)

        def gather(p, arr, carry):
            """arr[p] where p valid, else the slot's carried value."""
            return np.where(p >= 0, arr[np.maximum(p, 0)], carry[slot])

        ackish = (kind == K_ACK) | (kind == K_DATA_PLAIN)
        is_data = payload > 0
        is_psh = kind == K_DATA_PSH
        # snapshot: the counts section below flips synack_seen, but the
        # syn-before-synack precondition must see the pre-batch state
        sa_seen_before = self.synack_seen[slot].any(axis=1)

        # previous interested packet (SRT's whole context)
        has_prev = ~new_run
        prev_kind = np.where(has_prev, np.roll(kind, 1),
                             self.last_kind[slot])
        prev_dir = np.where(has_prev, np.roll(d, 1), self.last_dir[slot])
        prev_ts = np.where(has_prev, np.roll(ts, 1), self.last_ts[slot])
        prev_seq_end = np.where(has_prev, np.roll(seq_end, 1),
                                self.last_seq_end[slot])

        # last packet / last-data-psh / chain-breaker positions
        lp_dir = [last_pos(d == k) for k in (0, 1)]
        lp_dir_in = [last_pos(d == k, inclusive=True) for k in (0, 1)]
        oppo_ts = np.where(
            d == 0, gather(lp_dir[1], ts, self.dir_ts[:, 1]),
            gather(lp_dir[0], ts, self.dir_ts[:, 0]))
        same_seq_end = np.where(
            d == 0, gather(lp_dir[0], seq_end, self.dir_seq_end[:, 0]),
            gather(lp_dir[1], seq_end, self.dir_seq_end[:, 1]))
        oppo_plen = np.where(
            d == 0, gather(lp_dir[1], payload, self.dir_plen[:, 1]),
            gather(lp_dir[0], payload, self.dir_plen[:, 0]))
        same_ts = np.where(
            d == 0, gather(lp_dir[0], ts, self.dir_ts[:, 0]),
            gather(lp_dir[1], ts, self.dir_ts[:, 1]))
        same_plen = np.where(
            d == 0, gather(lp_dir[0], payload, self.dir_plen[:, 0]),
            gather(lp_dir[1], payload, self.dir_plen[:, 1]))

        # -- SRT: ackish reply to the immediately previous opposite-dir
        # PSH data (every other packet kind clears both sides' arming)
        srt_ns = ts - prev_ts
        srt_ok = (ackish & (prev_kind == K_DATA_PSH) & (prev_dir >= 0)
                  & (prev_dir != d) & (ack == prev_seq_end)
                  & (srt_ns > 0) & (srt_ns <= _SRT_MAX_NS))

        # -- ART: armed[d] == last event affecting art[d] is PSH data in
        # ~d. Events clearing art[d]: PSH data in d, ackish in ~d, OTHER
        # / SYN / SYNACK anywhere. Ackish in d is a no-op (the pure ACK
        # between request and response).
        art_ok = np.zeros(n, np.bool_)
        for dd in (0, 1):
            mine = d == dd
            set_p = last_pos(is_psh & (d != dd))
            clear_p = last_pos((is_psh & (d == dd))
                               | (ackish & (d != dd))
                               | (kind == K_OTHER) | (kind == K_SYN)
                               | (kind == K_SYNACK))
            armed = np.where(
                (set_p < 0) & (clear_p < 0),
                self.art_armed[slot, dd], set_p > clear_p)
            art_ok |= mine & is_data & armed & (seq == same_seq_end)
        art_base = oppo_ts
        art_ns = ts - art_base
        art_ok &= (art_ns > 0) & (art_ns <= _ART_MAX_NS)

        # -- handshake RTT. rtt_armed == last syn/synack after any
        # breaker (non-ackish, non-syn packet ends "handshaking").
        hs_set = last_pos((kind == K_SYN) | (kind == K_SYNACK))
        hs_clear = last_pos(~ackish & (kind != K_SYN) & (kind != K_SYNACK))
        rtt_armed = np.where((hs_set < 0) & (hs_clear < 0),
                             self.rtt_armed[slot], hs_set > hs_clear)

        # expected ack numbers: carried, else the run's FIRST in-batch
        # SYN / SYN_ACK. A global minimum.accumulate can't be segmented
        # the way last_pos is (an earlier run's smaller position shadows
        # the in-run one), so "first cond in run" is expressed as "the
        # cond packet with no earlier cond in its run" — at most one per
        # run, so last_pos over that mask IS the first occurrence.
        syn_m = kind == K_SYN
        first_syn_m = syn_m & (last_pos(syn_m) < 0)
        fs_prev = last_pos(first_syn_m)
        sa_m = kind == K_SYNACK
        first_sa_m = sa_m & (last_pos(sa_m) < 0)
        fsa_prev = last_pos(first_sa_m)
        carry_syn_exp = self.syn_ack_expect[slot]
        syn_expect = np.where(
            carry_syn_exp > 0, carry_syn_exp,
            np.where(fs_prev >= 0,
                     (seq[np.maximum(fs_prev, 0)] + 1) & 0xFFFFFFFF,
                     _NONE))
        carry_sa_exp = self.synack_ack_expect[slot]
        synack_expect = np.where(
            carry_sa_exp > 0, carry_sa_exp,
            np.where(fsa_prev >= 0,
                     (seq[np.maximum(fsa_prev, 0)] + 1) & 0xFFFFFFFF,
                     _NONE))

        rtt_srv_ns = ts - syn_ts
        rtt_srv_ok = ((kind == K_SYNACK) & rtt_armed & (syn_ts > 0)
                      & (ack == syn_expect)
                      & (rtt_srv_ns > 0) & (rtt_srv_ns <= _RTT_MAX_NS))
        hsack = ackish & rtt_armed & (ack == synack_expect) \
            & (synack_expect > 0)
        rtt_cli_ns = ts - synack_ts
        rtt_cli_ok = hsack & (synack_ts > 0) & (rtt_cli_ns > 0) \
            & (rtt_cli_ns <= _RTT_MAX_NS)

        # rtt_full: handshake ACK vs first SYN, only when the SYN
        # preceded the SYN_ACK; last sample wins (ascending-ts scatter)
        syn_first = self._syn_first_flag(slot, fs_prev, fsa_prev)
        rtt_full_ns = ts - syn_ts
        rtt_full_ok = hsack & syn_first & (syn_ts > 0) \
            & (rtt_full_ns > 0) & (rtt_full_ns <= _RTT_MAX_NS)

        # -- CIT: client PSH data with payload > 1
        first_dir = self.first_dir[slot]
        first_dir = np.where(first_dir >= 0, first_dir,
                             self._batch_first_dir(d, run_start))
        is_client_req = is_psh & (payload > 1) & (d == first_dir)
        hs_p = last_pos(hsack, inclusive=False)
        consume_p = last_pos(is_client_req)
        cit_hs_armed = np.where((hs_p < 0) & (consume_p < 0),
                                self.cit_armed[slot], hs_p > consume_p)
        both_base = np.maximum(same_ts, oppo_ts)
        cit_ns = np.where(cit_hs_armed, ts - both_base, ts - oppo_ts)
        cit_fallback = ((oppo_plen > 1)
                        & ((same_plen <= 1) | (oppo_ts > same_ts)))
        cit_ok = is_client_req & (cit_hs_armed | cit_fallback) \
            & (cit_ns > 0) & (oppo_ts > 0)

        # -- counters
        zw = (kind != K_SYN) & (kind != K_SYNACK) & (win == 0)

        # -- scatter samples into window accumulators ---------------------
        for ok, ns, acc in ((rtt_cli_ok, rtt_cli_ns, self.rtt_cli),
                            (rtt_srv_ok, rtt_srv_ns, self.rtt_srv),
                            (cit_ok, cit_ns, self.cit)):
            if ok.any():
                i = np.nonzero(ok)[0]
                np.add.at(acc[:, 0], slot[i], ns[i])
                np.add.at(acc[:, 1], slot[i], 1)
                np.maximum.at(acc[:, 2], slot[i], ns[i])
        for ok, ns, acc in ((srt_ok, srt_ns, self.srt),
                            (art_ok, art_ns, self.art)):
            if ok.any():
                i = np.nonzero(ok)[0]
                np.add.at(acc[:, :, 0], (slot[i], d[i]), ns[i])
                np.add.at(acc[:, :, 1], (slot[i], d[i]), 1)
                np.maximum.at(acc[:, :, 2], (slot[i], d[i]), ns[i])
        if rtt_full_ok.any():
            i = np.nonzero(rtt_full_ok)[0]
            self.rtt_full[slot[i]] = rtt_full_ns[i]   # last wins
        if zw.any():
            i = np.nonzero(zw)[0]
            np.add.at(self.zero_win, (slot[i], d[i]), 1)

        # SYN / SYNACK counts and duplicate (retrans) counts — grouped
        # over just the matched packets (O(batch), not O(cap))
        for kk, ct, seen, dup in (
                (K_SYN, self.syn_ct, self.syn_seen, self.retrans_syn),
                (K_SYNACK, self.synack_ct, self.synack_seen,
                 self.retrans_synack)):
            m = kind == kk
            if not m.any():
                continue
            i = np.nonzero(m)[0]
            np.add.at(ct, (slot[i], d[i]), 1)
            # duplicates per (slot, dir): every one after the first ever
            key = slot[i] * 2 + d[i]
            uniq, counts = np.unique(key, return_counts=True)
            us_, ud = uniq // 2, uniq % 2
            extra = counts - np.where(seen[us_, ud], 0, 1)
            np.add.at(dup, us_, np.maximum(extra, 0))
            seen[us_, ud] = True

        # -- carry update at run ends -------------------------------------
        run_end = np.empty(n, np.bool_)
        run_end[:-1] = new_run[1:]
        run_end[-1] = True
        e = np.nonzero(run_end)[0]
        es = slot[e]
        self.last_kind[es] = kind[e]
        self.last_dir[es] = d[e].astype(np.int8)
        self.last_ts[es] = ts[e]
        self.last_seq_end[es] = seq_end[e]
        for dd in (0, 1):
            p = lp_dir_in[dd][e]
            have = p >= 0
            tgt = es[have]
            src = p[have]
            self.dir_ts[tgt, dd] = ts[src]
            self.dir_seq_end[tgt, dd] = seq_end[src]
            self.dir_plen[tgt, dd] = payload[src]
            # armed bits, evaluated INCLUSIVE of the run's last packet
            set_p = np.maximum.accumulate(
                np.where(is_psh & (d != dd), pos, _NONE))
            clear_p = np.maximum.accumulate(
                np.where((is_psh & (d == dd)) | (ackish & (d != dd))
                         | (kind == K_OTHER) | (kind == K_SYN)
                         | (kind == K_SYNACK), pos, _NONE))
            sp = np.where(set_p[e] >= run_start[e], set_p[e], _NONE)
            cp = np.where(clear_p[e] >= run_start[e], clear_p[e], _NONE)
            upd = (sp >= 0) | (cp >= 0)
            self.art_armed[es[upd], dd] = (sp > cp)[upd]
        hs_set_in = np.maximum.accumulate(
            np.where((kind == K_SYN) | (kind == K_SYNACK), pos, _NONE))
        hs_clear_in = np.maximum.accumulate(
            np.where(~ackish & (kind != K_SYN) & (kind != K_SYNACK),
                     pos, _NONE))
        sp = np.where(hs_set_in[e] >= run_start[e], hs_set_in[e], _NONE)
        cp = np.where(hs_clear_in[e] >= run_start[e], hs_clear_in[e],
                      _NONE)
        upd = (sp >= 0) | (cp >= 0)
        self.rtt_armed[es[upd]] = (sp > cp)[upd]
        hs_in = np.maximum.accumulate(np.where(hsack, pos, _NONE))
        con_in = np.maximum.accumulate(np.where(is_client_req, pos, _NONE))
        sp = np.where(hs_in[e] >= run_start[e], hs_in[e], _NONE)
        cp = np.where(con_in[e] >= run_start[e], con_in[e], _NONE)
        upd = (sp >= 0) | (cp >= 0)
        self.cit_armed[es[upd]] = (sp > cp)[upd]
        # expected-ack carries: first SYN/SYNACK seq+1 (set once).
        # Same segmented-first trick as above, inclusive of the run's
        # last packet.
        fs_in = np.maximum.accumulate(np.where(first_syn_m, pos, _NONE))
        fsa_in = np.maximum.accumulate(np.where(first_sa_m, pos, _NONE))
        fs_e = np.where(fs_in[e] >= run_start[e], fs_in[e], _NONE)
        fsa_e = np.where(fsa_in[e] >= run_start[e], fsa_in[e], _NONE)
        for p, exp in ((fs_e, self.syn_ack_expect),
                       (fsa_e, self.synack_ack_expect)):
            have = (p >= 0) & (exp[es] == 0)
            exp[es[have]] = (seq[p[have]] + 1) & 0xFFFFFFFF
        fd = self.first_dir[es]
        need = fd < 0
        # the run's FIRST packet sets the flow's first-packet direction
        self.first_dir[es[need]] = d[run_start[e]][need].astype(np.int8)
        # syn-before-synack precondition, frozen at the first SYN_ACK
        self._update_syn_first(es, fs_e, fsa_e,
                               sa_seen_before[e], carry_syn_exp[e])

    def _syn_first_flag(self, slot, fs_prev, fsa_prev):
        """Per packet: had the flow's first SYN_ACK been preceded by a
        SYN? Frozen once a SYN_ACK has been seen. fs_prev/fsa_prev are
        the segmented first-SYN / first-SYN_ACK positions (-1 = none in
        this run before i)."""
        seen = self.synack_seen[slot].any(axis=1)
        carried = self.syn_first[slot]
        syn_before = self.syn_ack_expect[slot] > 0
        in_batch = (fsa_prev >= 0) & (fs_prev >= 0) & (fs_prev < fsa_prev)
        return np.where(seen, carried,
                        np.where(fsa_prev >= 0, syn_before | in_batch,
                                 carried))

    def _update_syn_first(self, es, fs_e, fsa_e, sa_seen_before,
                          syn_exp_before):
        """Freeze the syn-before-synack flag for flows whose FIRST ever
        SYN_ACK landed in this batch (fs_e/fsa_e: segmented first-SYN /
        first-SYN_ACK positions per run, -1 = none). Both "seen" inputs
        are PRE-batch snapshots — the counts/carry sections above
        already flipped the live arrays, and a SYN arriving after the
        SYN_ACK in the same batch must not satisfy the precondition."""
        newly = (fsa_e >= 0) & ~sa_seen_before
        had_syn = (syn_exp_before > 0) | ((fs_e >= 0) & (fs_e < fsa_e))
        self.syn_first[es[newly]] = had_syn[newly]

    @staticmethod
    def _batch_first_dir(d, run_start):
        return d[run_start]

    # -- report ------------------------------------------------------------
    def report(self, idx: np.ndarray, cli: np.ndarray) -> Dict[str,
                                                               np.ndarray]:
        """Window perf columns for the emitted slots, oriented
        client->server (cli = per-flow client direction index). Stats
        prefer the non-first-packet direction (tcp.rs:552-577 reports
        art_1/srt_1 when updated, else art_0/srt_0)."""
        us = lambda a: np.minimum(a // 1000, 0xFFFFFFFF)  # noqa: E731
        fd = self.first_dir[idx]
        fd = np.where(fd >= 0, fd, cli).astype(np.int64)
        r = np.arange(len(idx))

        def pick(acc):
            one = acc[idx][r, 1 - fd]     # direction "1" = non-first
            zero = acc[idx][r, fd]
            use1 = one[:, 1] > 0
            return np.where(use1[:, None], one, zero)

        srt, art = pick(self.srt), pick(self.art)
        out = {
            "rtt": us(self.rtt_full[idx]).astype(np.uint32),
            "rtt_client": us(self.rtt_cli[idx, 2]).astype(np.uint32),
            "rtt_server": us(self.rtt_srv[idx, 2]).astype(np.uint32),
            "rtt_client_sum": us(self.rtt_cli[idx, 0]).astype(np.uint32),
            "rtt_client_count": self.rtt_cli[idx, 1].astype(np.uint32),
            "rtt_server_sum": us(self.rtt_srv[idx, 0]).astype(np.uint32),
            "rtt_server_count": self.rtt_srv[idx, 1].astype(np.uint32),
            "srt_sum": us(srt[:, 0]).astype(np.uint32),
            "srt_count": srt[:, 1].astype(np.uint32),
            "srt_max": us(srt[:, 2]).astype(np.uint32),
            "art_sum": us(art[:, 0]).astype(np.uint32),
            "art_count": art[:, 1].astype(np.uint32),
            "art_max": us(art[:, 2]).astype(np.uint32),
            "cit_sum": us(self.cit[idx, 0]).astype(np.uint32),
            "cit_count": self.cit[idx, 1].astype(np.uint32),
            "cit_max": us(self.cit[idx, 2]).astype(np.uint32),
            "zero_win_tx": self.zero_win[idx][r, cli].astype(np.uint32),
            "zero_win_rx": self.zero_win[idx][r, 1 - cli].astype(
                np.uint32),
            "syn_count": self.syn_ct[idx].sum(axis=1).astype(np.uint32),
            "synack_count": self.synack_ct[idx].sum(axis=1).astype(
                np.uint32),
            "retrans_syn": self.retrans_syn[idx].astype(np.uint32),
            "retrans_synack": self.retrans_synack[idx].astype(np.uint32),
        }
        return out

    def window_reset(self, idx: np.ndarray) -> None:
        """Zero the report-window accumulators (chain carry persists)."""
        for a in (self.rtt_cli, self.rtt_srv, self.cit):
            a[idx] = 0
        for a in (self.srt, self.art):
            a[idx] = 0
        self.rtt_full[idx] = 0
        self.zero_win[idx] = 0
        self.syn_ct[idx] = 0
        self.synack_ct[idx] = 0
        self.retrans_syn[idx] = 0
        self.retrans_synack[idx] = 0
