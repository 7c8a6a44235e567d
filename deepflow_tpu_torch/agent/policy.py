"""Policy labeler + enforcer: vectorized ACL matching over packet batches.

Reference: agent/src/policy/ — first_path (full ACL walk) + fast_path
(LRU cache) label every packet with matched policy ids, then NPB/PCAP
actions forward or capture the matched traffic. Batched columns make the
fast-path cache unnecessary: each rule is one vectorized predicate over
the whole batch, and the match matrix reduces to a first-match rule id
per packet. Rules express (ip prefix, port range, protocol) on either
side, the subset the reference's NPB/PCAP ACLs use on the hot path.

Actions (PolicyEnforcer.apply):
- NPB: matched raw frames forward over UDP to the configured packet
  broker (reference: npb sender / npb_tunnel);
- PCAP: matched frames append to a per-rule pcap capture file
  (reference: the pcap policy writing .pcap via the pcap assembler);
- DROP: matched packets are masked out of the flow pipeline.

The port's own copy of the JAX package's `agent/policy.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

ACTION_NPB = 1      # forward to packet broker
ACTION_DROP = 2     # exclude from the pipeline
ACTION_PCAP = 3     # dump to capture file


@dataclass(frozen=True)
class AclRule:
    rule_id: int
    # 0 in any field = wildcard
    ip_prefix: int = 0
    ip_mask_len: int = 0        # applies to either src or dst
    port_min: int = 0
    port_max: int = 0           # either src or dst port in range
    protocol: int = 0
    action: int = ACTION_NPB
    # DIRECTIONAL port constraints (reference FlowAcl src_ports /
    # dst_ports are independent predicates ANDed together); 0 max =
    # that side unconstrained. Distinct from port_min/max, which
    # matches either side (the pre-push rule shape).
    src_port_min: int = 0
    src_port_max: int = 0
    dst_port_min: int = 0
    dst_port_max: int = 0


def rules_from_flow_acls(acls: Sequence[dict]) -> List[AclRule]:
    """Controller-pushed FlowAcl dicts -> AclRules (reference:
    trident.proto `message FlowAcl` + the agent's policy compile,
    agent/src/policy/labeler.rs). Each acl carries port-range STRINGS
    ("80-90,443") and npb_actions; every range expands to one AclRule
    (the labeler matches ranges, not lists) and the first npb action's
    tunnel type picks the enforcement action: PCAP -> capture,
    NPB_DROP -> drop, VXLAN/GRE -> forward. Malformed entries are
    skipped, not raised: one bad pushed acl must not reject the whole
    policy set (the reference logs-and-continues too)."""
    def _ranges(spec: object) -> List[tuple]:
        out: List[tuple] = []
        for part in str(spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            lo, _, hi = part.partition("-")
            out.append((int(lo), int(hi or lo)))
        return out or [(0, 0)]                       # wildcard side

    out: List[AclRule] = []
    for acl in acls or ():
        try:
            rule_id = int(acl.get("id", 0))
            if not rule_id:
                continue
            protocol = int(acl.get("protocol", 256))
            if protocol >= 256:                      # 256 = any
                protocol = 0
            actions = acl.get("npb_actions") or ()
            tunnel = (actions[0].get("tunnel_type", 0)
                      if actions else 0)
            action = {2: ACTION_PCAP, 3: ACTION_DROP}.get(
                int(tunnel), ACTION_NPB)
            # src_ports and dst_ports are INDEPENDENT predicates ANDed
            # together (the reference semantics) — the cross product
            # of their range lists expands into rules, each carrying
            # both directional constraints
            for s_lo, s_hi in _ranges(acl.get("src_ports")):
                for d_lo, d_hi in _ranges(acl.get("dst_ports")):
                    out.append(AclRule(
                        rule_id=rule_id, protocol=protocol,
                        action=action,
                        src_port_min=s_lo, src_port_max=s_hi,
                        dst_port_min=d_lo, dst_port_max=d_hi))
        except (TypeError, ValueError, KeyError, IndexError):
            continue
    return out


class PolicyLabeler:
    def __init__(self, rules: Optional[List[AclRule]] = None) -> None:
        self.rules: List[AclRule] = list(rules or [])
        self.version = 0
        self.lookups = 0
        self.hits = 0

    def update(self, rules: List[AclRule], version: int) -> bool:
        if version == self.version:
            return False
        self.rules = list(rules)
        self.version = version
        return True

    def lookup(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """[n] int32 first-matching rule id (0 = no policy)."""
        n = len(cols["ip_src"])
        self.lookups += n
        out = np.zeros(n, np.int32)
        unmatched = np.ones(n, np.bool_)
        for r in self.rules:
            if not unmatched.any():
                break
            m = unmatched.copy()
            if r.ip_mask_len:
                mask = np.uint32((0xFFFFFFFF << (32 - r.ip_mask_len))
                                 & 0xFFFFFFFF)
                prefix = np.uint32(r.ip_prefix) & mask
                m &= ((cols["ip_src"] & mask) == prefix) | \
                     ((cols["ip_dst"] & mask) == prefix)
                # v4 CIDR rules never match v6 rows: their ip columns
                # are FNV folds, and prefix math on a hash would match
                # ~1/2^mask_len of all v6 traffic at random
                if "ip_version" in cols:
                    m &= cols["ip_version"] != 6
            if r.port_max:
                m &= ((cols["port_src"] >= r.port_min)
                      & (cols["port_src"] <= r.port_max)) | \
                     ((cols["port_dst"] >= r.port_min)
                      & (cols["port_dst"] <= r.port_max))
            if r.src_port_max:
                m &= ((cols["port_src"] >= r.src_port_min)
                      & (cols["port_src"] <= r.src_port_max))
            if r.dst_port_max:
                m &= ((cols["port_dst"] >= r.dst_port_min)
                      & (cols["port_dst"] <= r.dst_port_max))
            if r.protocol:
                m &= cols["proto"] == r.protocol
            out[m] = r.rule_id
            unmatched &= ~m
        self.hits += int((out != 0).sum())
        return out

    def counters(self) -> dict:
        return {"rules": len(self.rules), "version": self.version,
                "lookups": self.lookups, "hits": self.hits}


class PolicyEnforcer:
    """Executes rule actions on a labeled batch.

    apply(frames, ts, rule_ids) returns the keep-mask (DROP rules masked
    out); NPB rules' frames go to the broker socket, PCAP rules' frames
    append to per-rule capture files under `pcap_dir`.
    """

    def __init__(self, policy: PolicyLabeler,
                 npb_addr: Optional[str] = None,
                 pcap_dir: Optional[str] = None,
                 npb_tunnel: str = "raw") -> None:
        self.policy = policy
        self.pcap_dir = pcap_dir
        self._writers: Dict[int, object] = {}
        self._npb_sock = None
        self._npb_target = None
        if npb_addr:
            host, _, port = npb_addr.partition(":")
            self._npb_target = (host, int(port or 4789))
            self._npb_sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
        # "vxlan": RFC 7348 encap of each mirrored frame, VNI = the
        # matching rule id, 24-bit per-enforcer sequence riding the
        # header's first reserved bytes (the reference's npb_sender
        # stamps a sequence at vxlan::SEQUENCE_OFFSET the same way for
        # broker-side loss detection). A broker — or an analyzer-mode
        # agent, whose dispatcher decaps VXLAN — sees standard tunnel
        # datagrams on the 4789 target port. "raw" sends bare frames.
        if npb_tunnel not in ("raw", "vxlan"):
            raise ValueError(f"unknown npb_tunnel {npb_tunnel!r}")
        self.npb_tunnel = npb_tunnel
        self._npb_seq = 0
        self.npb_sent = 0
        self.npb_errors = 0
        self.pcap_dumped = 0
        self.dropped = 0

    def _encap(self, frame: bytes, rule_id: int) -> bytes:
        if self.npb_tunnel != "vxlan":
            return frame
        self._npb_seq = (self._npb_seq + 1) & 0xFFFFFF
        head = bytes([0x08,                          # flags: VNI valid
                      (self._npb_seq >> 16) & 0xFF,  # 24-bit sequence in
                      (self._npb_seq >> 8) & 0xFF,   # the reserved bytes
                      self._npb_seq & 0xFF])
        vni = rule_id & 0xFFFFFF
        return head + bytes([(vni >> 16) & 0xFF, (vni >> 8) & 0xFF,
                             vni & 0xFF, 0]) + frame

    def _writer(self, rule_id: int):
        w = self._writers.get(rule_id)
        if w is None:
            import os

            from deepflow_tpu_torch.agent.pcap import PcapWriter
            os.makedirs(self.pcap_dir, exist_ok=True)
            w = PcapWriter(f"{self.pcap_dir}/rule_{rule_id}.pcap")
            self._writers[rule_id] = w
        return w

    def apply(self, frames: Sequence[bytes], timestamps_ns: np.ndarray,
              rule_ids: np.ndarray) -> np.ndarray:
        """Returns [n] bool keep-mask after executing actions. The DROP
        path is fully vectorized; NPB/PCAP touch only matched frames
        (per-frame IO is inherent to those actions)."""
        keep = np.ones(len(frames), np.bool_)
        if not len(self.policy.rules):
            return keep
        max_id = max(r.rule_id for r in self.policy.rules)
        act_of = np.zeros(max_id + 1, np.int32)
        for r in self.policy.rules:
            act_of[r.rule_id] = r.action
        acts = act_of[np.minimum(rule_ids, max_id)]
        # unknown/stale ids (hot rule reload between lookup and apply)
        # get NO action, not the highest rule's
        acts[(rule_ids == 0) | (rule_ids > max_id)] = 0
        drop = acts == ACTION_DROP
        keep &= ~drop
        self.dropped += int(drop.sum())
        for i in np.nonzero(acts == ACTION_NPB)[0]:
            if self._npb_sock is None:
                break
            try:
                self._npb_sock.sendto(
                    self._encap(frames[i], int(rule_ids[i])),
                    self._npb_target)
                self.npb_sent += 1
            except OSError:
                # unreachable broker / oversized datagram: count it — a
                # silent pass would make "forwarded everything" and
                # "dropped everything" indistinguishable in self-report
                self.npb_errors += 1
        pcap_hits = np.nonzero(acts == ACTION_PCAP)[0]
        if len(pcap_hits) and self.pcap_dir is not None:
            by_rule: Dict[int, List[int]] = {}
            for i in pcap_hits:
                by_rule.setdefault(int(rule_ids[i]), []).append(int(i))
            for rid, idxs in by_rule.items():
                self._writer(rid).write([frames[i] for i in idxs],
                                        [int(timestamps_ns[i])
                                         for i in idxs])
                self.pcap_dumped += len(idxs)
        return keep

    def flush(self) -> None:
        for w in self._writers.values():
            w.flush()

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        if self._npb_sock is not None:
            self._npb_sock.close()

    def counters(self) -> dict:
        return {"npb_sent": self.npb_sent, "npb_errors": self.npb_errors,
                "pcap_dumped": self.pcap_dumped, "dropped": self.dropped}
