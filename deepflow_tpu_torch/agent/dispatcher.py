"""Dispatcher: capture-mode shaping + policy enforcement for one batch.

Reference: agent/src/dispatcher/ — three dispatcher flavors share a base:
local_mode (capturing the host's own interfaces: direction and l2_end
derive from the host's MAC set), mirror_mode (a mirror port carries many
VMs' traffic; per-VM MAC tables orient each packet), analyzer_mode (an
aggregated TAP feed: outer VLAN is the tap id and is stripped, tunnels
always decapped). The columnar re-design keeps one vectorized decode and
expresses each mode as column post-processing over the whole batch —
there is no per-packet mode branch.

The dispatcher also runs the policy stage (labeler + NPB/PCAP/DROP
enforcement) so `dispatch()` hands the flow map a batch that is already
oriented, labeled, and filtered — the reference's
dispatcher->labeler->flow_generator order.

The port's own copy of the JAX package's `agent/dispatcher.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Set

import numpy as np

from deepflow_tpu_torch.agent.packet import decode_packets
from deepflow_tpu_torch.agent.policy import PolicyEnforcer, PolicyLabeler

MODE_LOCAL = "local"
MODE_MIRROR = "mirror"
MODE_ANALYZER = "analyzer"

# tap_side values (reference: TapSide — client/server observation point)
SIDE_CLIENT = 0
SIDE_SERVER = 1


@dataclass
class DispatcherConfig:
    mode: str = MODE_LOCAL
    # local mode: this host's MACs; mirror mode: all monitored VM MACs
    local_macs: Set[int] = field(default_factory=set)
    decap_vxlan: bool = True


class Dispatcher:
    def __init__(self, cfg: DispatcherConfig,
                 policy: Optional[PolicyLabeler] = None,
                 enforcer: Optional[PolicyEnforcer] = None) -> None:
        if cfg.mode not in (MODE_LOCAL, MODE_MIRROR, MODE_ANALYZER):
            raise ValueError(f"unknown dispatcher mode {cfg.mode!r}")
        self.cfg = cfg
        self.policy = policy
        self.enforcer = enforcer
        self.batches = 0
        self.kept = 0

    def dispatch(self, frames: Sequence[bytes],
                 timestamps_ns: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        """frames -> decoded, mode-stamped, policy-filtered MetaPacket
        columns (the flow map's input contract)."""
        self.batches += 1
        # analyzer mode always decapsulates: the TAP aggregates overlay
        # traffic from many hypervisors
        decap = self.cfg.decap_vxlan or self.cfg.mode == MODE_ANALYZER
        pkt = decode_packets(list(frames), timestamps_ns, decap_vxlan=decap)
        n = len(pkt["valid"])

        if self.cfg.mode in (MODE_LOCAL, MODE_MIRROR) and \
                self.cfg.local_macs:
            # direction from the MAC table: a packet whose src MAC is
            # ours/monitored was SENT here (client side observation);
            # dst MAC ours = received (server side). l2_end marks the
            # side that terminates on a known MAC.
            macs = np.asarray(sorted(self.cfg.local_macs), np.uint64)
            src_local = np.isin(pkt["mac_src"], macs)
            dst_local = np.isin(pkt["mac_dst"], macs)
            pkt["tap_side"] = np.where(src_local, SIDE_CLIENT,
                                       SIDE_SERVER).astype(np.uint32)
            pkt["l2_end_0"] = src_local
            pkt["l2_end_1"] = dst_local
            if self.cfg.mode == MODE_MIRROR:
                # mirror feed carries unrelated traffic too: keep only
                # packets touching a monitored MAC
                pkt["valid"] &= src_local | dst_local
        elif self.cfg.mode == MODE_ANALYZER:
            # outer VLAN is the tap id on aggregated TAPs
            pkt["tap_type"] = pkt["vlan_id"].astype(np.uint32)
            pkt["tap_side"] = np.zeros(n, np.uint32)
        else:
            pkt["tap_side"] = np.zeros(n, np.uint32)

        if self.policy is not None:
            rule_ids = self.policy.lookup(pkt)
            # actions must never fire on packets already rejected (non-IP
            # frames decode garbage ip columns that can spuriously match
            # prefix rules; mirror mode has just filtered unmonitored MACs)
            rule_ids[~pkt["valid"]] = 0
            pkt["policy_id"] = rule_ids
            if self.enforcer is not None:
                keep = self.enforcer.apply(frames, pkt["timestamp_ns"],
                                           rule_ids)
                pkt["valid"] &= keep
        self.kept += int(pkt["valid"].sum())
        return pkt

    def counters(self) -> dict:
        c = {"mode": self.cfg.mode, "batches": self.batches,
             "kept": self.kept}
        if self.enforcer is not None:
            c.update(self.enforcer.counters())
        return c
