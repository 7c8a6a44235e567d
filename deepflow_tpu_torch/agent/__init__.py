"""The agent-side pieces of the port.

The agent's flow path: `packet.decode_packets` (raw frames -> MetaPacket
columns), `flow_map.FlowMap` (packets -> flows, with `tcp_perf.TcpPerf`;
each batch's segment reduction on the card), `quadruple` (flows -> 1 s
Documents, reduced on the card, and their METRICS records) and
`trident`'s wire half (tick columns -> TAGGEDFLOW records and L4_SCHEMA
planes). Beside it, what the server half needs: the packet-sequence
envelope decoder (`packet_sequence`) and the sequenced TCP sender
(`sender.UniformSender`) that `runtime/stats.StatsShipper` ships DFSTATS
through. The `Agent` orchestrator, the capture front, the L7 parsers and
`flow_aggr` are not ported.
"""

from deepflow_tpu_torch.agent.flow_map import FlowMap
from deepflow_tpu_torch.agent.packet import decode_packets

__all__ = ["decode_packets", "FlowMap"]
