"""Agent: the capture-side pipeline, batch-columnar, on the card.

The port of the JAX package's `agent/` process (reference: agent/ in
Rust). `dispatcher` pulls decoded packets (`packet.decode_packets`)
through the policy labeler; `flow_map.FlowMap` turns them into flows
with `tcp_perf.TcpPerf`, each batch's segment reduction on the card;
`l7` and `l7_ext` extract L7 request logs and merge sessions;
`quadruple` folds flows into 1 s metric Documents, reduced on the card;
`flow_aggr` and `packet_sequence` are the flow-log aggregation and the
per-packet header collector; `sender.UniformSender` ships everything to
the ingester. `trident.Agent` wires them with the controller sync loop,
and `python -m deepflow_tpu_torch.agent -f agent.yaml` runs it over a
capture source (`afpacket`, `pcap`). The eBPF, uprobe, plugin, wasm and
profiler modules are not ported: configuring them raises
NotImplementedError.
"""

from deepflow_tpu_torch.agent.packet import decode_packets
from deepflow_tpu_torch.agent.flow_map import FlowMap
from deepflow_tpu_torch.agent.trident import Agent, AgentConfig

__all__ = ["decode_packets", "FlowMap", "Agent", "AgentConfig"]
