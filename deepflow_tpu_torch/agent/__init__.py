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
capture source (`afpacket`, `xdp`, `pcap`; `bpf.BpfFilter` filters a
socket in the kernel). `plugin` and `wasm_plugin` (over `wasm_vm`) load
.so and sandboxed wasm L7 parsers into `l7`'s registry, `k8s_watch`
lists and watches a Kubernetes apiserver, `profiler` samples OnCPU
stacks with perf events, and `integration` forwards third-party pushes
onto the firehose. The eBPF tracer front: `ebpf_source.EbpfTracer`
turns syscall records (SOCK_DATA images, `socket_trace.parse_record`)
into merged l7 wire records with thread-session trace ids and slow
file-IO events; `socket_trace`, `uprobe_trace` (OpenSSL and Go TLS) and
`http2_trace` author their kernel program suites in the in-tree
assembler, `perf_ring` attaches them over the PMU and drains their
per-CPU rings, `btf` and `x86_decode` find Go's g pointer and exit
sites. `AgentConfig.debug_port` opens the UDP debug server that
`python -m deepflow_tpu_torch.cli agent ...` queries.
"""

from deepflow_tpu_torch.agent.packet import decode_packets
from deepflow_tpu_torch.agent.flow_map import FlowMap
from deepflow_tpu_torch.agent.trident import Agent, AgentConfig

__all__ = ["decode_packets", "FlowMap", "Agent", "AgentConfig"]
