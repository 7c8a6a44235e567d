#!/usr/bin/env python3
"""Drive the deepflow_tpu_torch l4 sketch step, L7 RED lane, sharded
suites, flow_metrics store lane, pod, global mesh, ingester with its
operations surface, serving with the querier, and the server process
with every ingest lane, and the agent process, on one CUDA card.

    python3 chip_smoke.py [--seed S] [--window-records N] [--ramp-records N]

Phases (any failure raises: the exit code is non-zero and no result line
is printed):

1. the card's name and power limit (nvidia-smi), then every kernel of
   deepflow_tpu_torch/csrc built with nvcc for sm_90a and, beside them,
   the native TAGGEDFLOW decoder (decode/native_src/decoder.cc, g++);
   the phase fails if the decoder is not available;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, bit-exact, with padded batches and saturating
   weights, on uniform and on Zipf(1.1) inputs: hist_add at the
   Count-Min (mask only) and entropy (weights and mask) shapes, on
   one row of 2^19 bins (the wide path), and at the RED lane's shapes
   (2^14 lanes, mask only, into one row of 2^19 bins: the DDSketch, and
   of 1024 bins: requests, errors), at phase 9's per-shard shapes (2^14
   lanes: Count-Min, entropy, and the metrics suite's 2 entropy rows of
   2^10 bins with weights over the whole u32 range read as int32, past
   65535 and past 2^31), at phase 11's per-shard pod shapes (2^13
   lanes: Count-Min, entropy), the lane kernel at C=32768,
   the news kernel at C=8192; kernel, plain and library times per call
   from CUDA events after a warm-up (median of 5 runs of 20 calls),
   device times of the kernel and of the library call from
   torch.profiler; then, checked but not timed, hist on
   its widest block-private row (2^15 bins) and the lane kernel with
   entropy rows of 2^13 bins (its widest shared copy) and 2^16 bins (too
   wide for one, added straight into the state); then the device gate of
   the flight recorder (csrc/gate.cu, an instrument with no plain
   version): 512 launches of a 2^22-element add with 30 us of host work
   between launches, timed behind the gate (within 20% of
   torch.profiler's summed kernel time) and without it (above it); a
   gate held past its timeout reports the timeout; the launch queue's
   depth behind a held gate is printed;
3. the slice at the exporter defaults (FlowSuiteConfig(), batch_rows
   32768): two windows of 2^20 records each, drawn by Zipf(1.1) from a
   pool of 2^17 distinct 5-tuples, through full-row `update`, the
   exporter's inline path on the lanes wire (coalesced K=4) and on the
   dict wire. The three paths must agree on CMS, HLL, entropy and rows
   at each window close (the exporters' state read through their
   snapshot bus), each path must launch its kernels (counts set to 0
   just before the path runs), and top-K recall against an exact GROUP
   BY must be at least 0.99; the window outputs must be finite and of
   their shapes;
4. the same small input through both exporters on the card and on the
   CPU (plain versions), state and outputs compared;
5. half of one window (2^19 records; the half is the cut) of each path
   under torch.profiler: device time, its share of the wall time, and
   the largest device ops (reported, not checked);
   then one full-row batch's device kernels, which must hold exactly two
   hist launches and no float conversion;
6. the exporter as the ingester runs it, on the same two windows: the
   dict wire with the overlapped feed (depth 2) and zero-copy staging,
   fed through put() and the exporter's worker thread; the lanes wire
   with the feed (K=4); the inline dict path; the TensorBatch feed
   (`zero_copy=False`, K=4) on both wires; each with a checkpoint
   directory and a Store for its writers. Every leaf equal at every
   window close (dict feed = dict TensorBatch feed = inline dict, lanes
   feed = lanes TensorBatch feed = phase 3's inline lanes, the wire-free
   leaves across wires), each run's fused kernels launched, the
   TensorBatch feeds' records/s beside the zero-copy feeds', recall
   >= 0.99, no staging buffer back before its
   fence, the topk_flows and window_signals rows read back from the
   segment files equal to every window output (each resolved 5-tuple
   folding to its flow key), and a fresh exporter restores the last
   snapshot leaf-equal.
   The feed runs' free staging buffers must be page-locked. Then the
   device-error ladder with `tpu.device_error` armed: rollback from a
   snapshot, then (no host fallback runs for a CUDA device) the rows
   shed and counted lost, probe recovery, delivered + lost == sent.
   Then one window of each run under torch.profiler, ingest and flush
   apart: device busy share, host-to-device copy time and its overlap
   with kernels, and the CUDA runtime's copy and synchronizing calls
   between two marker calls that bracket the measured range (so the
   profiler's own calls at its start and stop fall outside), beside the
   copy activities the trace recorded by direction. While ingesting,
   the feed paths must make no stream or device sync (a host read of
   device data, `.item()` or `.cpu()`, syncs the stream after its copy),
   one event sync per fence, and no recorded device-to-host copy.
   Then attribution: the dict feed's profiled window again with the
   process tracer on (every group attributed): the tracer's stages must
   hold kernel.h2d, kernel.dispatch, kernel.device and kernel.compile,
   the occupancy profiler's tpu_device_busy_fraction must lie in (0, 1],
   the gauge tpu_h2d_mb_s must be set, and the ingest's stream, event
   and device syncs must equal the untraced window's (the sampled
   medians printed beside the busy share);
7. the detection lanes (the anomaly plane at AnomalyConfig() and the
   shadow auditor at 1/64) over a DDoS ramp on the reference generator's
   schedule (12 baseline windows, 3 ramp windows to an attack share of
   0.9 at 2x rate, 5 sustained at 3x, 8 recovery; 2^18 records per 1x
   window, benign rows from phase 3's Zipf pool, attack rows spoofed
   over a /12 onto one victim): (a) the dict feed with both lanes on,
   (b) the same with both off, (c) the dict inline path with both on.
   The first entropy_ddos alert must come at most 2 windows after the
   onset with z[0] > 0 and z[1] < 0; rows_seen == rows_in ==
   table_offers; no feed or scoring error and no alert shed; (a) and (b)
   leaf-equal sketch state at every window close, (a) and (c) equal
   anomaly state (integer leaves exact, float leaves rtol 1e-5, the PCA
   projector atol 1e-5); the audit closes every window and never alarms
   over the baseline. Then the window step timed alone, one profiled
   window with the lanes on and off (the phase-6 ingest rule asserted
   with them on; launches per dict group and the flush's stream syncs
   reported), the lanes-on window again with the tracer on (the phase 6
   attribution checks), the last ramp window of (a) traced (the gauges
   tpu_h2d_mb_s, anomaly_score, anomaly_alerts_total,
   anomaly_detect_latency_windows, anomaly_active_flows and every name
   of AUDIT_GAUGES must be set), the ladder with the lanes on (every
   device error reaches the plane's device_lost, the shed window closes
   unscored), and a
   small ramp through the plane on the card and on the CPU, its state
   compared at every window close, entropy_ddos and pca_residual alerts
   equal at every window, mp_discord alerts equal wherever a device's
   float32 score cannot reach across the threshold (its distance from
   the float64 score of the same ring is smaller than that score's
   distance from the threshold; those windows are printed);
8. the L7 RED lane (AppSuiteConfig(): 1024 groups x 512 buckets, alpha
   0.02; batch_rows 2^14) with a Store: 4 windows of 2^20 l7 request
   records (server endpoints by Zipf(1.1) from a pool of 4096, rrt_us
   log-normal with median 2,000 us and sigma 1.2 with 1% zeros, HTTP and
   enum status codes) through put() and the worker thread. Per window:
   requests and errors per group equal to an exact GROUP BY, every
   group's sketch adding up to its requests, p50/p95/p99 within alpha
   (plus the midpoint table's rounding) of the value of rank ceil(q*n)
   for every group with >= 1000 requests, the app_red rows read back
   from the segment files equal to the output; 3 hist launches and one host-to-device copy per batch. Then
   one window under torch.profiler (ingest and flush apart), and a small
   stream with u32 edges and every bucket boundary on the card and on
   the CPU, every leaf and output equal;
9. the multi-device suites on a mesh of 4 shards that share the card
   (parallel/mesh.py), global batches of 2^16 rows (2^14 per shard):
   (a) ShardedFlowSuite at FlowSuiteConfig() over phase 3's two windows
   through its four forms (columns, the full-row plane, the lanes plane,
   the dict wire from FlowDictPacker with a replicated table of 2^20
   entries): at each window close the merged CMS, HLL, entropy and rows
   equal flow_suite.update on one device, recall >= 0.99, the table
   replicas identical (every shard's leaves and the table kept as phase
   12's reference), hist launched and the fused kernels not; (b)
   ShardedAppSuite at AppSuiteConfig() over two windows of phase 8's l7
   records: every window output field equal to AppSuite on one device;
   (c) ShardedMetricsSuite at MetricsSuiteConfig() over phase 7's DDoS
   ramp, one flow_metrics Document per l4 row (`metric_documents`): 4
   shards on the card against 4 shards on the CPU (histograms exact,
   entropies within 2e-6 relative, alarms equal, z within rtol 1e-5,
   PCA projector and matrix-profile scores within rtol 1e-4) and against
   1 shard on the card (the reference's 8-against-1 tolerances), the
   basis and rings bit-identical across the 4 shards at every window;
   then the same three meshes at an EWMA rate of 0.3 and 8-window
   subsequences over 20 windows of 2^17 Documents with signal levels
   spread over orders of magnitude and a destination concentration step
   at window 12: the alarm fires there and not before, and every
   matrix-profile score from window 15 on is nonzero. Then one window
   of each suite under torch.profiler, ingest and flush apart: launches
   per global batch, busy share, a flush's syncs;
10. the flow_metrics pipeline's store lane and the rollup GROUP BY on
   the card: 8192 distinct vtap_flow_port tag tuples (cut from 16,384
   for time; ip over 4096 addresses, server_port by Zipf(1.1) over
   1024, vtap_id over 64, l3_epc_id with -1) reporting each second
   for 120 s from an hour boundary ahead of the wall clock (983,040 rows of the 66-column
   METRICS_TABLE, meters from phase 9's signals and seeded log-normals,
   some near 0xFFFFFFFF): (a) every row through
   FlowMetricsPipeline.put() in chunks of 2^14 with 2 unmarshallers, in
   4 waves with the writer flushed after each (4 segments), the rollup
   ticker running, then one advance() past both minutes: the
   base table holds every row sent, records = rows sent and no decode
   error, the 1m tier scanned back equals a plain numpy GROUP BY
   (np.unique over the 17 keys, reduceat, clipped to u32) row for row, a
   second advance() and a fresh RollupManager on the same root emit
   nothing; the build's steps timed apart; (b) group_reduce over the
   minute buckets without tag_code (keys within u32, l3_epc_id signed)
   at 2^16 and 2^18 rows and all of them, by the host and the device
   path on the card and on the CPU, every array identical, with wall
   and device times of both card paths, and the sync contract (one
   stream sync on the host path, two on the device path); (c) compact()
   of the base and the tier, scans unchanged, then a torn segment that
   scan skips and counts and compact quarantines; (d) one rollup build
   (a 120 s tier's backfill) under torch.profiler: launches, copies,
   one stream sync;
11. the pod fault domains and the cross-host pod at FlowSuiteConfig():
   (a) TpuSketchExporter(pod_shards=4, batch_rows 2^15: 2^13 rows a
   shard) through put() over phase 3's two windows: at each window close
   every leaf of the pod's merged bus snapshot and every output field
   equal to the sharded suite's lanes form on 4 shards over the same
   planes, recall >= 0.99, the pod-wide ledger closed (sent = delivered
   + host + lost + pending), 2 hist launches per shard batch and no
   fused one; ingest, flush and last_merge_s per window, then a profiled
   window, and, reported only, the sharded suite's lanes form on one
   thread (chip_pod_probe.py compares the pod's dispatch designs); (b)
   the fault ladder on a 4-shard PodFlowSuite with injected faults only:
   a device error
   rolled back from the shard's snapshot, two more degrading the shard
   (its rows shed and counted lost, no host sketch, no host output), the
   probe's recovery, a merge.stall straggler excluded at the deadline and
   merged late next epoch (ingest never blocks), a kill with rejoin by
   snapshot, the ledger closed after every step; (c) the exporter's
   pod_hosts=2, pod_shards=2 branch (batch_rows 2^16, every shard slice
   at least 2^13 rows: 2 hist launches per shard batch) over the
   simulated DCN on window 0: rows, entropies, the top-8 and every
   shared key's count equal to (a)'s 4-shard merge; then marker loss,
   partition with heal and host loss with rejoin on a coordinator, the
   ledger closed after each; (d) two processes of this script
   (`--dcn-worker`, loading the libraries phase 1 built), one host of 2
   shards each on this card, joined over gloo at tcp://127.0.0.1:<free
   port>: each one's merged epoch (output and every bus leaf) equal to
   (c)'s; a child that fails or outlives 120 s fails the phase and is
   killed;
12. the global mesh across processes: two processes of this script
   (`--mesh-worker`, loading the libraries phase 1 built), 2 shards each
   on this card, joined over gloo at tcp://127.0.0.1:<free port> into one
   `make_global_mesh` of 4 shards, each fed only its own half of every
   global batch of 2^16 rows (`process_local_batch`, or its half of the
   lane plane) of phase 9's rows: (a) ShardedFlowSuite at
   FlowSuiteConfig(), columns, lanes and dict forms, over phase 3's two
   windows (the dict form: each process runs phase 9's FlowDictPacker
   over the whole stream and passes the same full news and hits planes):
   at each window close every merged leaf and every output field in
   both processes equal to phase 9's single-process 4-shard suite, for
   the dict form also every shard's leaves equal to phase 9's same shard
   and every table replica to phase 9's table, recall >= 0.99, records/s
   per form; (b) ShardedAppSuite over phase 9b's two
   windows, every output field equal; (c) ShardedMetricsSuite at
   MetricsSuiteConfig() over the first 16 windows of the ramp's
   Documents: every shard's integer leaves equal to phase 9c's 4 card
   shards at every window close, alarms equal, entropies within abs
   1e-5, z within rtol 1e-5, each process's anomaly scores
   (`local_shard`, its own rows) and the PCA projector within rtol 1e-4,
   the matrix-profile sum within rel 1e-4; records/s per suite, the
   collectives' wall per flush and the per-update gradient sum
   reported. A child that fails or outlives 150 s fails the phase and is
   killed;
13. the ingester entry point: first the TAGGEDFLOW frames' payloads
   through the Python decoder and the native walker at 1 and 4 threads
   (columns equal, dtype for dtype and bit for bit; records/s of each,
   host numbers), then the port's `Ingester` (FlowSuiteConfig(),
   AppSuiteConfig(), the dict wire with the zero-copy feed at depth 2,
   the anomaly plane and the auditor at 1/64, a Store, the operations
   surface on its defaults: the timeline at 1.0 s with its SLO rules,
   `prom_port=0`, `debug_port=0`, a spill and an incident directory;
   windows closed by `flush_window(now)`) fed over loopback TCP with
   frames built by the port's wire modules: phase 3's two windows of
   l4 records (window 0's first 2^16 as TAGGEDFLOW protobuf records,
   the rest as planar COLUMNAR_FLOW frames; the L4_SCHEMA columns phase
   3 does not draw from the seed), 2^16 l7 requests drawn as phase 8
   draws them (PROTOCOLLOG) and 2^16 Documents drawn as phase 10 draws
   them (METRICS); the depth of both is the cut. Every l4 decoder must
   have registered the native fast path for TAGGEDFLOW. (a) One
   decoder, one connection: every sketch leaf at every window, the anomaly states and alerts, every window and RED
   output equal to a second TpuSketchExporter and AppRedExporter on the
   card fed through put() with the same frames decoded here by the
   port's decoders and stamped by the same PlatformDataManager; top-K
   recall >= 0.99; conservation hop by hop (frames received, records
   decoded, rows into the sketch, the registry's puts = the chunks its
   exporters processed, stored + sampled-out rows = decoded rows); the
   metrics 1m tier = a numpy GROUP BY. (b) Two decoders, 4 connections
   with 4 vtap_ids, the tracer on: window 0's l4 frames (the one window
   is the cut); the leaves that do not depend on the batch partition
   equal to (a)'s; records/s from the
   first byte sent to the last window flushed (beside phase 6's dict
   feed), the stage medians, launches, and one more window's ingest
   under torch.profiler: no stream or device sync, event syncs = fences,
   and tpu_device_busy_fraction's spans against torch.profiler's kernel
   share (the recorder's gate kernels left out); a strict
   validate_exposition of a /metrics scrape, /healthz, UDP round trips of
   counters, queues, breakers and spill. (b) again with the operations
   surface off: the same syncs, records/s beside (b)'s. (c) (b) with the
   feed autotuner at a 0.25 s interval: the same leaf equality and the
   same ingest stream syncs; the knobs' final values, trials and reverts
   reported;
14. the operations surface under injected faults, at phase 13's widths
   (128 planar frames of phase 3's rows): exporter.raise on the sketch
   exporter for 2 s opens its breaker, and exactly one incident bundle
   results (breaker_open; the edges of the same moment suppressed by the
   rate limit) whose timeline window holds the put errors' rise; the
   deepflow_slo_burn_rate samples of a scrape equal a numpy
   recomputation from the timeline's rings and health()["slo_burning"]
   names the fast-burning SLOs; queue.stall on the l4 ingest queue for
   2 s with 64-frame rings and the spill armed writes segments that are
   replayed (spilled = replayed, none evicted), delivered + counted loss
   = sent, and the partition-free sketch leaves equal a fault-free
   run's;
15. serving and the querier. (a) Run inside phase 10, on its store
   while it lives (1,966,080 vtap_flow_port rows and their 1m tier):
   nine statements of the DeepFlow UI's kinds (GROUP BY over 1, 2 and 3
   u32 tags with Sum, Max and Avg; derived metrics; time(60); WHERE time
   bounds, HAVING, ORDER BY ... LIMIT 100; a Percentile, whose GROUP BY
   takes the host sort with the row->group map; the 1m tier; SHOW TAG
   VALUES) through QueryEngine on the card and on the CPU: identical
   rows; two statements equal a numpy GROUP BY of phase 10's columns;
   per statement the rows grouped, the GROUP BY path taken and the wall
   p50 of 3 runs each way; one device-path query under torch.profiler
   (kernels, syncs, device-to-host copies). (b) Phase 13 (b)'s ingester
   with SnapshotCache, SketchTables and AnomalyTables mounted on its
   exporter's snapshot bus and anomaly bus and a QuerierServer on port 0
   with its timeline and incident recorder; phase 3's window 0 sent over
   4 connections, with no client and then with a client sending about
   20 requests a second over HTTP (sketch SQL to /v1/query, PromQL over
   the sketch, anomaly and timeline series to /api/v1/query and
   query_range): SketchTables.cms_points over 2^16 keys = ops/cms.query
   on the exporter's state bit for bit, hll_card = ops/hll.estimate
   within rtol 1e-6, no CMS estimate below its exact count, served top-K
   recall >= 0.99 before and after the flush, SELECT * FROM timeline and
   FROM incidents answer, the serving_p99 SLO's series has samples, and
   the ingest's syncs under torch.profiler are the same with and without
   the client (event syncs = fences); records/s both ways, HTTP and
   serving p50/p99;
16. the whole ingest surface and the server: `server.Server` from a
   JSON config (the controller off, the querier on, self-telemetry on,
   one decoder a stream, the sketch and RED lanes at FlowSuiteConfig()
   and AppSuiteConfig() with their windows closed by `flush_window(now)`,
   the RED lane's Prometheus le buckets every 8th gamma bound, a Store)
   on the card, fed over one loopback connection stream after stream:
   phase 3's window 0 cut to 2^18 records as planar frames; 4 RED
   windows of 2^15 PROTOCOLLOG requests over all 1024 services
   (log-normal rrt_us, a median per service); 2^14 OTel spans, half in
   zlib-compressed frames; PACKETSEQUENCE blocks of 2^12 flows;
   Prometheus remote write (1,024 series x 60 samples, one frame bare
   and snappy); Telegraf lines; proc and alarm events; profiles; syslog,
   StatsD and pcap. Asserted: no_handler 0 and conservation hop by hop
   (frames received = frames sent + the shipper's DFSTATS frames,
   records per decoder, rows per exporter and table), 1024 x 64 le rows
   a window, the p95 of 64 services through histogram_quantile(0.95,
   rate(app_rrt_bucket[75s])) within alpha plus one retained bucket
   width of the exact one, the StatsShipper's DFSTATS in
   deepflow_system, a /v1/query SQL and a PromQL request over the
   Server's HTTP equal to the engines on its store, a reload that
   rebuilds and answers the same, hist launched at the DDSketch and the
   service widths and both fused kernels launched, the last RED flush
   under torch.profiler with exactly 2 stream syncs (the readout, the
   gathered rows); then the same frames through a second Server on the
   CPU: every table (but deepflow_system), l4_packet blob, droplet
   artifact and dictionary equal. Printed: records/s per stream, le
   rows and device-to-host bytes per window against the 2 MB plane,
   flush walls and syncs, the start-to-first-answer time.
17. an agent's l4 stream into the ingester: one busy node's agent at
   full width, a FlowMap holding 2^16 concurrent TCP flows, capture
   batches of 4096 frames, 2^18 packets over 4 one-second ticks (the
   depth is the cut) from the phase's own generator (a 54-byte header
   template patched column by column; packets over the live flows by
   Zipf(1.1); each tick 1/8 of the flows close, 3/4 FIN and 1/4 RST,
   and as many open with a full handshake, SYNs and SYN/ACKs sometimes
   twice; payloads 64-1400 B in a request/response cycle, 1% of the
   segments retransmitted after an RTO, some zero windows). (a) the
   agent leg: decode_packets, FlowMap(device="cuda").inject per batch,
   tick_columns each second, the TaggedFlow records, and
   flows_to_documents(device="cuda") with its METRICS records; the same
   batches through a CPU twin: every tick's columns, the Documents, the
   records byte for byte and the maps' state equal; every perf column
   set somewhere and every close type seen; under torch.profiler the
   last tick's injects make one sync a batch and flows_to_documents
   one. Printed: inject packets/s on the card and the CPU, launches,
   syncs and device time per batch, the tick's wall split. (b) the
   records into the port's Ingester as phase 13(b) runs it (two
   decoders, the anomaly plane, the auditor, a Store) through 4 agents'
   UniformSenders (TAGGEDFLOW and METRICS, 8 connections; the TaggedFlow
   records first, the window flushed, then the Documents): TaggedFlow
   records sent = decoded by the native walker = the sketch exporter's
   rows_in, Documents sent = flow_metrics records, frames sent =
   received, the partition-free leaves equal a yardstick exporter's fed
   the same records through put(), no top-K count below its exact
   count. Printed, not gated: the top-K against an exact GROUP BY of the
   sent columns (a flow reports at most once a tick, so the exact top-K
   is a tie among thousands of flows at 4 records; ties count as hits).
   Printed: TaggedFlow records/s through the socket, Documents/s, the
   decoder spans over the wall, the stages, the fused and hist launches.
18. the agent process: phase 17's generator with payloads in the
   protocol of each server port (HTTP/1.1 requests and responses, TLS
   ClientHello and ServerHello, MySQL, Redis, Kafka, PostgreSQL) and
   2048 DNS queries a tick over UDP, 2^18 packets over 4 ticks (the cut
   from 2^19 is for the per-packet L7 parse on the host), a FlowMap of
   2^16 flows, 4096-frame batches. (a) the same batches through
   Agent(device="cuda") and Agent(device="cpu") on the defaults
   (columnar wire, L7 on) with packet_sequence on, ticked by hand,
   each agent's senders into a loopback receiver: every stream byte
   for byte and the counters equal; sessions merged (paired and
   unpaired) = sent + throttled. Printed: packets/s per agent, the
   sessions, the tick's wall split. (b) the packets written to a pcap
   with the port's PcapWriter (restamped by whole seconds from now),
   phase 16's server.Server on the card in this process (its l4
   throttle raised), `python -m deepflow_tpu_torch.agent -f
   <bootstrap.json>` (engine pcap, packet_sequence and self-telemetry
   on) until every valid packet is in the server's l4 rows, then
   SIGTERM: exit 0; the packets and bytes of the l4 rows and of the
   Documents in flow_metrics = the pcap's valid packets', l4 rows =
   the sketch's rows_in, l7 rows = (a)'s sessions sent (a gap past 1%
   fails), l4_packet rows and the agent's DFSTATS in deepflow_system;
   the server leg launches hist and both fused kernels. Printed:
   packets/s through the process, frames and records per stream, the
   Guard's breach count.

Phases 6 and 7's traced windows also hold the device-busy measure
against torch.profiler: tpu_device_busy_fraction's spans over the
ingest against the compute stream's kernel share, and kernel.device's
p50 against the profiler's kernel time per program and its span of each
gated program's kernels (within 30% of that span, asserted, in phase 6's
dict feed, where every group is gated).

Each phase prints its time. `--one-generator` draws phase 2's rows for
phase 9's shapes from the generator phases 2-8 share instead of their
own, so phases 3-8 run on another draw of their data. The last two
lines of standard output are the kernels' JSON record and {"ok": true,
"device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# the kernels do 32-bit integer ALU work; the H100 table's nearest rate
# is fp32 outside the tensor cores
ALU_OPS_PER_S = 67e12
# per record of the fused kernels: 5 fold steps x ~11 ops, 8 bucket
# hashes x ~9 ops, unpack, weight and address arithmetic ~20
FUSED_OPS_PER_RECORD = 150
# per (row, lane) item of hist: clamp, weight, address, add
HIST_OPS_PER_ITEM = 4
# the card's memory access granule: a scatter-add moves the sectors that
# hold a bin it changes, not the whole state
SECTOR_BYTES = 32
WARMUP, ITERS, REPEATS = 3, 20, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Time per call of fn on the current stream, from CUDA events: the
    median over REPEATS runs of the mean of ITERS back-to-back calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(REPEATS):
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / ITERS)
    return float(np.median(means))


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit operations over ALU_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def touched_bytes(*deltas) -> int:
    """Bytes of state a scatter-add must read and write: each 32-byte
    sector holding a bin that it changed, once each way. `deltas` are
    what the plain version added into zero states on this run's inputs,
    so the data decides the count, not the state's width."""
    return 2 * SECTOR_BYTES * sum(
        int((d.reshape(-1, SECTOR_BYTES // 4) != 0).any(1).sum())
        for d in deltas)


def _device_events(torch, prof):
    """(name, self device microseconds) of the kernels and copies that
    ran on the card, from a profiler's key averages."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != cuda:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            out.append((evt.key, float(us)))
    return out


def _torch_ops(torch, prof):
    """[name, self device ms, calls] of the torch ops that launched the
    device work, largest first."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == cuda:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append([evt.key, float(us) / 1e3, int(evt.count)])
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, names=None, attempts=3):
    """Mean device time per call of fn, summed over the kernels whose
    names contain one of `names` (every device event with None;
    torch.profiler); a session in which the profiler recorded none of
    them is repeated, up to `attempts` sessions; None if none did."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        us = sum(t for k, t in _device_events(torch, prof)
                 if names is None or any(n in k for n in names))
        if us > 0:
            return us / ITERS / 1e3
    return None


# -- phase 2: kernels against their plain versions ---------------------------

C_LANE, C_NEWS = 1 << 15, 1 << 13      # the lane and news kernels' batches
HIST_C = 1 << 15                       # lanes per hist call (batch_rows)
RED_C = 1 << 14                        # the RED exporter's batch_rows
SHARD_C = 1 << 14                      # phase 9's rows per shard
# (label, log2 width, rows, weight planes or None for mask-only lanes,
# lanes, recorded as a kernel row, weights over the whole int32 range):
# the sketch exporter's Count-Min and entropy shapes, one wide row, the
# RED lane's DDSketch row (1024 groups x 512 buckets) and service rows
# (requests, errors), and phase 9's per-shard Count-Min and entropy
# shapes and the metrics suite's entropy row (packet sums wrap as u32 and
# are read as int32, so weights run past 65535 and past 2^31)
HIST_SHAPES = (("cms", 17, 4, None, HIST_C, True, False),
               ("entropy", 12, 4, 2, HIST_C, True, False),
               ("wide", 19, 1, 2, HIST_C, False, False),
               ("ddsketch", 19, 1, None, RED_C, True, False),
               ("red_service", 10, 1, None, RED_C, True, False))
# phase 9's rows draw from phase 9's own generator, so that the phases
# before it see the data they saw before phase 9 was added
SHARD_HIST_SHAPES = (("cms_shard", 17, 4, None, SHARD_C, True, False),
                     ("entropy_shard", 12, 4, 2, SHARD_C, True, False),
                     ("metrics_entropy", 10, 2, 2, SHARD_C, True, True))
# phase 11's pod shards: batch_rows 2^15 over 4 shards, 2^13 lanes each
# (mxu_hist.MIN_LANES, so every shard batch takes hist), from phase 11's
# own generator
POD_C = 1 << 13
POD_HIST_SHAPES = (("cms_pod", 17, 4, None, POD_C, True, False),
                   ("entropy_pod", 12, 4, 2, POD_C, True, False))


def zipf_ranks(rng, size, pool):
    """Zipf(1.1) ranks in [0, pool), as `make_windows` draws records."""
    return (rng.zipf(1.1, size) - 1).clip(max=pool - 1)


def hist_inputs(torch, rng, dev, lw, d, planes, skew, C=HIST_C, pad=777,
                signed=False):
    """idx [d, C] (uniform, or Zipf(1.1) over a permuted bin order with
    out-of-range indices on both sides), a mask of the first C - pad lanes
    and, with `planes`, weights that saturate at 256**planes - 1 (with
    `signed`, u32 values over the whole range as int32 bits, half of them
    negative)."""
    width = 1 << lw
    if skew:
        idx = np.stack([rng.permutation(width)[zipf_ranks(rng, C, width)]
                        for _ in range(d)]).astype(np.int32)
    else:
        idx = rng.integers(-3, width + 3, (d, C)).astype(np.int32)
    mask = torch.arange(C, device=dev) < C - pad
    if planes is None:
        w = None
    elif signed:
        w = torch.from_numpy(rng.integers(0, 1 << 32, C, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    else:
        w = torch.from_numpy(
            rng.integers(0, 1 << 24, C).astype(np.int32)).to(dev)
    return torch.from_numpy(idx).to(dev), w, mask


def check_hist(torch, rng, cuda_hist, idx, width, w, mask, planes, label):
    """hist_add_cuda against hist_add_plain on the same non-zero state;
    returns a fresh copy of that state for timing."""
    d = idx.shape[0]
    base = torch.from_numpy(rng.integers(0, 100, (d, width)).astype(
        np.int32)).to(idx.device)
    got, ref = base.clone(), base.clone()
    cuda_hist.hist_add_cuda(got, idx, width, w, mask, planes or 2)
    cuda_hist.hist_add_plain(ref, idx, width, w, mask, planes or 2)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"hist_add[{label}] differs from its plain "
                             "version")
    return base.clone()


def lane_plane(torch, rng, dev, C, skew):
    """(4, C) lane plane: uniform words, or the Zipf(1.1) records of
    `make_windows` packed as the lanes wire packs them."""
    from deepflow_tpu_torch.models import flow_suite
    if skew:
        cols = make_windows(rng, 1, C)[0]
        lanes = flow_suite.pack_lanes(cols)
        plane = np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])
    else:
        plane = rng.integers(0, 1 << 32, (4, C), dtype=np.uint64).astype(
            np.uint32)
        plane[3] = (rng.integers(0, 256, C).astype(np.uint32) << 24) \
            | rng.integers(0, 1 << 24, C).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(plane).view(np.int32)).to(dev)


def news_plane(torch, rng, dev, C, skew):
    """(6, C) dict-wire news plane, uniform or from Zipf(1.1) records."""
    plane = rng.integers(0, 1 << 32, (6, C), dtype=np.uint64).astype(np.uint32)
    plane[0] = np.arange(C)
    if skew:
        cols = make_windows(rng, 1, C)[0]
        plane[1], plane[2] = cols["ip_src"], cols["ip_dst"]
        plane[3] = (cols["port_src"] << 16) | cols["port_dst"]
        plane[4] = cols["proto"]
        plane[5] = np.minimum(cols["packet_tx"] + cols["packet_rx"], 0xFFFF)
    else:
        plane[4] = rng.integers(0, 256, C)
        plane[5] = rng.integers(0, 0x10000, C)
    return torch.from_numpy(plane.view(np.int32)).to(dev)


def sketch_state(torch, rng, dev, ent_lw=12):
    """Non-zero CMS [4, 2^17] and entropy [4, 2^ent_lw] (the exporter
    defaults unless ent_lw is given)."""
    return (torch.from_numpy(rng.integers(0, 100, (4, 1 << 17)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 100, (4, 1 << ent_lw)).astype(
                np.int32)).to(dev))


def check_fused(torch, rng, cuda_sketch, label, plane, n_d, seeds,
                ent_lw=12):
    """One fused kernel against its plain version on the same non-zero
    state; returns fresh copies of that state for timing."""
    n = int(n_d)
    base_c, base_e = sketch_state(torch, rng, plane.device, ent_lw)
    kc, ke, pc, pe = (base_c.clone(), base_e.clone(), base_c.clone(),
                      base_e.clone())
    getattr(cuda_sketch, label + "_cuda")(plane, n_d, kc, ke, *seeds)
    getattr(cuda_sketch, label + "_plain")(plane, n_d, pc, pe, *seeds)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(ke, pe)):
        raise AssertionError(f"{label} differs from its plain version")
    if int((kc - base_c).sum()) != 4 * n:
        raise AssertionError(f"{label}: CMS rows do not count n records")
    return base_c.clone(), base_e.clone()


def check_kernels(torch, rng, dev, rng9, rng11):
    from deepflow_tpu_torch.ops import cuda_hist, cuda_sketch, hashing

    results, extra = [], []

    def us(ms):
        return "not measured" if ms is None else f"{ms * 1e3:.2f} us"

    def record(name, source, replaces, err, k_ms, p_ms, b, lib_ms, d_ms,
               lib_d_ms=None):
        b_ms, b_by = b
        log(f"  {name}: kernel {k_ms * 1e3:.2f} us per call ("
            + ("device time not measured" if d_ms is None
               else f"{d_ms * 1e3:.2f} us on the device")
            + f"), plain {p_ms * 1e3:.2f} us,"
            f" bound {b_ms * 1e3:.3f} us ({b_by})"
            + ("" if lib_ms is None else f", library {lib_ms * 1e3:.2f} us"
               f" per call ({us(lib_d_ms)} on the device)")
            + f", max_abs_err {err}")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "device_ms": d_ms,
                        "library_device_ms": lib_d_ms})

    hist_names = ("hist_smem_kernel", "hist_global_kernel")
    for (label, lw, d, planes, lanes, recorded, signed), r in \
            [(x, rng) for x in HIST_SHAPES] \
            + [(x, rng9) for x in SHARD_HIST_SHAPES] \
            + [(x, rng11) for x in POD_HIST_SHAPES]:
        width = 1 << lw
        for skew in (False, True):
            idx, w, mask = hist_inputs(torch, r, dev, lw, d, planes, skew,
                                       C=lanes, signed=signed)
            acc = check_hist(torch, r, cuda_hist, idx, width, w, mask,
                             planes, label + ("/zipf" if skew else ""))
            args = (idx, width, w, mask, planes or 2)
            k_ms = time_ms(torch, lambda: cuda_hist.hist_add_cuda(acc, *args))
            d_ms = device_ms(torch, lambda: cuda_hist.hist_add_cuda(acc, *args),
                             hist_names)
            # the library call on the same in-place contract: index_add_
            # of the clamped, saturated and masked weights into the state
            flat = (idx.to(torch.int64).clamp(0, width - 1)
                    + torch.arange(d, device=dev)[:, None] * width).reshape(-1)
            wl = torch.ones_like(idx[0]) if w is None else \
                torch.clamp(w, max=256 ** planes - 1) & (256 ** planes - 1)
            wl = (wl * mask.to(torch.int32)).expand(d, -1).reshape(-1)
            lib = acc.view(-1)
            lib_ms = time_ms(torch, lambda: lib.index_add_(0, flat, wl))
            lib_d_ms = device_ms(torch, lambda: lib.index_add_(0, flat, wl))
            delta = torch.zeros(d, width, dtype=torch.int32, device=dev)
            cuda_hist.hist_add_plain(delta, *args)
            nbytes = (idx.numel() * 4 + mask.numel()
                      + (0 if w is None else w.numel() * 4)
                      + touched_bytes(delta))
            b = bound(nbytes, HIST_OPS_PER_ITEM * idx.numel())
            if recorded and not skew:
                p_acc = acc.clone()
                record(f"hist[{label}]", "deepflow_tpu_torch/csrc/hist.cu",
                       "deepflow_tpu/ops/pallas_hist.py:90", 0.0, k_ms,
                       time_ms(torch, lambda: cuda_hist.hist_add_plain(
                           p_acc, *args)), b, lib_ms, d_ms, lib_d_ms)
            else:
                log(f"  hist_add[{label}{'/zipf' if skew else ''}]: kernel "
                    f"{k_ms * 1e3:.2f} us per call, "
                    + ("device not measured" if d_ms is None
                       else f"{d_ms * 1e3:.2f} us on the device")
                    + f", bound {b[0] * 1e3:.3f} us, library "
                    f"{lib_ms * 1e3:.2f} us per call ({us(lib_d_ms)} on the "
                    "device), bit-equal")
                extra.append({"name": f"hist[{label}]", "zipf": skew,
                              "ms": k_ms, "device_ms": d_ms,
                              "bound_ms": b[0], "library_ms": lib_ms,
                              "library_device_ms": lib_d_ms})

    seeds = (hashing.make_seeds(4, 0xDEC0DE, device=dev),
             hashing.make_seeds(4, 0xDEC0DE ^ 0xE27, device=dev))
    for label, make, C, n, line in (
            ("fused_lane_hists", lane_plane, C_LANE, C_LANE - 777, "253"),
            ("fused_news_hists", news_plane, C_NEWS, C_NEWS - 100, "277")):
        cuda_fn = getattr(cuda_sketch, label + "_cuda")
        plain_fn = getattr(cuda_sketch, label + "_plain")
        n_d = torch.tensor([n], dtype=torch.int32, device=dev)
        for skew in (False, True):
            plane = make(torch, rng, dev, C, skew)
            kc, ke = check_fused(torch, rng, cuda_sketch, label, plane, n_d,
                                 seeds)
            k_ms = time_ms(torch, lambda: cuda_fn(plane, n_d, kc, ke, *seeds))
            d_ms = device_ms(torch, lambda: cuda_fn(plane, n_d, kc, ke,
                                                    *seeds),
                             ("fused_hists_kernel",))
            dc, de = torch.zeros_like(kc), torch.zeros_like(ke)
            plain_fn(plane, n_d, dc, de, *seeds)
            b = bound(plane.numel() * 4 + 4 + touched_bytes(dc, de),
                      n * FUSED_OPS_PER_RECORD)
            if not skew:
                pc, pe = kc.clone(), ke.clone()
                record(label, "deepflow_tpu_torch/csrc/fused_sketch.cu",
                       "deepflow_tpu/ops/pallas_sketch.py:" + line, 0.0, k_ms,
                       time_ms(torch, lambda: plain_fn(plane, n_d, pc, pe,
                                                       *seeds)),
                       b, None, d_ms)
            else:
                log(f"  {label}/zipf: kernel {k_ms * 1e3:.2f} us per call, "
                    + ("device not measured" if d_ms is None
                       else f"{d_ms * 1e3:.2f} us on the device")
                    + ", bit-equal")
                extra.append({"name": label, "zipf": True, "ms": k_ms,
                              "device_ms": d_ms, "bound_ms": b[0],
                              "library_ms": None})

    # launch shapes the main path does not take, checked but not timed:
    # hist's widest block-private row, and the lane kernel's widest shared
    # copy of the entropy rows and rows too wide for one
    idx, w, mask = hist_inputs(torch, rng, dev, 15, 4, 2, True)
    check_hist(torch, rng, cuda_hist, idx, 1 << 15, w, mask, 2, "2^15")
    log("  hist_add[4 x 2^15/zipf]: bit-equal")
    n_d = torch.tensor([C_LANE - 777], dtype=torch.int32, device=dev)
    for ent_lw in (13, 16):
        for skew in (False, True):
            plane = lane_plane(torch, rng, dev, C_LANE, skew)
            check_fused(torch, rng, cuda_sketch, "fused_lane_hists", plane,
                        n_d, seeds, ent_lw)
        log(f"  fused_lane_hists, entropy rows of 2^{ent_lw} bins: "
            "bit-equal (uniform and Zipf)")
    return results, extra


# -- phase 3: the slice ------------------------------------------------------

def flow_pool(rng, pool: int = 1 << 17):
    """`pool` distinct in-range 5-tuples."""
    return {
        "ip_src": (0x0A000000 + rng.permutation(pool)).astype(np.uint32),
        "ip_dst": (0xAC100000 + rng.integers(0, 1 << 16, pool)).astype(
            np.uint32),
        "port_src": rng.integers(1024, 1 << 16, pool).astype(np.uint32),
        "port_dst": rng.choice(np.array([80, 443, 3306, 6379, 8080, 9092,
                                         5432, 53], np.uint32), pool),
        "proto": np.where(rng.random(pool) < 0.9, 6, 17).astype(np.uint32),
    }


def draw(rng, base, records: int):
    """One window of l4 records drawn by Zipf(1.1) from a flow pool (rank
    past the pool clips to its last tuple)."""
    pool = len(base["ip_src"])
    pick = (rng.zipf(1.1, records) - 1).clip(max=pool - 1)
    cols = {k: v[pick] for k, v in base.items()}
    cols["packet_tx"] = rng.integers(1, 64, records).astype(np.uint32)
    cols["packet_rx"] = rng.integers(1, 64, records).astype(np.uint32)
    return cols


def make_windows(rng, windows: int, records: int, pool: int = 1 << 17):
    """Column dicts of l4 records drawn by Zipf(1.1) from `pool` distinct
    in-range 5-tuples."""
    base = flow_pool(rng, pool)
    return [draw(rng, base, records) for _ in range(windows)]


def exact_topk(cols, k: int) -> set:
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    keys = fold_columns_np([cols["ip_src"], cols["ip_dst"], cols["port_src"],
                            cols["port_dst"], cols["proto"]])
    uniq, counts = np.unique(keys, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return set(uniq[order[:k]].tolist())


# FlowSuiteState leaves (convert.SUITE_LEAVES order) that every wire
# must agree on; the ring (2, 3) and batches_seen (8) follow each wire's
# batch partition
WIRE_FREE_LEAVES = {"cms": 0, "cms_seeds": 1, "hll": 4, "entropy": 5,
                    "entropy_seeds": 6, "rows": 7}


def snapshot(state):
    """The 9 state leaves as host numpy, in the reference's order."""
    from deepflow_tpu_torch import convert
    return convert.state_to_numpy(state)


def bus_snapshots(exp):
    """Every window the exporter publishes (its pre-flush state, copied
    to the host on its own stream) as a list of leaf lists."""
    snaps = []
    exp.snapshot_bus.subscribe(lambda s: snaps.append(list(s.leaves)))
    return snaps


def feed_chunks(exp, cols, chunk):
    total = len(cols["ip_src"])
    for s in range(0, total, chunk):
        exp.process([("l4_flow_log", 0,
                      {k: v[s:s + chunk] for k, v in cols.items()}, -1)])


def compare_snaps(a_snaps, b_snaps, leaves, a_name, b_name):
    """Leaf-equal window snapshots; `leaves` maps name -> leaf index
    (None: all nine)."""
    if len(a_snaps) != len(b_snaps) or not a_snaps:
        raise AssertionError(f"{a_name}: {len(a_snaps)} windows, {b_name}: "
                             f"{len(b_snaps)}")
    pick = leaves or {f"leaf_{i}": i for i in range(len(a_snaps[0]))}
    for w, (a, b) in enumerate(zip(a_snaps, b_snaps)):
        for leaf, i in pick.items():
            if a[i].dtype != b[i].dtype or not np.array_equal(a[i], b[i]):
                raise AssertionError(f"window {w}: {leaf} differs between "
                                     f"{a_name} and {b_name}")


def check_output(torch, out, cfg):
    shapes = {"topk_keys": (cfg.top_k,), "topk_counts": (cfg.top_k,),
              "service_cardinality": (cfg.hll_groups,), "entropies": (4,),
              "rows": ()}
    for name, shape in shapes.items():
        t = getattr(out, name)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name} has shape {tuple(t.shape)}")
    for name in ("service_cardinality", "entropies"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"{name} is not finite")
    e = out.entropies
    if not bool(((e >= 0) & (e <= 1)).all()):
        raise AssertionError("entropies outside [0, 1]")


def path_runners(torch, dev, cfg, batch_rows, chunk):
    """name -> (run(windows, snaps, outs), kernels the path must launch)."""
    from deepflow_tpu_torch.models import flow_suite
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    def full_row(windows, snaps, outs):
        state = flow_suite.init(cfg, dev)
        mask = torch.ones(batch_rows, dtype=torch.bool, device=dev)
        names = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
                 "packet_tx", "packet_rx")
        for cols in windows:
            total = len(cols["ip_src"])
            for s in range(0, total, batch_rows):
                e = min(total, s + batch_rows)
                m = mask if e - s == batch_rows else \
                    torch.arange(batch_rows, device=dev) < (e - s)
                part = {}
                for k in names:
                    buf = np.zeros(batch_rows, np.uint32)
                    buf[:e - s] = cols[k][s:e]
                    part[k] = torch.from_numpy(buf.view(np.int32)).to(dev)
                state = flow_suite.update(state, part, m, cfg)
            snaps.append(snapshot(state))
            state, out = flow_suite.flush(state, cfg)
            outs.append(out)

    def exporter(wire, coalesce):
        def run(windows, snaps, outs):
            exp = TpuSketchExporter(cfg=cfg, batch_rows=batch_rows,
                                    wire=wire, coalesce_batches=coalesce,
                                    device=dev)
            try:
                published = bus_snapshots(exp)
                for cols in windows:
                    feed_chunks(exp, cols, chunk)
                    outs.append(exp.flush_window())
                snaps.extend(published)
            finally:
                exp.close()
            records = sum(len(w["ip_src"]) for w in windows)
            if exp.rows_in != records:
                raise AssertionError(f"{wire}: rows_in {exp.rows_in}")
        return run

    return {"full_row_update": (full_row, ("hist",)),
            "lanes_exporter_k4": (exporter("lanes", 4), ("fused_lane_hists",)),
            "dict_exporter": (exporter("dict", 1),
                              ("fused_news_hists", "fused_lane_hists"))}


def launch_counters():
    """kernel name -> the wrapper that counts its launches."""
    from deepflow_tpu_torch.ops import cuda_hist, cuda_sketch
    return {"hist": cuda_hist.hist_add_cuda,
            "fused_lane_hists": cuda_sketch.fused_lane_hists_cuda,
            "fused_news_hists": cuda_sketch.fused_news_hists_cuda}


def run_paths(torch, runners, windows):
    """Each path over every window, its launch counts set to 0 just
    before and read just after; returns per path its snapshots, outputs,
    records/s and launches."""
    counters = launch_counters()
    records = sum(len(w["ip_src"]) for w in windows)
    paths = {}
    for name, (fn, wants) in runners.items():
        snaps, outs = [], []
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        fn(windows, snaps, outs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        for k in wants:
            if launches[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        paths[name] = {"snaps": snaps, "outs": outs, "seconds": dt,
                       "records_per_s": records / dt, "launches": launches}
    return paths


def check_slice(torch, dev, rng, args, card):
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig

    cfg = FlowSuiteConfig()
    batch_rows = 1 << 15
    windows = make_windows(rng, 2, args.window_records)
    runners = path_runners(torch, dev, cfg, batch_rows, chunk=1 << 16)
    paths = run_paths(torch, runners, windows)
    # full-row update: one hist launch per histogram, Count-Min and entropy
    batches = sum(-(-len(w["ip_src"]) // batch_rows) for w in windows)
    hist_launches = paths["full_row_update"]["launches"]["hist"]
    if hist_launches != 2 * batches:
        raise AssertionError(f"full_row_update: {hist_launches} hist launches "
                             f"for {batches} batches, not 2 per batch")
    names = list(paths)
    ref = paths[names[0]]
    for name in names[1:]:
        compare_snaps(ref["snaps"], paths[name]["snaps"],
                      WIRE_FREE_LEAVES, names[0], name)
    for name, p in paths.items():
        recalls = []
        for w, out in enumerate(p["outs"]):
            check_output(torch, out, cfg)
            if int(out.rows) != len(windows[w]["ip_src"]):
                raise AssertionError(f"{name}: window {w} rows {int(out.rows)}")
            got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
            truth = exact_topk(windows[w], cfg.top_k)
            recalls.append(len(got & truth) / cfg.top_k)
        if min(recalls) < 0.99:
            raise AssertionError(f"{name}: top-K recall {recalls} < 0.99")
        p["recall"] = recalls
        log(f"  {name}: {p['records_per_s']:.0f} records/s "
            f"({p['seconds']:.3f} s for {2 * args.window_records} records) "
            f"on {card}; recall {recalls}; launches {p['launches']}")
    return paths, runners, windows


def profile_paths(torch, runners, windows):
    """One window of each path under torch.profiler: wall time, the
    device time of every kernel and copy, its share of the wall time
    (the profiler's own overhead included), and the largest device ops."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (fn, _) in runners.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(windows, [], [])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = sorted(_device_events(torch, prof), key=lambda e: -e[1])
        dev_s = sum(t for _, t in events) / 1e6
        out[name] = {
            "wall_s": wall, "device_s": dev_s if events else None,
            "device_busy_share": dev_s / wall if events else None,
            "top_device_ops": [[k[:120], t / 1e3] for k, t in events[:6]],
            "top_torch_ops": _torch_ops(torch, prof)[:8]}
        log(f"  {name}: wall {wall:.3f} s, device "
            + ("not measured" if not events else
               f"{dev_s:.4f} s ({100 * dev_s / wall:.1f}% busy)"))
        for k, t in events[:6]:
            log(f"    {t / 1e3:9.3f} ms  {k[:120]}")
        for k, t, calls in out[name]["top_torch_ops"]:
            log(f"    {t:9.3f} ms device, {calls:6d} calls  {k}")
    return out


def profile_full_row_update(torch, dev, rng):
    """The device kernels of one full-row `update` batch at the exporter
    defaults (torch.profiler), by name and call count: the Count-Min and
    entropy histograms must be one hist launch each, with no float
    conversion and no fill of a d x width buffer."""
    from torch.profiler import ProfilerActivity, profile
    from deepflow_tpu_torch.models import flow_suite

    cfg = flow_suite.FlowSuiteConfig()
    C = 1 << 15
    state = flow_suite.init(cfg, dev)
    cols = make_windows(rng, 1, C)[0]
    part = {k: torch.from_numpy(v.view(np.int32)).to(dev)
            for k, v in cols.items()}
    mask = torch.arange(C, device=dev) < C - 777
    state = flow_suite.update(state, part, mask, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flow_suite.update(state, part, mask, cfg)
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            counts[evt.key[:100]] = counts.get(evt.key[:100], 0) + evt.count
    hist = sum(c for k, c in counts.items() if "hist_" in k)
    bad = [k for k in counts if "to_float" in k]
    fills = [f"{k} x{c}" for k, c in counts.items() if "fill" in k.lower()]
    log(f"  full-row update, one batch: {sum(counts.values())} device "
        f"kernels, {hist} hist launches; fills: {', '.join(fills) or 'none'}")
    if hist != 2 or bad:
        raise AssertionError(f"full-row update kernels: {counts}")
    return sorted(counts.items(), key=lambda kv: -kv[1])


def check_small_against_cpu(torch, dev, rng):
    """The dict exporter on the card and on the CPU (plain versions) over
    the same small stream: identical state, matching window outputs."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    cfg = FlowSuiteConfig(cms_log2_width=12, ring_size=256, hll_groups=64,
                          hll_precision=8, entropy_log2_buckets=10)
    windows = make_windows(rng, 2, 10000, pool=3000)
    exps = [TpuSketchExporter(cfg=cfg, batch_rows=4096, wire=wire,
                              device=d)
            for wire in ("dict", "lanes") for d in (dev, "cpu")]
    snaps = [bus_snapshots(exp) for exp in exps]
    try:
        compare_small(windows, exps, snaps)
    finally:
        for exp in exps:
            exp.close()


def compare_small(windows, exps, snaps):
    for cols in windows:
        for exp in exps:
            feed_chunks(exp, cols, len(cols["ip_src"]))
        for (gpu, cpu), (sg, sc) in zip((exps[0:2], exps[2:4]),
                                        (snaps[0:2], snaps[2:4])):
            og, oc = gpu.flush_window(), cpu.flush_window()
            for a, b in zip(sg[-1], sc[-1]):
                np.testing.assert_array_equal(a, b)
            for name in ("topk_keys", "topk_counts", "rows"):
                np.testing.assert_array_equal(getattr(og, name).cpu().numpy(),
                                              getattr(oc, name).numpy())
            for name in ("service_cardinality", "entropies"):
                # float32 log/sqrt and sum order: CUDA vs CPU last-ulp
                np.testing.assert_allclose(getattr(og, name).cpu().numpy(),
                                           getattr(oc, name).numpy(),
                                           rtol=1e-5, atol=1e-6)


# -- phase 6: the exporter as the ingester runs it ---------------------------

# (name, exporter knobs, fed through put() and the exporter's worker
# thread as the ingester hands chunks over, kernels the run must launch)
INGESTER_RUNS = (
    ("dict_feed", dict(wire="dict", prefetch_depth=2, zero_copy=True), True,
     ("fused_news_hists", "fused_lane_hists")),
    ("lanes_feed", dict(wire="lanes", prefetch_depth=2, coalesce_batches=4),
     False, ("fused_lane_hists",)),
    ("dict_inline", dict(wire="dict"), False,
     ("fused_news_hists", "fused_lane_hists")),
    # the TensorBatch feed (zero_copy=False): the feed groups K batches
    # and packs each group into one pinned staging buffer
    ("dict_tb_feed", dict(wire="dict", prefetch_depth=2, coalesce_batches=4,
                          zero_copy=False), False,
     ("fused_news_hists", "fused_lane_hists")),
    ("lanes_tb_feed", dict(wire="lanes", prefetch_depth=2,
                           coalesce_batches=4, zero_copy=False), False,
     ("fused_lane_hists",)),
)
CHUNK = 1 << 16            # records per decoded chunk
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
MARK = "cudaMemGetInfo"    # a runtime call the exporter never makes


def mark(torch, dev):
    """One marker call into the CUDA runtime trace (see trace_session)."""
    torch.cuda.mem_get_info(dev)


def staging_buffers(exp):
    """The free staging buffers of a feed exporter: its stager's, or the
    TensorBatch feed's pool."""
    if exp._stager is None:
        return exp._staging_pool.buffers()
    free = exp._stager._free
    return free if isinstance(free, list) else free.buffers()


def make_exporter(dev, knobs, checkpoint_dir, store_dir=None):
    """An exporter at the ingester's sizes: FlowSuiteConfig(), 2^15-row
    batches, a checkpoint directory and, with `store_dir`, a Store for its
    writers; windows are closed by the caller."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
    from deepflow_tpu_torch.store.db import Store
    return TpuSketchExporter(cfg=FlowSuiteConfig(), batch_rows=1 << 15,
                             window_seconds=3600,
                             checkpoint_dir=checkpoint_dir, device=dev,
                             store=None if store_dir is None
                             else Store(store_dir), **knobs)


def read_table(root, db, table):
    """Every segment of a store table, read with numpy in write order
    (the segment sequence), columns concatenated."""
    tdir = os.path.join(root, db, table)
    segs = []
    for part in os.listdir(tdir):
        if part.startswith("p"):
            segs += [(int(f[4:-4]), os.path.join(tdir, part, f))
                     for f in os.listdir(os.path.join(tdir, part))
                     if f.startswith("seg-") and f.endswith(".npz")]
    cols = {}
    for _, path in sorted(segs):
        with np.load(path) as z:
            for k in z.files:
                cols.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in cols.items()}


def check_sketch_rows(store_dir, outs, nows):
    """Phase 6: the writers' topk_flows and window_signals rows, read back
    from the segment files, equal to each window's output; every
    resolved 5-tuple folds back to its flow key. Returns the row count
    and the resolved share."""
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    topk = read_table(store_dir, "tpu_sketch", "topk_flows")
    win = read_table(store_dir, "tpu_sketch", "window_signals")
    rows = 0
    for out, now in zip(outs, nows):
        keys = out.topk_keys.cpu().numpy().view(np.uint32)
        counts = out.topk_counts.cpu().numpy()
        live = counts > 0
        sel = topk["timestamp"] == int(now)
        if not (np.array_equal(topk["flow_key"][sel], keys[live])
                and np.array_equal(topk["count"][sel],
                                   counts[live].astype(np.uint32))
                and np.array_equal(topk["rank"][sel],
                                   np.arange(live.sum(), dtype=np.uint32))):
            raise AssertionError(f"topk_flows rows of window {now} differ "
                                 "from its output")
        w = np.nonzero(win["timestamp"] == int(now))[0]
        ent = out.entropies.cpu().numpy()
        card = out.service_cardinality.cpu().numpy()
        if len(w) != 1 or win["rows"][w[0]] != int(out.rows) \
                or win["distinct_clients"][w[0]] != np.uint32(card.sum()) \
                or not np.array_equal(
                    [win[f"entropy_{f}"][w[0]] for f in
                     ("ip_src", "ip_dst", "port_src", "port_dst")], ent):
            raise AssertionError(f"window_signals row of window {now} "
                                 "differs from its output")
        rows += int(sel.sum())
    resolved = topk["proto"] > 0
    names = ("ip_src", "ip_dst", "port_src", "port_dst", "proto")
    if not np.array_equal(fold_columns_np([topk[k][resolved] for k in names]),
                          topk["flow_key"][resolved]):
        raise AssertionError("a resolved 5-tuple does not fold to its key")
    return {"topk_rows": rows, "resolved_share": float(resolved.mean())}


def ingest_window(exp, cols, via_put):
    """One window of records into the exporter: through put() and its
    worker thread (waiting until the worker has processed every chunk),
    or process() on this thread."""
    if not via_put:
        feed_chunks(exp, cols, CHUNK)
        return
    total = len(cols["ip_src"])
    want = exp.processed + -(-total // CHUNK)
    for s in range(0, total, CHUNK):
        exp.put("l4_flow_log", 0, {k: v[s:s + CHUNK] for k, v in cols.items()})
    deadline = time.monotonic() + 300
    while exp.processed + exp.process_errors < want:
        if time.monotonic() > deadline:
            raise AssertionError("the exporter's worker did not drain")
        time.sleep(0.0005)
    if exp.process_errors:
        raise AssertionError(f"process() raised {exp.process_errors} times")


def run_ingester_paths(torch, dev, windows, card, tmp, lanes_inline_snaps):
    """Phase 6.1-6.3: the three runs, unprofiled, their launch counts
    set to 0 just before and read just after each; leaf equality at
    every window close, recall, outputs; restore from disk."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig

    cfg = FlowSuiteConfig()
    counters = launch_counters()
    records = sum(len(w["ip_src"]) for w in windows)
    runs = {}
    for name, knobs, via_put, wants in INGESTER_RUNS:
        store_dir = os.path.join(tmp, "store_" + name)
        exp = make_exporter(dev, knobs, os.path.join(tmp, name), store_dir)
        snaps, outs = bus_snapshots(exp), []
        nows = [1000.0 + w for w in range(len(windows))]
        try:
            if via_put:
                exp.start()
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            for cols, now in zip(windows, nows):
                ingest_window(exp, cols, via_put)
                outs.append(exp.flush_window(now=now))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            exp.close()
        c = exp.counters()
        c.update(check_sketch_rows(store_dir, outs, nows))
        for k in wants:
            if launches[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        if c["rows_in"] != records or c["lost_rows"] or c["device_errors"]:
            raise AssertionError(f"{name}: counters {c}")
        if c.get("staging_recycle_refused", 0):
            raise AssertionError(f"{name}: a staging buffer came back "
                                 "before its fence retired")
        if knobs.get("prefetch_depth"):
            bufs = staging_buffers(exp)
            pinned = sum(torch.from_numpy(b.view(np.int32)).is_pinned()
                         for b in bufs)
            if not bufs or pinned != len(bufs):
                raise AssertionError(f"{name}: {pinned} of {len(bufs)} free "
                                     "staging buffers page-locked")
            c["staging_free_pinned"] = pinned
        recalls = []
        for w, out in enumerate(outs):
            check_output(torch, out, cfg)
            if int(out.rows) != len(windows[w]["ip_src"]):
                raise AssertionError(f"{name}: window {w} rows {int(out.rows)}")
            got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
            recalls.append(len(got & exact_topk(windows[w], cfg.top_k))
                           / cfg.top_k)
        if min(recalls) < 0.99:
            raise AssertionError(f"{name}: top-K recall {recalls} < 0.99")
        keep = ("dispatches", "h2d_transfers", "batches", "feed_groups",
                "feed_fences", "staged_groups", "staging_pool_hits",
                "staging_recycled", "staging_recycle_refused",
                "staging_free_pinned", "saves", "topk_rows",
                "resolved_share")
        runs[name] = {"snaps": snaps, "seconds": dt, "recall": recalls,
                      "records_per_s": records / dt, "launches": launches,
                      "counters": {k: c[k] for k in keep if k in c}}
        log(f"  {name}: {records / dt:.0f} records/s ({dt:.3f} s for "
            f"{records} records, unprofiled) on {card}; recall {recalls}; "
            f"launches {launches}; {runs[name]['counters']}")
    compare_snaps(runs["dict_inline"]["snaps"], runs["dict_feed"]["snaps"],
                  None, "dict_inline", "dict_feed")
    compare_snaps(lanes_inline_snaps, runs["lanes_feed"]["snaps"], None,
                  "lanes_exporter_k4 (phase 3, inline)", "lanes_feed")
    compare_snaps(runs["dict_feed"]["snaps"], runs["lanes_feed"]["snaps"],
                  WIRE_FREE_LEAVES, "dict_feed", "lanes_feed")
    compare_snaps(runs["dict_inline"]["snaps"], runs["dict_tb_feed"]["snaps"],
                  None, "dict_inline", "dict_tb_feed")
    compare_snaps(lanes_inline_snaps, runs["lanes_tb_feed"]["snaps"], None,
                  "lanes_exporter_k4 (phase 3, inline)", "lanes_tb_feed")
    log("  every leaf equal at every window close: dict_feed = dict_tb_feed "
        "= dict_inline, lanes_feed = lanes_tb_feed = phase 3's inline lanes "
        f"(K=4); across the wires {sorted(WIRE_FREE_LEAVES)} equal")
    log(f"  the TensorBatch feed on {card}: dict "
        f"{runs['dict_tb_feed']['records_per_s']:.0f} records/s against the "
        f"zero-copy feed's {runs['dict_feed']['records_per_s']:.0f} (ratio "
        f"{runs['dict_tb_feed']['records_per_s'] / runs['dict_feed']['records_per_s']:.3f}"
        f"), lanes {runs['lanes_tb_feed']['records_per_s']:.0f} against "
        f"{runs['lanes_feed']['records_per_s']:.0f} (ratio "
        f"{runs['lanes_tb_feed']['records_per_s'] / runs['lanes_feed']['records_per_s']:.3f})")
    # 6.3: a fresh exporter on dict_feed's checkpoint directory
    fresh = make_exporter(dev, INGESTER_RUNS[0][1],
                          os.path.join(tmp, "dict_feed"))
    try:
        torch.cuda.synchronize()
        compare_snaps([runs["dict_feed"]["snaps"][-1]], [snapshot(fresh.state)],
                      None, "dict_feed's last snapshot", "the restored state")
        if fresh.windows != len(windows):
            raise AssertionError(f"restored window counter {fresh.windows}")
    finally:
        fresh.close()
    log("  a fresh exporter restores dict_feed's last snapshot leaf-equal")
    return runs


def walk_ladder(torch, dev, rng, tmp, lanes=False):
    """Phase 6.4: the dict feed path with tpu.device_error armed. Window
    A is clean and checkpointed; in window B the first two dispatches
    fail (a rollback from A's snapshot into fresh tensors, then degraded
    mode, which on the card sheds the rows, counted lost, and computes
    nothing on the CPU); B's flush probes and recovers. Conservation
    over A and B is exact; window C holds A's rows once more, the
    restored snapshot replayed (the reference's at-least-once
    restore). With `lanes` (phase 7) the anomaly plane and the auditor
    ride along: every device error reaches the plane's `device_lost`
    (counted), and the shed window B closes unscored, counted."""
    from deepflow_tpu_torch.runtime.faults import default_faults

    a, b1, b2, c = make_windows(rng, 4, 1 << 18)
    knobs = dict(INGESTER_RUNS[0][1], **(DETECTION_KNOBS if lanes else {}))
    exp = make_exporter(dev, knobs, os.path.join(
        tmp, "ladder_lanes" if lanes else "ladder"))
    faults = default_faults()
    try:
        feed_chunks(exp, a, CHUNK)
        out_a = exp.flush_window()
        snap_a = exp.snapshot_bus.latest()
        faults.arm("tpu.device_error", count=2, match="dict")
        feed_chunks(exp, b1, CHUNK)
        if not exp._feed.drain(60):
            raise AssertionError("ladder: feed did not drain")
        rolled = exp.counters()
        if not (exp.degraded and exp.device_errors == 2
                and rolled["restores"] >= 2
                and exp.snapshot_bus.last_restored_step == 1):
            raise AssertionError(f"ladder: no rollback/degrade: {rolled}")
        feed_chunks(exp, b2, CHUNK)
        out_b = exp.flush_window()
        if (out_b is not None or exp.degraded or exp.recoveries != 1
                or exp.host_rows or exp.shed_rows < len(b2["ip_src"])):
            raise AssertionError(f"ladder: no shed or no recovery: "
                                 f"{exp.counters()}")
        sent = sum(len(w["ip_src"]) for w in (a, b1, b2))
        delivered = int(out_a.rows)
        if delivered + exp.lost_rows != sent:
            raise AssertionError(f"ladder: delivered {delivered} + lost "
                                 f"{exp.lost_rows} != sent {sent}")
        feed_chunks(exp, c, CHUNK)
        out_c = exp.flush_window()
        replayed = int(snap_a.leaves[7])
        if int(out_c.rows) != len(c["ip_src"]) + replayed:
            raise AssertionError(f"ladder: window C rows {int(out_c.rows)}")
        summary = {k: exp.counters()[k] for k in (
            "device_errors", "recoveries", "lost_windows", "lost_rows",
            "shed_rows", "host_rows", "restores", "dict_epoch_drops")}
        if lanes:
            plane = exp.anomaly.counters()
            summary["anomaly"] = {k: plane[k] for k in (
                "windows", "windows_unscored", "score_errors", "feed_errors",
                "rows_seen", "table_offers")}
            summary["audit_windows"] = exp._audit.windows
            if (plane["feed_errors"] != exp.device_errors
                    or plane["windows"] != exp.windows or exp.windows != 3
                    or plane["windows_unscored"] != 1
                    or plane["score_errors"]
                    or plane["rows_seen"] != exp.rows_in
                    or exp._audit.windows != exp.windows):
                raise AssertionError(f"ladder with the lanes on: {summary}")
    finally:
        faults.disarm()
        exp.close()
    summary.update(sent=sent, delivered=delivered, replayed_in_c=replayed)
    log(f"  ladder: rollback, rows shed, probe recovery; delivered "
        f"{delivered} + lost {summary['lost_rows']} == sent {sent}; "
        f"{summary}")
    return summary


def _union_us(spans):
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _overlap_us(spans, cover):
    """Time of `spans` covered by the union of `cover`."""
    merged = []
    for s, e in sorted(cover):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(max(0.0, min(e, me) - max(s, ms))
               for s, e in spans for ms, me in merged)


GATE_KERNEL = "gate_kernel"


def occupancy_share(occ, t0, t1):
    """The occupancy profiler's device spans (what tpu_device_busy_
    fraction unions) clipped to the wall-clock window [t0, t1], their
    union over the window: the gauge's measure over exactly the window
    torch.profiler's share covers (the gauge itself shrinks its window
    to the first span it holds)."""
    ivals = [(max(t_end - dur, t0), min(t_end, t1))
             for tr, _n, t_end, dur, _r in occ._snapshot()
             if tr == "device" and t_end >= t0 and t_end - dur <= t1]
    return _union_us(ivals) / max(t1 - t0, 1e-9)


def gated_spans_ms(kernels, gates):
    """Per gate, the span of the kernels that ran between its end and the
    next gate's start (a gated program's kernels back to back): first
    kernel start to last kernel end, ms."""
    out = []
    for i, (_, g_end) in enumerate(gates):
        nxt = gates[i + 1][0] if i + 1 < len(gates) else float("inf")
        ks = [(s, e) for s, e in kernels if g_end <= s < nxt]
        if ks:
            out.append((max(e for _, e in ks) - min(s for s, _ in ks)) / 1e3)
    return out


def trace_session(torch, prof, wall_s):
    """One profiler session (its work ended inside it): the device's busy
    share (union of its kernels and copies over `wall_s`), host-to-device
    copy time and the part of it that overlaps kernels, copy activities
    by direction and host memory kind, and the CUDA runtime's copy and
    synchronizing calls made between the session's two `mark` calls
    (runtime calls of every thread share one clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    d = [(e.name, e.time_range.start, e.time_range.end)
         for e in events if e.device_type == cuda]
    # the recorder's gate kernels (ops/cuda_gate.py) spin while the host
    # launches: an instrument, not work; counted apart
    gates = sorted((s, e) for n, s, e in d if GATE_KERNEL in n)
    d = [x for x in d if GATE_KERNEL not in x[0]]
    api = sorted((e.time_range.start, e.name) for e in events
                 if e.device_type != cuda and e.name.startswith("cuda"))
    marks = [t for t, n in api if n == MARK]
    if len(marks) != 2:
        raise AssertionError(f"{len(marks)} {MARK} markers in the runtime "
                             "trace, expected 2")
    host = [n for t, n in api if marks[0] < t < marks[1]]
    kernels = [(s, e) for n, s, e in d
               if not n.startswith(("Memcpy", "Memset"))]
    h2d = [(s, e) for n, s, e in d if "HtoD" in n]
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_share": _union_us([(s, e) for _, s, e in d])
        / 1e6 / wall_s,
        # the compute stream's share: its kernels (copies run on the
        # copy stream)
        "kernel_ms": _union_us(kernels) / 1e3,
        "kernel_busy_share": _union_us(kernels) / 1e6 / wall_s,
        "gate_kernels": len(gates),
        "gate_ms": sum(e - s for s, e in gates) / 1e3,
        "gated_spans_ms": gated_spans_ms(kernels, gates),
        "kernels": len(kernels),
        "h2d_copies": len(h2d),
        "h2d_ms": sum(e - s for s, e in h2d) / 1e3,
        "h2d_overlapping_kernels_ms": _overlap_us(h2d, kernels) / 1e3,
        "h2d_pinned": sum(1 for n, _, _ in d if "HtoD" in n and "Pinned" in n),
        "h2d_pageable": sum(1 for n, _, _ in d
                            if "HtoD" in n and "Pageable" in n),
        "d2h_copy_activities": sum(1 for n, _, _ in d if "DtoH" in n),
        "d2d_copy_activities": sum(1 for n, _, _ in d if "DtoD" in n),
        "copy_activities": sum(1 for n, _, _ in d if n.startswith("Memcpy")),
        "memcpy_calls": sum(1 for n in host if n.startswith("cudaMemcpy")),
        "runtime_calls": {n: host.count(n) for n in SYNC_CALLS + (
            "cudaLaunchKernel", "cudaMemcpyAsync")}}


def profile_window(torch, dev, ingest, flush):
    """One window in two profiler sessions, its ingest and its flush,
    each ended by a device synchronize and bracketed by `mark` calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sessions = []
    for fn in (ingest, flush):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            mark(torch, dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mark(torch, dev)
        sessions.append(trace_session(torch, prof, wall))
    return sessions


def profile_ingester_paths(torch, dev, windows, tmp, card,
                           runs=INGESTER_RUNS, attrib_every=None):
    """Phase 6.5 (and 7): per run, one warm-up window, then one window
    under torch.profiler in two sessions: its ingest (every chunk in; the
    feed drained, or on the inline path a device synchronize) and its
    flush (publish, readout), each bracketed by two `mark` calls.
    `attrib_every` sets the exporters' attribution cadence (for a traced
    run)."""
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.runtime.profiler import default_profiler
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, knobs, via_put, _ in runs:
        exp = make_exporter(dev, knobs, os.path.join(tmp, "prof_" + name),
                            os.path.join(tmp, "prof_store_" + name))
        if attrib_every is not None:
            exp._attrib_every = attrib_every
        try:
            if via_put:
                exp.start()
            ingest_window(exp, windows[0], via_put)
            exp.flush_window()
            torch.cuda.synchronize()
            before = exp.counters()
            occ = default_profiler()
            occ.reset()
            with profile(activities=acts) as prof_ingest:
                mark(torch, dev)
                t0, w0 = time.perf_counter(), time.time()
                ingest_window(exp, windows[1], via_put)
                if exp._feed is None:
                    torch.cuda.synchronize()
                elif not exp._feed.drain(60):
                    raise AssertionError(f"{name}: feed did not drain")
                t_ingest = time.perf_counter() - t0
                # the occupancy profiler's busy share over the same ingest
                occ_busy = occupancy_share(occ, w0, time.time())
                mark(torch, dev)
            after = exp.counters()
            fences = after.get("feed_fences", 0) - before.get("feed_fences", 0)
            h2d = after["h2d_transfers"] - before["h2d_transfers"]
            with profile(activities=acts) as prof_flush:
                mark(torch, dev)
                t0 = time.perf_counter()
                exp.flush_window()
                torch.cuda.synchronize()
                t_flush = time.perf_counter() - t0
                mark(torch, dev)
        finally:
            exp.close()
        ingest = trace_session(torch, prof_ingest, t_ingest)
        flush = trace_session(torch, prof_flush, t_flush)
        ingest["h2d_transfers"] = h2d
        out[name] = {"ingest": ingest, "flush": flush, "fences": fences,
                     "occupancy_busy": occ_busy,
                     "dispatches": after["dispatches"]
                     - before["dispatches"],
                     "busy_counters": {k: v for k, v in after.items()
                                       if k.startswith("busy_")}}
        calls = ingest["runtime_calls"]
        if calls["cudaLaunchKernel"] == 0:
            raise AssertionError(f"{name}: the profiler saw no runtime calls")
        log(f"  {name} on {card}: ingest {ingest['wall_ms']:.1f} ms, device "
            f"busy {100 * ingest['device_busy_share']:.1f}%, h2d "
            f"{ingest['h2d_copies']} copies ({ingest['h2d_pinned']} pinned, "
            f"{ingest['h2d_pageable']} pageable) {ingest['h2d_ms']:.3f} ms of "
            f"which {ingest['h2d_overlapping_kernels_ms']:.3f} ms overlap "
            f"kernels; {h2d} transfers; runtime copy calls "
            f"{ingest['memcpy_calls']}, copy activities recorded "
            f"{ingest['copy_activities']} (d2h {ingest['d2h_copy_activities']}"
            f", d2d {ingest['d2d_copy_activities']}); syncs "
            + ", ".join(f"{k} {calls[k]}" for k in SYNC_CALLS)
            + f"; {fences} fences; flush {flush['wall_ms']:.1f} ms, runtime "
            f"copy calls {flush['memcpy_calls']}, copy activities "
            f"{flush['copy_activities']} (d2h "
            f"{flush['d2h_copy_activities']}), syncs "
            + ", ".join(f"{k} {flush['runtime_calls'][k]}"
                        for k in SYNC_CALLS))
        if knobs.get("prefetch_depth"):
            # between fences the feed path reads nothing back and waits
            # on nothing but its fences, and it copies from pinned memory
            if (ingest["d2h_copy_activities"] or not h2d
                    or calls["cudaStreamSynchronize"]
                    or calls["cudaDeviceSynchronize"]
                    or calls["cudaEventSynchronize"] != fences
                    or ingest["h2d_pageable"]):
                raise AssertionError(f"{name}: the feed path synced or "
                                     f"copied outside its fences: {ingest}")
    return out


# the traced windows attribute every group in detail (the exporter's
# default is 1 in 16), so a short traced run holds warm programs'
# dispatch and device times beside the first calls' compiles
ATTRIB_EVERY = 1
ATTRIB_STAGES = ("kernel.h2d", "kernel.dispatch", "kernel.device",
                 "kernel.compile")


def tracer_on():
    """The process tracer, emptied and enabled, and the occupancy
    profiler, emptied."""
    from deepflow_tpu_torch.runtime.profiler import default_profiler
    from deepflow_tpu_torch.runtime.tracing import default_tracer
    tr, occ = default_tracer(), default_profiler()
    tr.reset()
    occ.reset()
    tr.enable()
    return tr, occ


def traced_profile(torch, dev, windows, tmp, card, run, untraced):
    """Phases 6 and 7, attribution: `run` profiled as
    profile_ingester_paths profiles it, with the process tracer on. The
    tracer's stages must hold the four kernel stages, the profiler's
    busy share must lie in (0, 1], the gauge tpu_h2d_mb_s must be set,
    and the profiled ingest must make as many stream, event and device
    syncs as the same run's untraced window (`untraced`): the recorder
    reads its events at the fences, never with a sync of its own."""
    tr, occ = tracer_on()
    try:
        prof = profile_ingester_paths(torch, dev, windows, tmp, card,
                                      runs=(run,),
                                      attrib_every=ATTRIB_EVERY)[run[0]]
        busy = occ.busy_fraction()
    finally:
        tr.disable()
    lat, gauges = tr.latency(), tr.gauges()
    missing = [k for k in ATTRIB_STAGES if k not in lat]
    if missing or "tpu_h2d_mb_s" not in gauges or not 0 < busy <= 1:
        raise AssertionError(f"{run[0]} traced: stages {sorted(lat)}, "
                             f"gauges {sorted(gauges)}, busy {busy}")
    syncs = {k: prof["ingest"]["runtime_calls"][k] for k in SYNC_CALLS}
    want = {k: untraced["ingest"]["runtime_calls"][k] for k in SYNC_CALLS}
    if syncs != want:
        raise AssertionError(f"{run[0]}: ingest syncs with the tracer on "
                             f"{syncs}, off {want}")
    medians = {k: lat[k]["p50_ms"] for k in ATTRIB_STAGES}
    busy_check = busy_against_profiler(prof, lat, run[0], card,
                                       hold=run[0] == "dict_feed_traced")
    log(f"  {run[0]} traced on {card}: sampled medians h2d "
        f"{medians['kernel.h2d']:.4f} ms, dispatch "
        f"{medians['kernel.dispatch']:.4f} ms, device "
        f"{medians['kernel.device']:.4f} ms ({lat['kernel.device']['count']}"
        f" warm calls, {lat['kernel.compile']['count']} first calls); "
        f"profiler busy share {busy:.4f}; tpu_h2d_mb_s "
        f"{gauges['tpu_h2d_mb_s']:.1f}; ingest syncs {syncs} = untraced; "
        f"ingest {prof['ingest']['wall_ms']:.1f} ms (untraced "
        f"{untraced['ingest']['wall_ms']:.1f} ms)")
    return {"latency": lat, "gauges": gauges, "busy_fraction": busy,
            "syncs": syncs, "profile": prof, "busy_check": busy_check}


def busy_against_profiler(prof, lat, name, card, hold=False):
    """The repaired busy measure against torch.profiler on one profiled
    ingest: the occupancy profiler's busy share (`tpu_device_busy_
    fraction`'s spans over the ingest) over the compute stream's kernel
    share, and `kernel.device`'s p50 over the profiler's kernel time per
    program call and over the profiler's span of each gated program's
    kernels. Logged and returned with the limits (a factor 1.5, +-30%).
    `hold` (a run of one program kind, every group gated): the p50 must
    lie within 30% of the profiler's span of the same programs."""
    ingest = prof["ingest"]
    share = ingest["kernel_busy_share"]
    per_call_ms = ingest["kernel_ms"] / max(1, prof["dispatches"])
    dev_p50 = lat["kernel.device"]["p50_ms"] if "kernel.device" in lat \
        else None
    spans = ingest["gated_spans_ms"]
    span_ms = float(np.median(spans)) if spans else None
    # the programs' spans as the profiler saw them (every group gated):
    # their kernels and the gaps between back-to-back kernels
    span_share = sum(spans) / ingest["wall_ms"] if spans else None
    r = {"occupancy_busy": prof["occupancy_busy"],
         "profiler_kernel_share": share,
         "busy_ratio": prof["occupancy_busy"] / share if share else None,
         "kernel_device_p50_ms": dev_p50,
         "profiler_ms_per_program": per_call_ms,
         "device_ratio": dev_p50 / per_call_ms if dev_p50 and per_call_ms
         else None,
         "profiler_gated_span_p50_ms": span_ms,
         "device_over_span": dev_p50 / span_ms if dev_p50 and span_ms
         else None,
         "profiler_span_share": span_share,
         "busy_over_span_share": prof["occupancy_busy"] / span_share
         if span_share else None,
         "gate_kernels": ingest["gate_kernels"],
         "gate_ms": ingest["gate_ms"],
         "dispatches": prof["dispatches"],
         "busy_counters": prof["busy_counters"]}
    r["busy_within_1_5"] = r["busy_ratio"] is not None and \
        1 / 1.5 <= r["busy_ratio"] <= 1.5
    r["device_within_30pct"] = r["device_ratio"] is not None and \
        0.7 <= r["device_ratio"] <= 1.3
    log(f"  {name} busy on {card}: tpu_device_busy_fraction over the "
        f"ingest {r['occupancy_busy']:.4f} vs torch.profiler's kernel share "
        f"{share:.4f} (ratio {r['busy_ratio']}, within 1.5x: "
        f"{r['busy_within_1_5']}); kernel.device p50 {dev_p50} ms vs "
        f"{per_call_ms:.4f} ms of kernels per program call "
        f"({prof['dispatches']} calls; ratio {r['device_ratio']}, within "
        f"30%: {r['device_within_30pct']}); the profiler's span of each "
        f"gated program's kernels, p50 {span_ms} ms (kernel.device over it "
        f"{r['device_over_span']}), their share of the ingest {span_share} "
        f"(the busy fraction over it {r['busy_over_span_share']}); "
        f"{ingest['gate_kernels']} gate kernels "
        f"({ingest['gate_ms']:.1f} ms, left out of the shares); "
        f"{prof['busy_counters']}")
    if hold and not (r["device_over_span"] is not None
                     and 0.7 <= r["device_over_span"] <= 1.3):
        raise AssertionError(f"{name}: kernel.device p50 {dev_p50} ms is "
                             f"not within 30% of the profiler's span of "
                             f"the gated programs, {span_ms} ms")
    return r


# -- phase 7: the detection lanes --------------------------------------------

# the reference's DDoS ramp (replay/generator.py DDOS_RAMP_PHASES):
# (phase, windows, attack share, rate multiple); a ramp phase's share
# rises to its value across its windows
RAMP_PHASES = (("baseline", 12, 0.0, 1), ("ramp", 3, 0.9, 2),
               ("sustained", 5, 0.9, 3), ("recovery", 8, 0.0, 1))
ONSET = 12                 # the first window with attack rows
VICTIM_IP, VICTIM_PORT = 0xAC10BEEF, 80
# the ingester's detection defaults: the plane at AnomalyConfig() and the
# shadow auditor at 1/64
DETECTION_KNOBS = {"anomaly": True, "audit_rate": 1.0 / 64}
DETECTORS_ORDER = ("entropy_ddos", "pca_residual", "mp_discord")


def ramp_windows(rng, records: int, pool: int = 1 << 17):
    """The DDoS ramp at `records` per 1x window: benign rows drawn by
    Zipf(1.1) from one flow pool; attack rows at each window's tail,
    sources spoofed uniformly over a /12, one victim IP and port, TCP,
    96 packets each (the reference generator's volumetric flood).
    Returns [(phase, cols)]."""
    base = flow_pool(rng, pool)
    out = []
    for name, n_win, share, rate in RAMP_PHASES:
        for i in range(n_win):
            n = records * rate
            frac = share * (i + 1) / n_win if name == "ramp" else share
            cols = draw(rng, base, n)
            k = int(n * frac)
            if k:
                tail = slice(n - k, n)
                cols["ip_src"][tail] = 0x0B000000 + rng.integers(
                    0, 1 << 20, k).astype(np.uint32)
                cols["ip_dst"][tail] = VICTIM_IP
                cols["port_src"][tail] = rng.integers(
                    1024, 1 << 16, k).astype(np.uint32)
                cols["port_dst"][tail] = VICTIM_PORT
                cols["proto"][tail] = 6
                cols["packet_tx"][tail] = 96
                cols["packet_rx"][tail] = 0
            out.append((name, cols))
    return out


def compare_planes(a_states, b_states, a_name, b_name):
    """Anomaly states at every window close: integer leaves exact, float
    leaves within rtol 1e-5 (atol 1e-6), the PCA basis by its projector
    within atol 1e-5."""
    from deepflow_tpu_torch import convert
    if len(a_states) != len(b_states) or not a_states:
        raise AssertionError(f"{a_name}: {len(a_states)} windows, {b_name}: "
                             f"{len(b_states)}")
    for w, (a, b) in enumerate(zip(a_states, b_states)):
        for (path, _), x, y in zip(convert.ANOMALY_LEAVES, a, b):
            if path == "pca.w":
                ok = np.allclose(x.astype(np.float64) @ x.T,
                                 y.astype(np.float64) @ y.T, rtol=0,
                                 atol=1e-5)
            elif x.dtype == np.float32:
                ok = np.allclose(x, y, rtol=1e-5, atol=1e-6)
            else:
                ok = x.dtype == y.dtype and np.array_equal(x, y)
            if not ok:
                raise AssertionError(f"window {w}: anomaly {path} differs "
                                     f"between {a_name} and {b_name}")


def run_detection(torch, dev, name, knobs, via_put, ramp, tmp,
                  trace_last=False):
    """One exporter over the whole ramp, its launch counts set to 0 just
    before and read just after. Per window: the sketch state published
    at the close, the plane's state, its entropy_ddos alerts, the
    audit's snapshot and the alarm. Records/s count ingest and flush,
    each window closed by a device synchronize, not the reads between
    windows. With `trace_last` the process tracer is on for the last
    window (attribution 1 group in ATTRIB_EVERY); its stages and gauges
    are kept."""
    from deepflow_tpu_torch import convert
    counters = launch_counters()
    exp = make_exporter(dev, knobs, os.path.join(tmp, name))
    snaps = bus_snapshots(exp)
    plane, audit = exp.anomaly, exp._audit
    r = {"snaps": snaps, "states": [], "alerts": [], "audit": [],
         "close_ms": [], "z_first": None, "alarm_baseline": 0}
    if plane is not None:
        close = plane.close_window

        def timed_close(*a, **k):
            t0 = time.perf_counter()
            try:
                return close(*a, **k)
            finally:
                r["close_ms"].append((time.perf_counter() - t0) * 1e3)
        plane.close_window = timed_close
    try:
        if via_put:
            exp.start()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        busy = 0.0
        for w, (_phase, cols) in enumerate(ramp):
            traced = trace_last and w == len(ramp) - 1
            if traced:
                tr, _occ = tracer_on()
                exp._attrib_every = ATTRIB_EVERY
            t0 = time.perf_counter()
            ingest_window(exp, cols, via_put)
            r["last_out"] = exp.flush_window(now=1000.0 + w)
            torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            if traced:
                tr.disable()
                r["traced"] = {"stages": sorted(tr.latency()),
                               "gauges": tr.gauges()}
            if plane is not None:
                r["states"].append(convert.anomaly_to_numpy(plane.state))
                r["alerts"].append(plane.alerts_total[0])
                if r["z_first"] is None and plane.alerts_total[0]:
                    r["z_first"] = (w, plane.bus.latest().leaves[2].tolist())
            if audit is not None:
                r["audit"].append(dict(audit.last_window))
                if w < ONSET and exp.audit_alarm:
                    r["alarm_baseline"] += 1
        r["launches"] = {k: c.launches for k, c in counters.items()}
        r["counters"] = exp.counters()
        r["plane"] = None if plane is None else plane.counters()
        r["audit_counters"] = None if audit is None else audit.counters()
    finally:
        exp.close()
    records = sum(len(c["ip_src"]) for _, c in ramp)
    r.update(seconds=busy, records_per_s=records / busy)
    c = r["counters"]
    if c["rows_in"] != records or c["lost_rows"] or c["device_errors"]:
        raise AssertionError(f"{name}: counters {c}")
    for k in ("fused_news_hists", "fused_lane_hists"):
        if r["launches"][k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    return r


def check_lanes(name, r, records):
    """Conservation, no loss on the detection lane, the audit closed
    every window, and no audit alarm over the baseline."""
    p, c = r["plane"], r["counters"]
    if not p["rows_seen"] == c["rows_in"] == p["table_offers"] == records:
        raise AssertionError(f"{name}: rows_seen {p['rows_seen']}, rows_in "
                             f"{c['rows_in']}, table_offers "
                             f"{p['table_offers']}, records {records}")
    if p["feed_errors"] or p["score_errors"] or p["alerts_shed"] \
            or p["windows_unscored"] or p["windows"] != c["windows"]:
        raise AssertionError(f"{name}: anomaly counters {p}")
    if r["audit_counters"]["windows"] != c["windows"] \
            or r["alarm_baseline"]:
        raise AssertionError(f"{name}: audit {r['audit_counters']}, alarm "
                             f"in {r['alarm_baseline']} baseline windows")


def check_small_detection(torch, dev, rng):
    """A small ramp through the dict inline exporter with the plane on,
    on the card and on the CPU (plain versions): the plane's state at
    every window close within compare_planes' tolerances, the same
    alerts."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    cfg = FlowSuiteConfig(cms_log2_width=12, ring_size=256, hll_groups=64,
                          hll_precision=8, entropy_log2_buckets=10)
    ramp = ramp_windows(rng, 4096, pool=3000)
    exps = [TpuSketchExporter(cfg=cfg, batch_rows=4096, wire="dict",
                              anomaly=True, device=d) for d in (dev, "cpu")]
    states, alerts, scores = ([], []), ([], []), ([], [])
    try:
        for w, (_phase, cols) in enumerate(ramp):
            for i, exp in enumerate(exps):
                feed_chunks(exp, cols, len(cols["ip_src"]))
                exp.flush_window(now=1000.0 + w)
                torch.cuda.synchronize()
                states[i].append(convert.anomaly_to_numpy(exp.anomaly.state))
                alerts[i].append(list(exp.anomaly.alerts_total))
                scores[i].append(list(exp.anomaly.last_scores))
    finally:
        for exp in exps:
            exp.close()
    compare_planes(states[0], states[1], "the card", "the CPU")
    acfg = exps[0].anomaly.cfg
    thr = np.array(acfg.thresholds)
    fired = [np.diff(np.array([[0] * len(thr)] + a), axis=0) > 0
             for a in alerts]
    sc = [np.array(x, np.float64) for x in scores]
    differ = fired[0] != fired[1]
    # mp_discord prices z-normalized distances of near-constant golden
    # series (the ramp's row count is constant outside the attack): a
    # difference of near-equal float32 products. Its alert may differ
    # only where a device's float32 score lies as far from the float64
    # score of its own ring as that lies from the threshold.
    d = DETECTORS_ORDER.index("mp_discord")
    edges = []
    for w in range(acfg.warmup_windows, len(ramp)):
        s64 = [mp_score_f64(torch, states[i][w], acfg.mp_m) for i in (0, 1)]
        err = max(abs(sc[i][w, d] - s64[i]) for i in (0, 1))
        gap = min(abs(x - thr[d]) for x in s64)
        if gap <= err or differ[w, d]:
            edges.append({
                "window": w, "score_card": float(sc[0][w, d]),
                "score_cpu": float(sc[1][w, d]), "f64_card": s64[0],
                "f64_cpu": s64[1], "threshold": float(thr[d]),
                "rounding_crosses": bool(gap <= err)})
    bad = [e for e in edges if not e["rounding_crosses"]]
    other = np.delete(differ, d, axis=1)
    if bad or other.any() or not alerts[0][-1][0]:
        raise AssertionError(
            f"small ramp alerts per window (totals of {DETECTORS_ORDER}): "
            f"card {alerts[0]}, CPU {alerts[1]}; mp_discord windows near "
            f"the threshold or differing: {edges}")
    rel = np.abs(sc[0] - sc[1]) / np.maximum(np.abs(sc[1]), 1e-12)
    return {"alerts_card": alerts[0][-1], "alerts_cpu": alerts[1][-1],
            "mp_discord_edges": edges,
            "score_rel_diff_max": dict(zip(DETECTORS_ORDER,
                                           rel.max(axis=0).tolist()))}


def mp_score_f64(torch, leaves, m):
    """The mp_discord score of a window, recomputed in float64 from the
    plane state's ring after that window (`window_step` scores the ring
    it keeps on a busy window)."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.ops import matrix_profile
    paths = [p for p, _ in convert.ANOMALY_LEAVES]
    st = matrix_profile.MPState(
        ring=torch.from_numpy(leaves[paths.index("mp.ring")]).double(),
        count=torch.from_numpy(leaves[paths.index("mp.count")]))
    return float(matrix_profile.latest_score(st, m).max())


def check_detection(torch, dev, rng, args, card, tmp):
    """Phase 7: the ingester's detection lanes on the dict feed."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.anomaly import AnomalyConfig, detectors

    t0 = time.perf_counter()
    ramp = ramp_windows(rng, args.ramp_records)
    records = sum(len(c["ip_src"]) for _, c in ramp)
    log(f"  ramp: {len(ramp)} windows, {records} records "
        f"({time.perf_counter() - t0:.1f} s to draw)")
    feed = INGESTER_RUNS[0][1]
    runs = {}
    for name, knobs, via_put in (
            ("a_dict_feed_lanes_on", dict(feed, **DETECTION_KNOBS), True),
            ("b_dict_feed_lanes_off", feed, True),
            ("c_dict_inline_lanes_on", dict(wire="dict", **DETECTION_KNOBS),
             False)):
        runs[name] = r = run_detection(torch, dev, name, knobs, via_put,
                                       ramp, tmp,
                                       trace_last=name.startswith("a_"))
        log(f"  {name}: {r['records_per_s']:.0f} records/s ({r['seconds']:.3f}"
            f" s for {records} records) on {card}; launches {r['launches']}")
    a, b, c = runs.values()
    compare_snaps(a["snaps"], b["snaps"], None, "(a) lanes on",
                  "(b) lanes off")
    compare_planes(a["states"], c["states"], "(a) dict feed",
                   "(c) dict inline")
    for name in ("a_dict_feed_lanes_on", "c_dict_inline_lanes_on"):
        check_lanes(name, runs[name], records)
    first, z = a["z_first"] or (None, None)
    if first is None or not ONSET <= first <= ONSET + 2 \
            or not (z[0] > 0 and z[1] < 0):
        raise AssertionError(f"entropy_ddos first alert at window {first} "
                             f"(onset {ONSET}), z {z}")
    ratio = a["records_per_s"] / b["records_per_s"]
    log(f"  sketch state bit-equal on all nine leaves at all {len(ramp)} "
        "window closes, lanes on and off; anomaly state (a) = (c) at every "
        "close; first entropy_ddos alert at window "
        f"{first} (onset {ONSET}), z {np.round(z, 3).tolist()}; "
        f"rows_seen == rows_in == table_offers == {records}")
    log(f"  records/s on {card}: lanes on {a['records_per_s']:.0f}, off "
        f"{b['records_per_s']:.0f}, ratio {ratio:.3f}")
    cm = a["close_ms"]
    log(f"  close_window host time: median {np.median(cm):.3f} ms, max "
        f"{max(cm):.3f} ms over {len(cm)} windows")
    audit = [(w, s.get("cms_rel_error"), s.get("topk_recall"))
             for w, s in enumerate(a["audit"])]
    log("  audit per window (window, cms_rel_error, topk_recall): "
        + ", ".join(f"({w}, {e if e is None else f'{e:.3g}'}, {t})"
                    for w, e, t in audit))

    # the window step alone, on the last window's output of (a)
    acfg = AnomalyConfig()
    st = convert.anomaly_from_numpy(a["states"][-1], device=dev)
    out = a["last_out"]

    def step():
        detectors.window_step(st, out.entropies, out.topk_counts,
                              out.service_cardinality, out.rows, acfg)
    step_ms = time_ms(torch, step)
    step_dev = device_ms(torch, step)
    log(f"  window step: {step_ms:.3f} ms per call, "
        + ("device time not measured" if step_dev is None
           else f"{step_dev:.4f} ms on the device") + f" on {card}")

    # one profiled window, lanes on and off: ingest syncs (the phase-6
    # rule, asserted inside), launches per group and the flush's syncs
    prof = profile_ingester_paths(
        torch, dev, [ramp[0][1], ramp[1][1]], tmp, card, runs=(
            ("dict_feed_lanes_on", dict(feed, **DETECTION_KNOBS), True, ()),
            ("dict_feed_lanes_off", feed, True, ())))
    on, off = prof["dict_feed_lanes_on"], prof["dict_feed_lanes_off"]
    attribution = traced_profile(
        torch, dev, [ramp[0][1], ramp[1][1]], tmp, card,
        ("dict_feed_lanes_on_traced", dict(feed, **DETECTION_KNOBS), True,
         ()), on)
    from deepflow_tpu_torch.runtime.audit import AUDIT_GAUGES
    traced = a["traced"]
    want = ("tpu_h2d_mb_s", "anomaly_score", "anomaly_alerts_total",
            "anomaly_detect_latency_windows", "anomaly_active_flows") \
        + AUDIT_GAUGES
    missing = [g for g in want if g not in traced["gauges"]]
    if missing:
        raise AssertionError(f"(a)'s traced last window lacks {missing}")
    attribution["ramp_window"] = traced
    log(f"  (a)'s last ramp window traced: stages {traced['stages']}; "
        f"gauges " + ", ".join(f"{g} {traced['gauges'][g]:.4g}"
                               for g in want))
    groups = max(on["fences"], 1)
    extra = (on["ingest"]["runtime_calls"]["cudaLaunchKernel"]
             - off["ingest"]["runtime_calls"]["cudaLaunchKernel"]) / groups
    syncs = {k: p["flush"]["runtime_calls"]["cudaStreamSynchronize"]
             for k, p in (("on", on), ("off", off))}
    log(f"  plane: {extra:.1f} extra kernel launches per dict group "
        f"({groups} groups); a flush's stream syncs: lanes on "
        f"{syncs['on']}, off {syncs['off']}")

    ladder = walk_ladder(torch, dev, rng, tmp, lanes=True)
    small = check_small_detection(torch, dev, rng)
    log(f"  small ramp: plane state on the card = on the CPU at every "
        f"window close; alerts card {small['alerts_card']}, CPU "
        f"{small['alerts_cpu']}: entropy_ddos and pca_residual equal at "
        f"every window, mp_discord wherever float32 rounding cannot cross "
        f"its threshold; mp_discord windows near it (float32 scores, "
        f"float64 scores of each device's ring) {small['mp_discord_edges']}"
        f"; largest relative score difference card vs CPU "
        f"{small['score_rel_diff_max']}")
    return {
        "records": records, "windows": len(ramp),
        "records_per_s": {k: r["records_per_s"] for k, r in runs.items()},
        "lanes_on_off_ratio": ratio,
        "launches": {k: r["launches"] for k, r in runs.items()},
        "first_alert_window": first, "z_at_first_alert": z,
        "alerts_total": a["plane"]["alerts_total"],
        "anomaly_counters": a["plane"], "audit_counters": a["audit_counters"],
        "audit_per_window": audit,
        "close_window_ms": {"median": float(np.median(cm)),
                            "max": float(max(cm))},
        "window_step_ms": step_ms, "window_step_device_ms": step_dev,
        "extra_launches_per_group": extra, "flush_stream_syncs": syncs,
        "profile": prof, "attribution": attribution, "ladder": ladder,
        "small_ramp_alerts": small, "card": card}


# -- phase 8: the L7 RED lane -------------------------------------------------

RED_ENDPOINTS = 4096       # server (ip_dst, port_dst, protocol) pool
RED_WINDOWS = 4
RED_RECORDS = 1 << 20      # l7 request records per window
RED_CHUNK = 1 << 16        # records per decoded chunk
# HTTP 200 / 3xx / 404 / 500 and enum-style codes 0-10 (0 ok)
RED_CODES = np.array([200, 301, 304, 404, 500] + list(range(11)), np.uint32)
RED_P = np.array([0.55, 0.05, 0.05, 0.05, 0.05, 0.15] + [0.01] * 10)
RED_QUANTILE_BAR = 1000    # groups with this many requests have quantiles
#                            checked against np.quantile


def red_pool(rng):
    """RED_ENDPOINTS distinct server endpoints and their Zipf(1.1)
    probabilities, truncated to the pool."""
    pool = {"ip_dst": (0xAC100000 + rng.permutation(1 << 16)[
                :RED_ENDPOINTS]).astype(np.uint32),
            "port_dst": rng.choice(np.array([80, 443, 8080, 3306, 6379,
                                             9092, 5432, 53], np.uint32),
                                   RED_ENDPOINTS),
            "protocol": np.where(rng.random(RED_ENDPOINTS) < 0.9, 6,
                                 17).astype(np.uint32)}
    p = 1.0 / np.arange(1, RED_ENDPOINTS + 1) ** 1.1
    return pool, p / p.sum()


def red_window(rng, pool, p, records):
    """One window of l7 request records: endpoints by Zipf(1.1), rrt_us
    log-normal (median 2,000 us, sigma 1.2) rounded with 1% zeros, and
    the status mix."""
    pick = rng.choice(RED_ENDPOINTS, records, p=p)
    cols = {k: v[pick] for k, v in pool.items()}
    rrt = np.round(rng.lognormal(np.log(2000.0), 1.2, records))
    rrt[rng.random(records) < 0.01] = 0
    cols["rrt_us"] = rrt.astype(np.uint32)
    cols["status"] = rng.choice(RED_CODES, records, p=RED_P)
    return cols


def red_truth(cols, cfg):
    """Exact numpy GROUP BY service group: requests, errors, and the
    latencies of each group, sorted by group."""
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    group = (fold_columns_np([cols["ip_dst"], cols["port_dst"],
                              cols["protocol"]])
             % np.uint32(cfg.groups)).astype(np.int64)
    st = cols["status"]
    err = (st >= 400) | ((st > 0) & (st < 100))
    order = np.argsort(group, kind="stable")
    return {"requests": np.bincount(group, minlength=cfg.groups),
            "errors": np.bincount(group[err], minlength=cfg.groups),
            "rrt_sorted": cols["rrt_us"][order],
            "edges": np.searchsorted(group[order],
                                     np.arange(cfg.groups + 1))}


def red_quantile_limit(cfg):
    """The sketch's relative error bound: alpha for an estimate at the
    exact log-space midpoint of the value's bucket, plus how far the
    midpoint table (the reference's float32 arithmetic) lies from it."""
    from deepflow_tpu_torch.ops import ddsketch
    dd = cfg.dd
    g = ddsketch.gamma(dd)
    exact = dd.min_value * 2 * g ** np.arange(dd.buckets) / (g + 1)
    off = np.abs(ddsketch.midpoints(dd).astype(np.float64) / exact - 1).max()
    return dd.alpha + (1 + dd.alpha) * float(off)


def check_red_window(out, truth, cfg, rows, now):
    """One window: counts equal the GROUP BY, every group's sketch (hist
    and zeros) adds up to its requests, quantiles of every group with
    RED_QUANTILE_BAR requests within red_quantile_limit of the value of
    rank ceil(q*n) (np.quantile's "inverted_cdf", the value the sketch
    estimates), and the app_red rows of the window equal its output.
    np.quantile's default linear interpolation is reported beside it: in
    a sparse tail (p99 of a few thousand values) the two order statistics
    it interpolates between lie ~10% apart. Returns the worst relative
    errors and the groups checked."""
    from deepflow_tpu_torch.runtime.app_red import quantile_column
    reqs = out.requests.cpu().numpy()
    errs = out.errors.cpu().numpy()
    qs = out.rrt_quantiles.cpu().numpy()
    if not (np.array_equal(reqs, truth["requests"].astype(np.float32))
            and np.array_equal(errs, truth["errors"].astype(np.float32))):
        raise AssertionError(f"RED window {now}: counts differ from the "
                             "exact GROUP BY")
    sketched = (out.rrt_hist.cpu().numpy().sum(1, dtype=np.float64)
                + out.rrt_zeros.cpu().numpy())
    if not np.array_equal(sketched, truth["requests"]):
        raise AssertionError(f"RED window {now}: the sketch holds "
                             f"{int(sketched.sum())} values for "
                             f"{int(truth['requests'].sum())} requests")
    worst, linear, checked = 0.0, 0.0, 0
    for g in np.nonzero(truth["requests"] >= RED_QUANTILE_BAR)[0]:
        vals = truth["rrt_sorted"][truth["edges"][g]:truth["edges"][g + 1]]
        exact = np.quantile(vals, cfg.quantiles, method="inverted_cdf")
        worst = max(worst, float((np.abs(qs[:, g] - exact) / exact).max()))
        interp = np.quantile(vals, cfg.quantiles)
        linear = max(linear, float((np.abs(qs[:, g] - interp)
                                    / interp).max()))
        checked += 1
    if checked == 0 or worst > red_quantile_limit(cfg):
        raise AssertionError(f"RED window {now}: quantile relative error "
                             f"{worst} over {checked} groups")
    sel = rows["timestamp"] == int(now)
    active = np.nonzero(reqs > 0)[0]
    ok = (np.array_equal(rows["service_group"][sel], active)
          and np.array_equal(rows["requests"][sel], reqs[active])
          and np.array_equal(rows["errors"][sel], errs[active])
          and all(np.array_equal(rows[quantile_column(q)][sel], qs[i, active])
                  for i, q in enumerate(cfg.quantiles)))
    if not ok:
        raise AssertionError(f"RED window {now}: app_red rows differ from "
                             "the window output")
    return worst, linear, checked


def red_ingest(exp, cols):
    """One window's records through put() and the worker thread, waiting
    until every chunk is processed."""
    total = len(cols["rrt_us"])
    want = exp.processed + -(-total // RED_CHUNK)
    for s in range(0, total, RED_CHUNK):
        exp.put("l7_flow_log", 0,
                {k: v[s:s + RED_CHUNK] for k, v in cols.items()})
    deadline = time.monotonic() + 300
    while exp.processed + exp.process_errors < want:
        if time.monotonic() > deadline:
            raise AssertionError("the RED exporter's worker did not drain")
        time.sleep(0.0005)
    if exp.process_errors:
        raise AssertionError(f"RED process() raised {exp.process_errors} "
                             "times")


def check_red_small(torch, dev, rng):
    """A small stream through the RED exporter on the card and on the
    CPU (plain versions), with u32 edges (rrt_us and status at 2^31 and
    2^32-1) and the integers next to every bucket boundary: every state
    leaf before each flush and every output field equal."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
    from deepflow_tpu_torch.ops import ddsketch
    from deepflow_tpu_torch.runtime.app_red import AppRedExporter

    cfg = AppSuiteConfig(groups=64)
    b = ddsketch.boundaries(cfg.dd)
    boundary = np.unique(np.concatenate([np.floor(b), np.ceil(b)]))
    edges = np.array([0, 1, 2, 2**31, 2**31 + 1, 2**32 - 1], np.uint64)
    pool, p = red_pool(rng)
    exps = [AppRedExporter(cfg=cfg, batch_rows=4096, device=d)
            for d in (dev, "cpu")]
    try:
        for w in range(2):
            cols = red_window(rng, pool, p, 10000)
            extra = np.concatenate([boundary, edges]).astype(np.uint32)
            cols["rrt_us"][:len(extra)] = extra
            cols["status"][:4] = [2**31, 2**32 - 1, 2**31 - 1, 99]
            for exp in exps:
                for s in range(0, 10000, 3000):
                    exp.process([("l7_flow_log", 0, {
                        k: v[s:s + 3000] for k, v in cols.items()}, -1)])
            torch.cuda.synchronize()
            leaves = [convert.app_to_numpy(e.state) for e in exps]
            for (path, _), a, c in zip(convert.APP_LEAVES, *leaves):
                if not np.array_equal(a, c):
                    raise AssertionError(f"RED small stream: {path} on the "
                                         "card differs from the CPU")
            og, oc = (e.flush_window(now=10.0 + w) for e in exps)
            for name in og._fields:
                if not np.array_equal(getattr(og, name).cpu().numpy(),
                                      getattr(oc, name).numpy()):
                    raise AssertionError(f"RED small stream: output {name} "
                                         "on the card differs from the CPU")
    finally:
        for e in exps:
            e.close()
    return len(boundary)


def check_red(torch, dev, rng, card, tmp):
    """Phase 8: the RED lane at AppSuiteConfig() and batch_rows 2^14,
    through put() and the worker thread with a Store."""
    from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
    from deepflow_tpu_torch.ops import cuda_hist
    from deepflow_tpu_torch.runtime.app_red import (APP_RED_DB,
                                                    AppRedExporter)
    from deepflow_tpu_torch.store.db import Store

    cfg = AppSuiteConfig()
    t0 = time.perf_counter()
    pool, p = red_pool(rng)
    windows = [red_window(rng, pool, p, RED_RECORDS)
               for _ in range(RED_WINDOWS)]
    truths = [red_truth(c, cfg) for c in windows]
    records = sum(len(c["rrt_us"]) for c in windows)
    log(f"  {RED_WINDOWS} windows of {len(windows[0]['rrt_us'])} l7 records "
        f"({time.perf_counter() - t0:.1f} s to draw)")
    store_dir = os.path.join(tmp, "store_red")
    exp = AppRedExporter(store=Store(store_dir), cfg=cfg, batch_rows=RED_C,
                         window_seconds=3600, device=dev)
    nows = [2000.0 + w for w in range(RED_WINDOWS)]
    outs = []
    try:
        exp.start()
        torch.cuda.synchronize()
        cuda_hist.hist_add_cuda.launches = 0
        t0 = time.perf_counter()
        for cols, now in zip(windows, nows):
            red_ingest(exp, cols)
            outs.append(exp.flush_window(now=now))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = cuda_hist.hist_add_cuda.launches
        c = exp.counters()
        prof = profile_red_window(torch, dev, exp, windows[0])
    finally:
        exp.close()
    batches = c["batches"]
    if launches != 3 * batches or c["h2d_transfers"] != batches:
        raise AssertionError(f"RED: {launches} hist launches and "
                             f"{c['h2d_transfers']} copies for {batches} "
                             "batches, not 3 and 1 per batch")
    if c["rows_in"] != records or c["d2h_transfers"] != RED_WINDOWS:
        raise AssertionError(f"RED counters {c}")
    rows = read_table(store_dir, APP_RED_DB, "app_red")
    worst = [check_red_window(out, truth, cfg, rows, now)
             for out, truth, now in zip(outs, truths, nows)]
    log(f"  RED: {records / dt:.0f} records/s ({dt:.3f} s for {records} "
        f"records, put() to the last flush) on {card}; {batches} batches, "
        f"{launches} hist launches; per window: counts = exact GROUP BY, "
        f"quantile relative error (worst against rank ceil(q*n), against "
        f"linear interpolation, groups checked) {worst}, asserted <= "
        f"{red_quantile_limit(cfg)!r} (alpha plus the midpoint table's "
        f"rounding; every reading also within 3 alpha = "
        f"{3 * cfg.dd_alpha:.2f}); hist + zeros = requests per group; "
        f"app_red rows = window outputs")
    n_boundary = check_red_small(torch, dev, rng)
    log(f"  RED small stream: the card = the CPU on every leaf and output "
        f"({n_boundary} boundary integers and the u32 edges)")
    return {"records": records, "seconds": dt,
            "records_per_s": records / dt, "batches": batches,
            "launches": {"hist": launches, "fused_lane_hists": 0,
                         "fused_news_hists": 0},
            "quantile_error_worst_and_groups": worst, "counters": c,
            "profile": prof, "small_boundary_values": n_boundary,
            "card": card}


def profile_red_window(torch, dev, exp, cols):
    """One more window under torch.profiler (`profile_window`), its
    ingest (every chunk processed) and its flush: busy share, kernel
    launches and copies per batch, the flush's copies and syncs."""
    before = exp.counters()
    ingest, flush = profile_window(
        torch, dev, lambda: red_ingest(exp, cols),
        lambda: exp.flush_window(now=3000.0))
    batches = exp.counters()["batches"] - before["batches"]
    calls = ingest["runtime_calls"]
    out = {"ingest": ingest, "flush": flush, "batches": batches,
           "launches_per_batch": calls["cudaLaunchKernel"] / max(batches, 1),
           "h2d_copies_per_batch": ingest["h2d_copies"] / max(batches, 1)}
    log(f"  RED profiled window: ingest {ingest['wall_ms']:.1f} ms, device "
        f"busy {100 * ingest['device_busy_share']:.1f}%, {batches} batches, "
        f"{out['launches_per_batch']:.1f} kernel launches and "
        f"{out['h2d_copies_per_batch']:.2f} h2d copies "
        f"({ingest['h2d_pinned']} pinned, {ingest['h2d_pageable']} pageable, "
        f"{calls['cudaMemcpyAsync']} cudaMemcpyAsync) per window, "
        f"d2h {ingest['d2h_copy_activities']}; syncs "
        + ", ".join(f"{k} {calls[k]}" for k in SYNC_CALLS)
        + f"; flush {flush['wall_ms']:.1f} ms, d2h copies "
        f"{flush['d2h_copy_activities']}, runtime copy calls "
        f"{flush['memcpy_calls']}, syncs "
        + ", ".join(f"{k} {flush['runtime_calls'][k]}" for k in SYNC_CALLS))
    return out


# -- phase 9: the multi-device suites ----------------------------------------

SHARDS = 4                 # single-process shards sharing the card
SHARD_BATCH = SHARDS * SHARD_C   # global batch
DICT_CAP = 1 << 20         # the sharded suite's default dict capacity
FLOW_KEYS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
             "packet_tx", "packet_rx")
# entropies of equal histograms, card against CPU: float32 sums of 1024
# p log p terms in the two devices' orders (a few ulps)
ENT_CARD_CPU = 2e-6


def global_batches(cols, batch=SHARD_BATCH):
    """(batch columns, mask, valid rows) of `batch` rows each, the last
    one zero-padded."""
    total = len(next(iter(cols.values())))
    for s in range(0, total, batch):
        n = min(total, s + batch) - s
        part = {}
        for k, v in cols.items():
            buf = np.zeros(batch, v.dtype)
            buf[:n] = v[s:s + n]
            part[k] = buf
        yield part, np.arange(batch) < n, n


def to_card(torch, dev, cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(
        dev) for k, v in cols.items()}


def full_row_plane(cols):
    """The (17, B) SKETCH_L4_SCHEMA plane of a batch (absent columns 0)."""
    from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
    n = len(cols["ip_src"])
    return np.stack([cols[name].astype(np.uint32) if name in cols
                     else np.zeros(n, np.uint32)
                     for name, _ in SKETCH_L4_SCHEMA.columns])


def zero_launches():
    for c in launch_counters().values():
        c.launches = 0


def read_launches(name, wants=("hist",), never=()):
    launches = {k: c.launches for k, c in launch_counters().items()}
    for k in wants:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    for k in never:
        if launches[k]:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches[k]} times")
    return launches


def report_profile(name, ingest, flush, batches, card):
    calls = ingest["runtime_calls"]
    per = calls["cudaLaunchKernel"] / max(batches, 1)
    log(f"  {name} profiled window on {card}: ingest {ingest['wall_ms']:.1f}"
        f" ms, device busy {100 * ingest['device_busy_share']:.1f}%, "
        f"{batches} global batches, {per:.1f} kernel launches per global "
        f"batch, h2d {ingest['h2d_copies']} copies; syncs "
        + ", ".join(f"{k} {calls[k]}" for k in SYNC_CALLS)
        + f"; flush {flush['wall_ms']:.1f} ms, {flush['kernels']} kernels, "
        f"d2h {flush['d2h_copy_activities']}, syncs "
        + ", ".join(f"{k} {flush['runtime_calls'][k]}" for k in SYNC_CALLS))
    return {"ingest": ingest, "flush": flush, "global_batches": batches,
            "launches_per_global_batch": per}


def check_sharded_flow(torch, dev, windows, card):
    """Phase 9a: ShardedFlowSuite at FlowSuiteConfig() on a 4-shard mesh,
    through its four forms, against flow_suite.update on one device."""
    from deepflow_tpu_torch.models import flow_dict, flow_suite
    from deepflow_tpu_torch.parallel import ShardedFlowSuite, make_mesh
    from deepflow_tpu_torch.parallel import sharded

    cfg = flow_suite.FlowSuiteConfig()
    mesh = make_mesh(SHARDS, device=dev)
    ref, state = [], flow_suite.init(cfg, dev)
    for cols in windows:
        for part, mask, _ in global_batches(cols):
            state = flow_suite.update(
                state, to_card(torch, dev, {k: part[k] for k in FLOW_KEYS}),
                torch.from_numpy(mask).to(dev), cfg)
        ref.append(snapshot(state))
        state, _ = flow_suite.flush(state, cfg)

    def run(form):
        suite = ShardedFlowSuite(cfg, mesh)
        st = suite.init()
        tables = packer = None
        if form == "dict":
            tables = suite.init_dict(DICT_CAP)
            packer = flow_dict.FlowDictPacker(capacity=DICT_CAP,
                                              hits_batch=SHARD_BATCH)
        snaps, outs, shards = [], [], []
        for cols in windows:
            for part, mask, n in global_batches(
                    {k: cols[k] for k in FLOW_KEYS}):
                if form == "cols":
                    st = suite.update(st, *suite.put_batch(part, mask))
                elif form == "plane":
                    st = suite.update_plane(st, *suite.put_plane(
                        full_row_plane(part), mask))
                elif form == "lanes":
                    lanes = flow_suite.pack_lanes(part)
                    st = suite.update_lanes(st, suite.put_lanes(np.stack(
                        [lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])), n)
                else:
                    for kind, plane, m in packer.pack(
                            {k: v[:n] for k, v in part.items()}) \
                            + packer.flush():
                        if kind == "news":
                            st, tables = suite.update_news(st, tables, plane,
                                                           m)
                        else:
                            st = suite.update_hits(st, tables, plane, m)
            snaps.append(snapshot(sharded._merge_axis0(st)))
            if tables is not None:
                if not all(torch.equal(t.table, tables[0].table)
                           for t in tables):
                    raise AssertionError("dict table replicas differ")
                # phase 12's reference for the dict form: every shard
                shards.append({
                    "shards": [leaf_hashes(snapshot(x)) for x in st],
                    "table": leaf_hashes([tables[0].table.cpu().numpy()])})
            st, out = suite.flush(st)
            outs.append(out)
        return snaps, outs, shards

    forms, launches, mesh_ref = {}, {}, {}
    for form in ("cols", "plane", "lanes", "dict"):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        snaps, outs, shards = run(form)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # the sharded path counts on hist: the fused kernels never run
        launches[form] = read_launches(
            f"sharded {form}", never=("fused_lane_hists", "fused_news_hists"))
        compare_snaps(ref, snaps, WIRE_FREE_LEAVES, "one device",
                      f"sharded {form}")
        recalls = []
        for w, out in enumerate(outs):
            check_output(torch, out, cfg)
            if int(out.rows) != len(windows[w]["ip_src"]):
                raise AssertionError(f"sharded {form}: rows {int(out.rows)}")
            got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
            recalls.append(len(got & exact_topk(windows[w], cfg.top_k))
                           / cfg.top_k)
        if min(recalls) < 0.99:
            raise AssertionError(f"sharded {form}: recall {recalls}")
        records = sum(len(w["ip_src"]) for w in windows)
        forms[form] = {"seconds": dt, "records_per_s": records / dt,
                       "recall": recalls, "launches": launches[form]}
        if form in MESH_FORMS:
            # phase 12's reference: every merged leaf and output field
            mesh_ref[form] = [{"leaves": leaf_hashes(sn),
                               "out": out_record(o)}
                              for sn, o in zip(snaps, outs)]
            if shards:
                mesh_ref[form + "_shards"] = shards
        log(f"  ShardedFlowSuite {form}: {records / dt:.0f} records/s on "
            f"{card}; merged CMS, HLL, entropy, rows = one device at both "
            f"window closes; recall {recalls}; launches {launches[form]}")

    suite = ShardedFlowSuite(cfg, mesh)
    box = {"st": suite.init()}
    batches = list(global_batches({k: windows[0][k] for k in FLOW_KEYS}))

    def ingest():
        for part, mask, _ in batches:
            box["st"] = suite.update(box["st"], *suite.put_batch(part, mask))

    prof = report_profile("ShardedFlowSuite (cols)", *profile_window(
        torch, dev, ingest, lambda: suite.flush(box["st"])), len(batches),
        card)
    return {"forms": forms, "profile": prof, "mesh_ref": mesh_ref}


def check_sharded_app(torch, dev, rng, card):
    """Phase 9b: ShardedAppSuite at AppSuiteConfig() on phase 8's l7
    records against AppSuite on one device: every output field equal."""
    from deepflow_tpu_torch.models import app_suite
    from deepflow_tpu_torch.parallel import ShardedAppSuite, make_mesh

    cfg = app_suite.AppSuiteConfig()
    pool, p = red_pool(rng)
    windows = [red_window(rng, pool, p, RED_RECORDS) for _ in range(2)]
    single, wants = app_suite.init(cfg, dev), []
    for cols in windows:
        for part, mask, _ in global_batches(cols):
            single = app_suite.update(single, to_card(torch, dev, part),
                                      torch.from_numpy(mask).to(dev), cfg)
        single, want = app_suite.flush(single, cfg)
        wants.append(want)
    suite = ShardedAppSuite(cfg, make_mesh(SHARDS, device=dev))
    st = suite.init()
    outs = []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for w, (cols, want) in enumerate(zip(windows, wants)):
        for part, mask, _ in global_batches(cols):
            st = suite.update(st, *suite.put_batch(part, mask))
        st, out = suite.flush(st)
        outs.append(out)
        for name in out._fields:
            if not torch.equal(getattr(out, name), getattr(want, name)):
                raise AssertionError(f"ShardedAppSuite window {w}: {name} "
                                     "differs from one device")
        if int(out.requests.sum()) != len(cols["rrt_us"]):
            raise AssertionError("ShardedAppSuite: requests lost")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(
        "sharded app", never=("fused_lane_hists", "fused_news_hists"))
    log(f"  ShardedAppSuite: window outputs = one device, every field, both "
        f"windows; {dt:.3f} s for the sharded run on {card}; launches "
        f"{launches}")
    box = {"st": suite.init()}
    batches = list(global_batches(windows[0]))

    def ingest():
        for part, mask, _ in batches:
            box["st"] = suite.update(box["st"], *suite.put_batch(part, mask))

    prof = report_profile("ShardedAppSuite", *profile_window(
        torch, dev, ingest, lambda: suite.flush(box["st"])), len(batches),
        card)
    return {"seconds": dt, "launches": launches, "profile": prof,
            "mesh_ref": {"windows": windows,
                         "outs": [leaf_hashes([t.cpu().numpy() for t in o])
                                  for o in outs]}}


def metric_documents(rng, cols):
    """flow_metrics Documents, one per l4 row of phase 7's ramp: ip =
    ip_dst and server_port = port_dst; packet_tx and packet_rx from the
    row; the per-window reading of the reference generator's
    `golden_traffic` taken per row: new_flow 1, closed_flow = close_type
    > 0 (0: the ramp's rows carry no close_type, as the exporter's schema
    coerce leaves them), syn = packet_rx == 0 (every spoofed row); the
    signals an l4 row lacks drawn from seeded log-normals: bytes = packets
    x a packet size (median 600 B, sigma 0.6, within [40, 1500]), synack
    (median 1), retransmissions (median 0.2), rtt_sum (median 20,000 us)
    and rtt_count (median 3), rounded to u32."""
    n = len(cols["ip_src"])

    def ln(median, sigma):
        return np.round(rng.lognormal(np.log(median), sigma, n)).astype(
            np.uint32)

    size = np.clip(rng.lognormal(np.log(600.0), 0.6, (2, n)), 40, 1500)
    return {
        "ip": cols["ip_dst"], "server_port": cols["port_dst"],
        "packet_tx": cols["packet_tx"], "packet_rx": cols["packet_rx"],
        "byte_tx": (cols["packet_tx"] * size[0]).astype(np.uint32),
        "byte_rx": (cols["packet_rx"] * size[1]).astype(np.uint32),
        "new_flow": np.ones(n, np.uint32),
        "closed_flow": (cols.get("close_type", np.zeros(n, np.uint32))
                        > 0).astype(np.uint32),
        "syn": (cols["packet_rx"] == 0).astype(np.uint32),
        "synack": ln(1.0, 1.0), "retrans_tx": ln(0.2, 1.0),
        "retrans_rx": ln(0.2, 1.0), "rtt_sum": ln(20000.0, 1.0),
        "rtt_count": ln(3.0, 0.5)}


def projector(w):
    w = w.detach().cpu().numpy().astype(np.float64)
    return w @ w.T


def metric_suites(torch, dev, cfg):
    """The three meshes phase 9c compares: 4 shards on the card, 1 shard
    on the card, 4 shards on the CPU."""
    from deepflow_tpu_torch.parallel import ShardedMetricsSuite, make_mesh
    return {"card4": ShardedMetricsSuite(cfg, make_mesh(SHARDS, device=dev)),
            "card1": ShardedMetricsSuite(cfg, make_mesh(1, device=dev)),
            "cpu4": ShardedMetricsSuite(cfg, make_mesh(SHARDS,
                                                       device="cpu"))}


def run_metric_windows(torch, runs, windows, label, keep=0):
    """Each window's Documents through every suite of `runs`, then its
    flush against the last batch; at every window close the 4 card shards
    equal the 4 CPU shards (histograms exact, entropies rtol ENT_CARD_CPU,
    alarms equal, z rtol 1e-5, projector and mp_scores rtol 1e-4) and the
    1 card shard (histograms and entropies exact, z rtol 1e-5, projector,
    anomaly and mp scores rtol 1e-4), the basis and the rings
    bit-identical across the 4 card shards. Launches are counted on the
    4 card shards' updates and flushes only. The first `keep` windows'
    Documents and 4-card-shard results are kept for phase 12
    (`metrics_record`)."""
    states = {k: s.init() for k, s in runs.items()}
    kept = []
    seconds = dict.fromkeys(runs, 0.0)
    launches = {}
    alarms, zmax, mp = [], [], []
    for w, docs in enumerate(windows):
        batches = list(global_batches(docs))
        outs, hists = {}, {}
        for name, suite in runs.items():
            torch.cuda.synchronize()
            zero_launches()
            t1 = time.perf_counter()
            st = states[name]
            for part, mask, _ in batches:
                st = suite.update(st, *suite.put_batch(part, mask))
            hists[name] = sum(s.ent.hist.cpu().to(torch.int64) for s in st)
            if name == "card4" and w < keep:
                kept.append({"docs": docs, "pre": metrics_int_hashes(st)})
            last, mask, _ = batches[-1]
            states[name], outs[name] = suite.flush(
                st, *suite.put_batch(last, mask))
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t1
            if name == "card4":
                for k, v in read_launches(
                        f"{label} metrics", never=("fused_lane_hists",
                                                   "fused_news_hists")
                        ).items():
                    launches[k] = launches.get(k, 0) + v
        c4, c1, cpu = outs["card4"], outs["card1"], outs["cpu4"]
        ws = [s.pca.w for s in states["card4"]]
        checks = {
            "hist card = cpu": torch.equal(hists["card4"], hists["cpu4"]),
            "hist 4 = 1": torch.equal(hists["card4"], hists["card1"]),
            "entropies 4 = 1": torch.equal(c4.entropies, c1.entropies),
            "alarm 4 = 1 = cpu": bool(c4.ddos_alarm) == bool(c1.ddos_alarm)
            == bool(cpu.ddos_alarm),
            "basis bit-identical across shards": all(
                torch.equal(x, ws[0]) for x in ws),
            "rings identical across shards": all(
                torch.equal(s.mp.ring, states["card4"][0].mp.ring)
                for s in states["card4"]),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"{label} metrics window {w}: {bad}")
        close = (
            ("entropies card vs cpu", c4.entropies, cpu.entropies,
             dict(rtol=ENT_CARD_CPU, atol=0)),
            ("z card vs cpu", c4.z_scores, cpu.z_scores,
             dict(rtol=1e-5, atol=1e-5)),
            ("mp card vs cpu", c4.mp_scores, cpu.mp_scores,
             dict(rtol=1e-4, atol=1e-5)),
            ("z 4 vs 1", c4.z_scores, c1.z_scores, dict(rtol=1e-5, atol=0)),
            ("anomaly 4 vs 1", c4.anomaly_scores, c1.anomaly_scores,
             dict(rtol=1e-4, atol=1e-5)),
            ("mp 4 vs 1", c4.mp_scores, c1.mp_scores,
             dict(rtol=1e-4, atol=1e-5)))
        for what, a, b, tol in close:
            np.testing.assert_allclose(
                a.cpu().numpy(), b.cpu().numpy(),
                err_msg=f"{label} window {w}: {what}", **tol)
        for other in ("cpu4", "card1"):
            np.testing.assert_allclose(
                projector(ws[0]), projector(states[other][0].pca.w),
                rtol=1e-4, atol=1e-5,
                err_msg=f"{label} window {w}: projector card4 vs {other}")
        alarms.append(bool(c4.ddos_alarm))
        zmax.append(float(c4.z_scores.abs().max()))
        mp.append(c4.mp_scores.cpu().numpy())
        if w < keep:
            kept[-1].update(metrics_record(c4, ws[0]))
    return {"alarms": alarms, "max_abs_z": zmax, "mp_scores": mp,
            "seconds": seconds, "launches": launches, "kept": kept}


def metrics_int_hashes(states):
    """Per shard, the hashes of a metrics state's integer leaves."""
    from deepflow_tpu_torch import convert
    ints = [i for i, (_, dt) in enumerate(convert.METRICS_LEAVES)
            if np.dtype(dt).kind != "f"]
    return [leaf_hashes([convert.metrics_to_numpy(s)[i] for i in ints])
            for s in states]


def metrics_record(out, w):
    """A metrics window output and the PCA projector, as host arrays."""
    return {"entropies": out.entropies.cpu().numpy(),
            "z": out.z_scores.cpu().numpy(),
            "alarm": bool(out.ddos_alarm),
            "scores": out.anomaly_scores.cpu().numpy(),
            "mp": out.mp_scores.cpu().numpy(), "projector": projector(w)}


def level_documents(rng, n, level, victim):
    """n flow_metrics Documents: ip over 3000 addresses, server_port over
    five services, each golden signal uniform below its `level`; with
    `victim` every Document targets one (ip, port). The signals keep
    their levels under attack: a window sum held nearly constant (the
    ramp's 90-99 packets a flow) makes the discord a difference of
    near-equal float32 products, which the card and the CPU round apart."""
    from deepflow_tpu_torch.models.metrics_suite import GOLDEN_SIGNALS
    cols = {"ip": rng.integers(0, 3000, n).astype(np.uint32),
            "server_port": rng.choice([53, 80, 443, 3306, 8080], n).astype(
                np.uint32)}
    for s in GOLDEN_SIGNALS:
        cols[s] = rng.integers(0, level[s], n).astype(np.uint32)
    if victim:
        cols["ip"][:] = VICTIM_IP
        cols["server_port"][:] = VICTIM_PORT
    return cols


# the warm pass: an EWMA that settles within the 10 windows before the
# alarm may fire and 8-window subsequences, scored from window 15 on
WARM_CFG = dict(ewma_alpha=0.3, mp_length=32, mp_m=8)
WARM_WINDOWS, WARM_STEP, WARM_RECORDS = 20, 12, 1 << 17


def check_sharded_metrics(torch, dev, rng, args, card):
    """Phase 9c: ShardedMetricsSuite at MetricsSuiteConfig() over phase
    7's DDoS ramp, then at WARM_CFG over WARM_WINDOWS windows of
    Documents with a destination concentration step at WARM_STEP, where
    the alarm branch and the matrix profile's scores run: 4 shards on
    the card against 4 shards on the CPU and 1 shard on the card."""
    from deepflow_tpu_torch.models.metrics_suite import (GOLDEN_SIGNALS,
                                                         MetricsSuiteConfig)

    cfg = MetricsSuiteConfig()
    t0 = time.perf_counter()
    ramp = ramp_windows(rng, args.ramp_records)
    docs = (metric_documents(rng, cols) for _phase, cols in ramp)
    log(f"  ramp: {len(ramp)} windows ({time.perf_counter() - t0:.1f} s to "
        "draw)")
    runs = metric_suites(torch, dev, cfg)
    r = run_metric_windows(torch, runs, docs, "ramp", keep=MESH_WINDOWS)
    alarms, zmax = r["alarms"], r["max_abs_z"]
    first_alarm = alarms.index(True) if any(alarms) else None
    records = sum(len(c["ip_src"]) for _, c in ramp)
    log(f"  ShardedMetricsSuite over the ramp ({records} Documents, "
        f"{len(ramp)} windows): every window close as run_metric_windows "
        f"asserts; first ddos_alarm at window {first_alarm} (onset {ONSET});"
        f" alarms at {[w for w, a in enumerate(alarms) if a]}; max |z| "
        f"{max(zmax):.3f} at window {int(np.argmax(zmax))} (threshold "
        f"{cfg.z_threshold}); mp_scores nonzero in "
        f"{sum(bool(m.any()) for m in r['mp_scores'])} windows; seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items())
        + f"; launches (4 shards) {r['launches']}")

    wcfg = MetricsSuiteConfig(**WARM_CFG)
    warm_docs = []
    for w in range(WARM_WINDOWS):
        # window sums spread over orders of magnitude: the discord of a
        # near-constant series is ill-conditioned in float32
        level = {s: int(10 ** rng.uniform(0.5, 4.5)) for s in GOLDEN_SIGNALS}
        warm_docs.append(level_documents(rng, WARM_RECORDS, level,
                                         w >= WARM_STEP))
    warm = run_metric_windows(torch, metric_suites(torch, dev, wcfg),
                              warm_docs, "warm")
    scored = warm["mp_scores"][2 * wcfg.mp_m - 1:]
    if warm["alarms"][:WARM_STEP] != [False] * WARM_STEP \
            or not warm["alarms"][WARM_STEP]:
        raise AssertionError(f"warm metrics: alarms {warm['alarms']}, "
                             f"the step at window {WARM_STEP}")
    if not all((m > 0).all() for m in scored):
        raise AssertionError(f"warm metrics: mp_scores {scored}")
    log(f"  ShardedMetricsSuite warm pass ({WARM_WINDOWS} windows of "
        f"{WARM_RECORDS} Documents, {WARM_CFG}): alarms at "
        f"{[w for w, a in enumerate(warm['alarms']) if a]} (step at "
        f"{WARM_STEP}), max |z| {max(warm['max_abs_z']):.3f}; mp_scores "
        f"of all {len(GOLDEN_SIGNALS)} signals > 0 at windows "
        f"{2 * wcfg.mp_m - 1}..{WARM_WINDOWS - 1} (range "
        f"{min(float(m.min()) for m in scored):.4f}.."
        f"{max(float(m.max()) for m in scored):.4f}), card4 = cpu4 = card1 "
        f"at every close; launches (4 shards) {warm['launches']}")

    suite = runs["card4"]
    batches = list(global_batches(metric_documents(rng, ramp[0][1])))
    box = {"st": suite.init()}

    def ingest():
        for part, mask, _ in batches:
            box["st"] = suite.update(box["st"], *suite.put_batch(part, mask))

    last, mask, _ = batches[-1]
    last_d = suite.put_batch(last, mask)     # copied before the session

    def flush():
        suite.flush(box["st"], *last_d)

    prof = report_profile("ShardedMetricsSuite", *profile_window(
        torch, dev, ingest, flush), len(batches), card)
    launches = dict(r["launches"])
    for k, v in warm["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return {"records": records, "windows": len(ramp),
            "first_alarm_window": first_alarm, "alarms": alarms,
            "max_abs_z": zmax, "seconds": r["seconds"],
            "warm": {"alarms": warm["alarms"],
                     "max_abs_z": warm["max_abs_z"],
                     "mp_scores": [m.tolist() for m in warm["mp_scores"]],
                     "seconds": warm["seconds"],
                     "launches": warm["launches"]},
            "launches": launches, "profile": prof, "mesh_ref": r["kept"]}


def check_sharded(torch, dev, rng, args, windows, card):
    """Phase 9: the three sharded suites on a 4-shard mesh of the card."""
    flow = check_sharded_flow(torch, dev, windows, card)
    app = check_sharded_app(torch, dev, rng, card)
    metrics = check_sharded_metrics(torch, dev, rng, args, card)
    launches = [f["launches"] for f in flow["forms"].values()] \
        + [app["launches"], metrics["launches"]]
    mesh_ref = {"flow": flow.pop("mesh_ref"), "app": app.pop("mesh_ref"),
                "metrics": metrics.pop("mesh_ref")}
    return {"flow": flow, "app": app, "metrics": metrics,
            "launches": launches, "card": card}, mesh_ref


# -- phase 10: the store's read half, the rollup GROUP BY, flow_metrics ------

FM_TUPLES = 8192          # distinct vtap_flow_port tag tuples (cut from
#                            16,384 for time)
FM_SECONDS = 120          # one report per tuple per second: two minutes
FM_CHUNK = 1 << 14        # rows per decoded chunk put into the pipeline
FM_INTERVAL = 60
FM_WAVES = 4              # the writer flushed after each 30 s of reports
GROUPBY_SIZES = (1 << 16, 1 << 18, 1 << 20)   # those below every row, then
#                                                 every row
GROUPBY_REPEATS = 3


def fm_tuples(rng, n=None):
    """`n` distinct tag tuples of vtap_flow_port (every KEY column but
    timestamp and tag_code): ip over 4096 addresses, server_port by
    Zipf(1.1) over 1024 ports, vtap_id over 64, l3_epc_id over -1..62,
    the rest small enums and hashes."""
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    n = FM_TUPLES if n is None else n
    keys = [c for c in METRICS_TABLE.columns if c.agg.value == "key"
            and c.name not in ("timestamp", "tag_code")]
    ports = rng.permutation(np.arange(1, 65536))[:1024].astype(np.uint32)
    hosts = (0x0A000000 + rng.permutation(1 << 20)[:4096]).astype(np.uint32)
    m = 4 * n
    gens = {
        "ip": lambda: hosts[rng.integers(0, 4096, m)],
        "server_port": lambda: ports[zipf_ranks(rng, m, 1024)],
        "vtap_id": lambda: rng.integers(1, 65, m),
        "l3_epc_id": lambda: rng.integers(-1, 63, m),
        "protocol": lambda: np.where(rng.random(m) < 0.85, 6, 17),
        "direction": lambda: rng.integers(0, 2, m),
        "tap_side": lambda: rng.integers(0, 4, m),
        "tap_type": lambda: rng.integers(0, 3, m),
        "tap_port": lambda: rng.integers(0, 16, m),
        "l7_protocol": lambda: rng.choice(np.array([0, 20, 21, 40, 80]), m),
        "gprocess_id": lambda: rng.integers(0, 256, m),
        "signal_source": lambda: rng.integers(0, 2, m),
        "pod_id": lambda: rng.integers(0, 512, m),
        "app_service_hash": lambda: rng.integers(0, 1 << 32, m,
                                                 dtype=np.uint64),
        "endpoint_hash": lambda: rng.integers(0, 1 << 32, m,
                                              dtype=np.uint64),
    }
    draws = {c.name: gens[c.name]().astype(c.dtype) for c in keys}
    packed = np.stack([draws[c.name].astype(np.int64) for c in keys], axis=1)
    _, first = np.unique(packed, axis=0, return_index=True)
    if len(first) < n:
        raise AssertionError(f"{len(first)} distinct tuples drawn, need {n}")
    pick = np.sort(rng.permutation(first)[:n])
    return {c.name: draws[c.name][pick] for c in keys}


def fm_rows(rng, t0, tuples, seconds=FM_SECONDS):
    """Every tuple reports once a second from t0 (in a fresh order each
    second): the METRIC_SCHEMA columns of seconds x tuples rows. The
    meters are phase 9's `metric_documents` signals (packets from
    seeded log-normals on the tuple's destination), the other meters
    seeded log-normals (medians 1-1000 by kind, sigma 1.5); 1 tuple in
    512 carries a byte_tx, rtt_sum and rtt_max near 0xFFFFFFFF, so their
    60 s sums saturate the u32 clip."""
    from deepflow_tpu_torch.pipelines.tag_code import (FLOW_METER,
                                                       VTAP_FLOW_PORT)
    n_t = len(tuples["ip"])
    order = np.concatenate([rng.permutation(n_t) for _ in range(seconds)])
    n = len(order)
    cols = {"timestamp": (t0 + np.repeat(np.arange(seconds), n_t))
            .astype(np.uint32),
            "tag_code": np.full(n, int(VTAP_FLOW_PORT), np.uint64)}
    for k, v in tuples.items():
        cols[k] = v[order]
    pk = np.round(rng.lognormal(np.log(20.0), 1.2, (2, n))).astype(np.uint32)
    l4 = {"ip_src": cols["ip"], "ip_dst": cols["ip"],
          "port_dst": cols["server_port"],
          "packet_tx": pk[0], "packet_rx": pk[1]}
    docs = metric_documents(rng, l4)
    for name in FLOW_METER:
        if name in docs:
            cols[name] = docs[name].astype(np.uint32)
        else:
            median = 1000.0 if name.endswith(("_sum", "_max")) else 3.0
            cols[name] = np.round(rng.lognormal(np.log(median), 1.5, n)
                                  ).clip(max=0xFFFFFFFF).astype(np.uint32)
    hot = (order % 512) == 7
    for name in ("byte_tx", "rtt_sum", "rtt_max"):
        cols[name][hot] = np.uint32(0xFFFFFFFF) - rng.integers(
            0, 1 << 16, int(hot.sum())).astype(np.uint32)
    return cols


def numpy_rollup(cols, interval=FM_INTERVAL):
    """The 1m tier by plain numpy: np.unique over the 17 keys (the time
    bucket among them) as int64 rows, np.add.reduceat for the sums and
    np.maximum.reduceat for the maxes over the rows sorted by group,
    clipped to u32."""
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    keys = [c.name for c in METRICS_TABLE.columns if c.agg.value == "key"]
    bucket = cols["timestamp"] // np.uint32(interval) * np.uint32(interval)
    packed = np.stack([(bucket if k == "timestamp" else cols[k])
                       .astype(np.int64) for k in keys], axis=1)
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(uniq)))
    out = {}
    for c in METRICS_TABLE.columns:
        if c.agg.value == "key":
            out[c.name] = uniq[:, keys.index(c.name)].astype(c.dtype)
            continue
        v = cols[c.name].astype(np.int64)[order]
        red = (np.maximum if c.agg.value == "max" else np.add).reduceat(
            v, starts)
        out[c.name] = red.clip(0, 0xFFFFFFFF).astype(c.dtype)
    return out


def assert_tables_equal(want, got, what):
    if list(want) != list(got):
        raise AssertionError(f"{what}: columns {list(got)} != {list(want)}")
    for k in want:
        if want[k].dtype != got[k].dtype or not np.array_equal(want[k],
                                                                 got[k]):
            raise AssertionError(f"{what}: column {k} differs")


class ChunkCounter:
    """The pipeline's exporter seat: counts the rows handed on."""

    def __init__(self):
        self.rows = 0
        self._lock = threading.Lock()

    def put(self, stream, index, cols):
        with self._lock:
            self.rows += len(cols["timestamp"])


def run_pipeline(torch, dev, root, cols, t0):
    """(a): every row through FlowMetricsPipeline.put in chunks, two
    unmarshallers, the writer flushed after each of FM_WAVES waves (one
    segment each); records/s from the first put to the last segment on
    disk. Then the rollup build by advance()."""
    from deepflow_tpu_torch.pipelines.flow_metrics import (
        FLOW_METRICS_DB, FlowMetricsPipeline)
    from deepflow_tpu_torch.store.db import Store
    n = len(cols["timestamp"])
    sink = ChunkCounter()
    pipe = FlowMetricsPipeline(Store(root), exporters=sink,
                               n_unmarshallers=2, rollup_intervals=(60,),
                               rollup_period=1.0, device=dev)
    pipe.start()
    try:
        base = pipe.rollups.base
        deadline = time.monotonic() + 300

        def wait(done, what):
            while not done():
                if time.monotonic() > deadline:
                    raise AssertionError(f"pipeline stalled {what}: "
                                         f"{pipe.counters()}")
                time.sleep(0.005)

        t = time.perf_counter()
        wave = n // FM_WAVES
        for lo in range(0, n, wave):
            hi = min(lo + wave, n)
            for i in range(lo, hi, FM_CHUNK):
                j = min(i + FM_CHUNK, hi)
                pipe.put({k: v[i:j] for k, v in cols.items()})
            wait(lambda: pipe.counters()["records"]
                 + pipe.counters()["decode_errors"] >= hi, "in the queues")
            pipe.flush()
            # the writer's own thread may still be writing what it took
            wait(lambda: base.rows_written >= pipe.counters()["records"],
                 "in the writer")
        ingest_s = time.perf_counter() - t
        c = pipe.counters()
        if c["records"] != n or c["decode_errors"] or sink.rows != n \
                or base.row_count() != n:
            raise AssertionError(f"pipeline: sent {n}, records "
                                 f"{c['records']}, decode_errors "
                                 f"{c['decode_errors']}, exporter {sink.rows}"
                                 f", stored {base.row_count()}")
        now = t0 + FM_SECONDS + pipe.rollups.allowance
        torch.cuda.synchronize()
        t = time.perf_counter()
        emitted = pipe.rollups.advance(now)
        build_s = time.perf_counter() - t
        again = pipe.rollups.advance(now)
    finally:
        pipe.close()
    return pipe, {"rows": n, "ingest_s": ingest_s,
                  "records_per_s": n / ingest_s, "build_s": build_s,
                  "emitted": emitted, "second_advance": again,
                  "segments": base.counters()["segments_written"],
                  "disk_bytes": base.disk_bytes(), "counters": c,
                  "now": now, "db": FLOW_METRICS_DB}


def build_split(torch, dev, mgr, lo, hi, tmp):
    """One 1m build's steps timed apart, each device step closed by a
    synchronize: scan, the host lexsort (group ids), the value block (u32
    words stacked on the host), the host-to-device copy (and the widening
    to int64 on the device), the segment reduce, the device-to-host copy,
    the append (into a scratch table). Returns the times and the rows it
    built."""
    from deepflow_tpu_torch.store import rollup
    from deepflow_tpu_torch.store.db import Store
    s = {}
    t = time.perf_counter()
    cols = mgr.base.scan(time_range=(lo, hi))
    s["scan"] = time.perf_counter() - t
    key_names, aggs = mgr.rollup_plan()
    work = mgr.bucketed(cols, FM_INTERVAL)
    t = time.perf_counter()
    packed = np.stack([np.ascontiguousarray(work[k]).astype(np.int64)
                       for k in key_names], axis=1)
    uniq, inverse = rollup._unique_rows(packed)
    s["host_lexsort"] = time.perf_counter() - t
    t = time.perf_counter()
    order = rollup._kind_order(list(aggs), aggs)
    runs = rollup._value_runs(work, order)
    s["value_block"] = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    seg = rollup._to_device(inverse, dev)
    data = rollup._value_block(runs, len(inverse), dev)
    torch.cuda.synchronize()
    s["h2d"] = time.perf_counter() - t
    t = time.perf_counter()
    red = rollup._segment_reduce(seg, None, data, [aggs[k] for k in order],
                                 len(uniq))
    torch.cuda.synchronize()
    s["device_reduce"] = time.perf_counter() - t
    t = time.perf_counter()
    host = red.cpu().numpy()
    s["d2h"] = time.perf_counter() - t
    reduced = {k: uniq[:, j] for j, k in enumerate(key_names)}
    reduced.update({k: host[:, i] for i, k in enumerate(order)})
    out = mgr.clipped({c.name: reduced[c.name].astype(c.dtype)
                       if c.name in key_names else reduced[c.name]
                       for c in mgr.base.schema.columns})
    scratch = Store(os.path.join(tmp, "split")).create_table(
        "db", mgr.targets[0][1].schema)
    t = time.perf_counter()
    scratch.append(out)
    s["append"] = time.perf_counter() - t
    s["value_block_bytes"] = int(sum(b.nbytes for _, b in runs))
    return s, out


def profile_call(torch, dev, fn, attempts=3):
    """fn() in one torch.profiler session bracketed by `mark` calls and
    closed by a synchronize (trace_session). A session whose trace holds
    no kernel at all (the profiler sometimes records no device activity
    for a short session) is run again, up to `attempts` times; the
    count is returned. Pageable host-to-device copies are sometimes
    missing from a trace that has its kernels: `h2d_copies` says
    whether they were recorded."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mark(torch, dev)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            mark(torch, dev)
        r = trace_session(torch, prof, wall)
        if r["kernels"]:
            break
    r["attempts"] = attempt
    cuda = torch.autograd.DeviceType.CUDA
    r["device_ms"] = _union_us([(e.time_range.start, e.time_range.end)
                                for e in prof.events()
                                if e.device_type == cuda]) / 1e3
    r["kernel_ms"] = sum(e.time_range.end - e.time_range.start
                         for e in prof.events() if e.device_type == cuda
                         and not e.name.startswith(("Memcpy", "Memset"))
                         ) / 1e3
    return r


def compare_groupby(torch, dev, cols, card):
    """(b): group_reduce over the minute buckets without tag_code (every
    key within u32, l3_epc_id signed) on the card by the host path and
    the device path and on the CPU by both, array for array; wall time
    (median of GROUPBY_REPEATS) and a profiled call of each card path."""
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    from deepflow_tpu_torch.store.rollup import AUTO_DEVICE_ROWS, group_reduce
    keys = [c.name for c in METRICS_TABLE.columns
            if c.agg.value == "key" and c.name != "tag_code"]
    aggs = {c.name: c.agg.value for c in METRICS_TABLE.columns
            if c.agg.value != "key"}
    work = dict(cols)
    work["timestamp"] = cols["timestamp"] // np.uint32(FM_INTERVAL) \
        * np.uint32(FM_INTERVAL)
    rows = []
    n_all = len(cols["timestamp"])
    for n in tuple(x for x in GROUPBY_SIZES if x < n_all) + (n_all,):
        part = {k: work[k][:n] for k in keys + list(aggs)}
        outs = {}
        for where, method in (("card", "host"), ("card", "device"),
                              ("cpu", "host"), ("cpu", "device")):
            outs[where, method] = group_reduce(
                part, keys, aggs, method=method,
                device=dev if where == "card" else "cpu")
        ref = outs["card", "host"]
        for k, o in outs.items():
            assert_tables_equal(ref, o, f"group_reduce n={n} {k}")
        row = {"rows": n, "groups": len(ref["timestamp"])}
        for method in ("host", "device"):
            walls = []
            for _ in range(GROUPBY_REPEATS):
                t = time.perf_counter()
                group_reduce(part, keys, aggs, method=method, device=dev)
                walls.append(time.perf_counter() - t)
            prof = profile_call(torch, dev, lambda: group_reduce(
                part, keys, aggs, method=method, device=dev))
            row[method] = {
                "wall_ms": float(np.median(walls)) * 1e3,
                "device_ms": prof["device_ms"],
                "kernel_ms": prof["kernel_ms"], "kernels": prof["kernels"],
                "h2d_ms": prof["h2d_ms"] if prof["h2d_copies"] else None,
                "profile_attempts": prof["attempts"],
                "syncs": {k: prof["runtime_calls"][k] for k in SYNC_CALLS},
                "d2h": prof["d2h_copy_activities"]}
        # the sync contract: the host path's one copy back, the device
        # path's group count and copy back; the device sync is the
        # profiler session's own
        for method, want in (("host", 1), ("device", 2)):
            if row[method]["syncs"] != {"cudaStreamSynchronize": want,
                                        "cudaEventSynchronize": 0,
                                        "cudaDeviceSynchronize": 1}:
                raise AssertionError(f"group_reduce {method} n={n}: syncs "
                                     f"{row[method]['syncs']}")
        faster = "device" if row["device"]["wall_ms"] < row["host"][
            "wall_ms"] else "host"
        row["faster"] = faster
        row["auto_takes"] = "device" if n >= AUTO_DEVICE_ROWS else "host"
        def dev_line(r):
            h2d = "not recorded" if r["h2d_ms"] is None \
                else f"{r['h2d_ms']:.2f} ms"
            return (f"{r['wall_ms']:.2f} ms wall ({r['kernel_ms']:.3f} ms "
                    f"of {r['kernels']} kernels on the device, host-to-"
                    f"device copies {h2d})")

        log(f"  group_reduce {n} rows -> {row['groups']} groups on {card}: "
            f"host path {dev_line(row['host'])}, device path "
            f"{dev_line(row['device'])}; faster: {faster}, auto takes "
            f"{row['auto_takes']}; card = cpu, host = device")
        rows.append(row)
    return rows


def check_compaction(torch, base, tier):
    """(c): compact the base and the tier and scan them unchanged; then a
    torn segment in the base: scan serves around it and counts it,
    compact quarantines it."""
    res = {}
    for t in (base, tier):
        before = t.scan()
        n0 = len(t._segment_files(t.partitions()))
        removed = t.compact(max_segment_bytes=1 << 30, min_segments=2)
        n1 = len(t._segment_files(t.partitions()))
        assert_tables_equal(before, t.scan(), f"{t.schema.name} compacted")
        t.compact(max_segment_bytes=1 << 30, min_segments=2)  # drop sources
        assert_tables_equal(before, t.scan(), f"{t.schema.name} swept")
        res[t.schema.name] = {"segments_before": n0, "removed": removed,
                              "segments_after": n1}
        if removed == 0 and n0 > 1:
            raise AssertionError(f"{t.schema.name}: nothing compacted")
    rows = base.row_count()
    pdir = os.path.join(base.root, f"p{base.partitions()[0]:012d}")
    src = sorted(f for f in os.listdir(pdir) if f.endswith(".npz"))[0]
    with open(os.path.join(pdir, src), "rb") as f:
        head = f.read(1 << 16)
    with open(os.path.join(pdir, "seg-99999999.npz"), "wb") as f:
        f.write(head)                               # a torn write
    skipped = base.segments_skipped_corrupt
    if base.row_count() != rows or len(base.scan(["timestamp"])[
            "timestamp"]) != rows:
        raise AssertionError("a torn segment changed the rows scanned")
    if base.segments_skipped_corrupt - skipped != 2:
        raise AssertionError("the torn segment was not counted")
    quarantined = base.segments_quarantined
    base.compact(max_segment_bytes=1 << 30, min_segments=2)
    if base.segments_quarantined - quarantined != 1 or not os.path.exists(
            os.path.join(pdir, "seg-99999999.npz.bad")):
        raise AssertionError("compact did not quarantine the torn segment")
    if base.row_count() != rows:
        raise AssertionError("rows changed by the quarantine")
    res["torn"] = {"skipped": 2, "quarantined": 1}
    log(f"  compaction: {res}")
    return res


def check_flow_metrics(torch, dev, rng, card, querier=None):
    """Phase 10: the flow_metrics pipeline's store lane, the rollup
    GROUP BY on the card, the store's read half. `querier(root, db,
    cols, t0)` runs on the store as the pipeline left it (phase 15 (a));
    its result is returned beside phase 10's."""
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    from deepflow_tpu_torch.store.db import Store
    from deepflow_tpu_torch.store.rollup import RollupManager
    t0 = (int(time.time()) // 3600 + 2) * 3600     # ahead: the ticker waits
    t = time.perf_counter()
    cols = fm_rows(rng, t0, fm_tuples(rng))
    gen_s = time.perf_counter() - t
    n = len(cols["timestamp"])
    log(f"  {n} rows ({FM_TUPLES} tuples x {FM_SECONDS} s, "
        f"{sum(v.nbytes for v in cols.values()) / 1e6:.1f} MB) made in "
        f"{gen_s:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fm_") as tmp:
        root = os.path.join(tmp, "store")
        pipe, run = run_pipeline(torch, dev, root, cols, t0)
        db = run["db"]
        if run["emitted"] != {60: 2 * FM_TUPLES} \
                or run["second_advance"] != {60: 0}:
            raise AssertionError(f"advance emitted {run['emitted']}, then "
                                 f"{run['second_advance']}")
        store = Store(root)
        tier = store.table(db, METRICS_TABLE.name + ".1m")
        t = time.perf_counter()
        want = numpy_rollup(cols)
        ref_s = time.perf_counter() - t
        assert_tables_equal(want, tier.scan(), "1m tier vs numpy GROUP BY")
        fresh = RollupManager(store, db, METRICS_TABLE, intervals=(60,),
                              device=dev)
        if fresh._built_until[60] != t0 + FM_SECONDS \
                or fresh.advance(run["now"]) != {60: 0}:
            raise AssertionError("a fresh manager did not recover the "
                                 "watermark")
        log(f"  pipeline: {n} rows, {run['records_per_s']:.0f} records/s "
            f"from put() to segments on disk ({run['segments']} segments, "
            f"{run['disk_bytes'] / 1e6:.1f} MB); rollup build "
            f"{run['build_s'] * 1e3:.1f} ms for {2 * FM_TUPLES} 1m rows; "
            f"numpy reference {ref_s:.1f} s; 1m tier = numpy")
        sql = None if querier is None else querier(root, db, cols, t0)
        split, out = build_split(torch, dev, fresh, t0, t0 + FM_SECONDS, tmp)
        assert_tables_equal(want, out, "build split vs numpy")
        log("  build split (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()
            if k != "value_block_bytes")
            + f"; value block {split['value_block_bytes'] / 1e6:.1f} MB")
        groupby = compare_groupby(torch, dev, cols, card)
        compaction = check_compaction(torch, store.table(db,
                                                         METRICS_TABLE.name),
                                      tier)
        # (d): a 2-minute tier's backfill, one build through advance(),
        # and one device GROUP BY, each under torch.profiler. A session
        # the profiler recorded nothing of is run again: each attempt
        # drops the tier and builds it anew, so the retry repeats the work

        def build_120s():
            fresh.remove_interval(120)
            fresh.add_interval(120)
            fresh.advance(run["now"])
        build_prof = profile_call(torch, dev, build_120s, attempts=5)
        if len(store.table(db, METRICS_TABLE.name + ".120s")
               .scan(["timestamp"])["timestamp"]) != FM_TUPLES:
            raise AssertionError("the 120 s tier did not build")
        if build_prof["runtime_calls"]["cudaStreamSynchronize"] != 1:
            raise AssertionError(f"a rollup build synced "
                                 f"{build_prof['runtime_calls']}")
        log(f"  profiled build (120 s tier) on {card}: "
            f"{build_prof['wall_ms']:.1f} ms wall, device busy "
            f"{100 * build_prof['device_busy_share']:.2f}%, "
            f"{build_prof['kernels']} kernels, h2d "
            f"{build_prof['h2d_copies']} copies {build_prof['h2d_ms']:.2f} "
            f"ms, d2h {build_prof['d2h_copy_activities']}, syncs "
            + ", ".join(f"{k} {build_prof['runtime_calls'][k]}"
                        for k in SYNC_CALLS))
        full = groupby[-1]["device"]
        log(f"  device GROUP BY at {groupby[-1]['rows']} rows: "
            f"{full['kernels']} kernel launches, syncs {full['syncs']}, "
            f"{full['d2h']} device-to-host copies")
    return {"rows": n, "tuples": FM_TUPLES, "seconds": FM_SECONDS,
            "pipeline": {k: v for k, v in run.items() if k != "db"},
            "numpy_reference_s": ref_s, "build_split_s": split,
            "groupby": groupby, "compaction": compaction,
            "build_profile": build_prof, "card": card}, sql


# -- phase 11: the pod fault domains and the cross-host pod ------------------

POD_SHARDS = 4
POD_BATCH = 1 << 15        # the exporter's batch_rows: 2^13 rows per shard
HOSTPOD_BATCH = 1 << 16    # the cross-host pod's batch_rows: ~2^14 per shard
DCN_TIMEOUT_S = 120        # the two gloo processes of 11(d), start to end


def lane_planes(cols, batch):
    """(plane, valid) of each `batch`-row slice of a window, packed as the
    exporter packs a TensorBatch (the last one zero-padded)."""
    from deepflow_tpu_torch.models import flow_suite
    for part, _, n in global_batches({k: cols[k] for k in FLOW_KEYS}, batch):
        lanes = flow_suite.pack_lanes(part)
        yield np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES]), n


def conserve(c, label):
    """The pod-wide ledger of one counters() snapshot."""
    got = (c["pod_rows_delivered"] + c["pod_rows_host"] + c["pod_rows_lost"]
           + c["pod_rows_pending"])
    if c["pod_rows_sent"] != got:
        raise AssertionError(f"{label}: sent {c['pod_rows_sent']} != "
                             f"delivered + host + lost + pending {got}")
    return c


def recall(out, cols, k):
    got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
    return len(got & exact_topk(cols, k)) / k


def check_pod_exporter(torch, dev, windows, card):
    """Phase 11a: TpuSketchExporter(pod_shards=4) through put() against
    the sharded suite's lanes form on 4 shards over the same planes."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.parallel import ShardedFlowSuite, make_mesh
    from deepflow_tpu_torch.parallel import sharded
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    cfg = FlowSuiteConfig()
    suite = ShardedFlowSuite(cfg, make_mesh(POD_SHARDS, device=dev))
    st, want_snaps, want_outs, batches = suite.init(), [], [], 0
    all_planes = [list(lane_planes(cols, POD_BATCH)) for cols in windows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for planes in all_planes:
        for plane, n in planes:
            st = suite.update_lanes(st, suite.put_lanes(plane), n)
            batches += 1
        want_snaps.append(snapshot(sharded.rescore_ring(
            sharded._merge_axis0(st))))
        st, out = suite.flush(st)
        want_outs.append(out)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    exp = TpuSketchExporter(cfg=cfg, batch_rows=POD_BATCH,
                            window_seconds=3600, pod_shards=POD_SHARDS,
                            pod_merge_deadline_s=60.0, device=dev)
    snaps, outs, merge_s = bus_snapshots(exp), [], []
    ingest_s, flush_s = [], []
    records = sum(len(w["ip_src"]) for w in windows)
    try:
        exp.start()
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        for w, cols in enumerate(windows):
            ti = time.perf_counter()
            ingest_window(exp, cols, via_put=True)
            if not exp.pod.drain(120):
                raise AssertionError("pod exporter: shards did not drain")
            tf = time.perf_counter()
            outs.append(exp.flush_window(now=2000.0 + w))
            merge_s.append(exp.pod.last_merge_s)
            ingest_s.append(tf - ti)
            flush_s.append(time.perf_counter() - tf)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(
            "pod exporter", never=("fused_lane_hists", "fused_news_hists"))
        if not exp.pod.drain(60):
            raise AssertionError("pod exporter: shards did not drain")
        c = conserve(exp.counters(), "pod exporter")
        if c["pod_rows_delivered"] != records or c["rows_in"] != records:
            raise AssertionError(f"pod exporter: delivered "
                                 f"{c['pod_rows_delivered']} of {records}")
        shard_batches = POD_SHARDS * batches
        if launches["hist"] != 2 * shard_batches:
            raise AssertionError(f"pod exporter: {launches['hist']} hist "
                                 f"launches for {shard_batches} shard "
                                 "batches, not 2 per shard batch")
        compare_snaps(want_snaps, snaps, None, "sharded lanes", "pod")
        recalls = []
        for w, (out, want) in enumerate(zip(outs, want_outs)):
            check_output(torch, out, cfg)
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"pod exporter: window {w} output "
                                     "differs from the sharded suite's")
            recalls.append(recall(out, windows[w], cfg.top_k))
        if min(recalls) < 0.99:
            raise AssertionError(f"pod exporter: recall {recalls}")

        def ingest():
            ingest_window(exp, windows[0], via_put=True)
            exp.pod.drain(60)

        prof = report_profile("pod exporter (4 shards)", *profile_window(
            torch, dev, ingest, lambda: exp.flush_window(now=2100.0)),
            batches // len(windows), card)
    finally:
        exp.close()
    conserve(exp.counters(), "pod exporter closed")
    log(f"  pod exporter (4 shards): {records / dt:.0f} records/s on {card}; "
        f"every leaf = the sharded suite's at both window closes; recall "
        f"{recalls}; ingest {[round(x, 3) for x in ingest_s]} s, flush "
        f"{[round(x * 1e3, 1) for x in flush_s]} ms, last_merge_s "
        f"{[round(x * 1e3, 1) for x in merge_s]} ms per window; "
        f"{launches['hist'] / batches:.1f} hist launches per global batch; "
        f"launches {launches}; the sharded suite's lanes form on one thread "
        f"over the same planes: {records / sharded_s:.0f} records/s")
    return {"records_per_s": records / dt, "seconds": dt, "recall": recalls,
            "ingest_s": ingest_s, "flush_s": flush_s,
            "last_merge_s": merge_s, "launches": launches,
            "hist_per_global_batch": launches["hist"] / batches,
            "sharded_lanes_records_per_s": records / sharded_s,
            "profile": prof, "outs": outs}


def walk_pod_ladder(torch, dev, windows):
    """Phase 11b: injected faults only, on a 4-shard PodFlowSuite on the
    card: rollback, degrade (rows shed, counted), probe recovery,
    straggler exclusion with its late merge, kill with rejoin."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.parallel import PodFlowSuite
    from deepflow_tpu_torch.runtime.faults import default_faults

    faults = default_faults()
    planes = itertools.cycle([p for w in windows
                              for p in lane_planes(w, POD_BATCH)])
    pod = PodFlowSuite(FlowSuiteConfig(), n_shards=POD_SHARDS,
                       merge_deadline_s=30.0, snapshot_batches=2,
                       degrade_after=2, device=dev)
    b = POD_BATCH // POD_SHARDS
    steps = {}

    def feed(k):
        t0 = time.perf_counter()
        for _ in range(k):
            plane, n = next(planes)
            pod.put_lanes(plane.copy(), n)
        return time.perf_counter() - t0

    def settle():
        if not pod.drain(60):
            raise AssertionError("pod ladder: shards did not drain")

    def step(name, res, **want):
        c = conserve(pod.counters(), f"pod ladder {name}")
        for k, v in want.items():
            got = getattr(res, k)
            if got != v:
                raise AssertionError(f"pod ladder {name}: {k} {got} != {v}")
        steps[name] = {k: c[k] for k in (
            "pod_rows_sent", "pod_rows_delivered", "pod_rows_host",
            "pod_rows_lost", "pod_rows_shed", "pod_rows_pending",
            "pod_device_errors", "pod_merge_missed", "pod_late_merges",
            "pod_rejoins")}
        log(f"  pod ladder {name}: {steps[name]}")
        return c

    def status(i):
        return pod.shard_status()[i]

    torch.cuda.synchronize()
    zero_launches()
    try:
        faults.arm("shard.device_error", count=1, match="shard1:update")
        feed(6)
        settle()
        c = step("rollback", pod.close_epoch(),
                 participated=list(range(POD_SHARDS)), lossy=True)
        if c["pod_device_errors"] != 1 or status(1)["status"] != "active" \
                or not 0 < c["pod_rows_lost"] <= 3 * b:
            raise AssertionError(f"pod ladder rollback: {status(1)}")
        faults.arm("shard.device_error", count=2, match="shard1:update")
        feed(6)
        settle()
        if status(1)["status"] != "degraded":
            raise AssertionError(f"pod ladder: shard 1 {status(1)}")
        shed0 = pod.counters()["pod_rows_shed"]
        feed(2)
        settle()
        # the probe runs on the shard's worker right after it posts its
        # contribution: whether the close still reads shard 1 degraded
        # depends on the clock, so `degraded` is not asserted here
        c = step("degrade", pod.close_epoch(), lossy=True, host_outputs=[])
        if c["pod_rows_host"] or c["pod_rows_shed"] - shed0 < 2 * b \
                or pod._shards[1]._host is not None:
            raise AssertionError("pod ladder: a degraded shard on the card "
                                 "must shed its rows, counted, and run "
                                 "nothing on the CPU")
        faults.disarm("shard.device_error")
        feed(2)
        settle()
        step("probe recovery", pod.close_epoch(), degraded=[],
             participated=list(range(POD_SHARDS)))
        if status(1)["recoveries"] != 1:
            raise AssertionError(f"pod ladder: {status(1)}")
        faults.arm("merge.stall", count=1, delay_s=1.5, match="shard2:")
        feed(4)
        settle()
        c = step("straggler", pod.close_epoch(deadline_s=0.3), missed=[2],
                 lossy=True)
        took = feed(4)
        if took > 0.5:
            raise AssertionError(f"pod ladder: ingest blocked {took:.3f} s "
                                 "behind a straggler")
        time.sleep(1.6)
        settle()
        c = step("late merge", pod.close_epoch(), missed=[], lossy=True)
        if c["pod_late_merges"] < 1:
            raise AssertionError("pod ladder: no late merge")
        faults.disarm("merge.stall")
        feed(6)
        settle()
        pod.kill(3)
        took = feed(2)
        if took > 0.5:
            raise AssertionError(f"pod ladder: ingest blocked {took:.3f} s "
                                 "behind a lost shard")
        c = step("kill", pod.close_epoch(), lost=[3], lossy=True)
        if c["pod_rejoins"] != 1:
            raise AssertionError("pod ladder: shard 3 did not rejoin")
        step("rejoin by snapshot", pod.close_epoch(), lossy=True)
        feed(2)
        settle()
        step("after rejoin", pod.close_epoch(), lossy=False,
             participated=list(range(POD_SHARDS)))
    finally:
        faults.disarm()
        pod.close()
    torch.cuda.synchronize()
    launches = read_launches("pod ladder")
    c = conserve(pod.counters(), "pod ladder closed")
    if c["pod_rows_pending"]:
        raise AssertionError(f"pod ladder: {c['pod_rows_pending']} rows "
                             "pending after close")
    return {"steps": steps, "launches": launches}


def leaf_hashes(leaves):
    import hashlib
    return [hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for a in leaves]


def out_record(out):
    """A window output as plain lists (exact: float32 values round-trip
    through JSON)."""
    return {"keys": out.topk_keys.cpu().numpy().view(np.uint32).tolist(),
            "counts": out.topk_counts.cpu().tolist(),
            "card": out.service_cardinality.cpu().tolist(),
            "ent": out.entropies.cpu().tolist(), "rows": int(out.rows)}


def check_hostpod(torch, dev, windows, flat_out):
    """Phase 11c: the cross-host pod over the simulated DCN. The
    exporter's pod_hosts=2, pod_shards=2 branch on window 0 against
    11a's 4-shard merge of the same rows (the reference's
    test_hostpod_merge_matches_single_pod contract), then marker loss,
    partition with heal and host loss with rejoin on a coordinator."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.parallel import HostPodCoordinator
    from deepflow_tpu_torch.parallel.multihost import route_hosts
    from deepflow_tpu_torch.runtime.faults import default_faults
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    cfg = FlowSuiteConfig()
    planes = list(lane_planes(windows[0], HOSTPOD_BATCH))
    for plane, n in planes:
        per_host = np.bincount(route_hosts(plane, n, 2), minlength=2)
        if per_host.min() < 2 * 8192:
            raise AssertionError(f"cross-host pod: a host slice of "
                                 f"{per_host.min()} rows leaves a shard "
                                 "under mxu_hist.MIN_LANES")
    exp = TpuSketchExporter(cfg=cfg, batch_rows=HOSTPOD_BATCH,
                            window_seconds=3600, pod_shards=2, pod_hosts=2,
                            dcn_transport="sim", pod_merge_deadline_s=60.0,
                            dcn_marker_deadline_s=60.0, device=dev)
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        feed_chunks(exp, windows[0], CHUNK)
        out = exp.flush_window(now=3000.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(
            "cross-host pod", never=("fused_lane_hists", "fused_news_hists"))
        shard_batches = 2 * 2 * len(planes)
        if launches["hist"] != 2 * shard_batches:
            raise AssertionError(f"cross-host pod: {launches['hist']} hist "
                                 f"launches for {shard_batches} shard "
                                 "batches, not 2 per shard batch")
        check_output(torch, out, cfg)
        tags = exp.snapshot_bus.latest().tags
        if tags["pod_hosts_participated"] != 2 or tags["pod_hosts_missing"] \
                or tags["lossy"] or int(out.rows) != len(windows[0]["ip_src"]):
            raise AssertionError(f"cross-host pod: tags {tags}")
        ref = {"out": out_record(out),
               "bus": leaf_hashes(exp.snapshot_bus.latest().leaves)}
    finally:
        exp.close()
    c = conserve(exp.counters(), "cross-host pod closed")
    if c["pod_rows_pending"] or c["pod_rows_delivered"] != c["pod_rows_sent"]:
        raise AssertionError(f"cross-host pod: {c}")
    # the flat 4-shard merge's contract: rows, entropies, the top-K head,
    # and every key both rings hold priced at the same merged count
    flat = out_record(flat_out)
    h = ref["out"]
    if h["rows"] != flat["rows"] or h["keys"][:8] != flat["keys"][:8] \
            or h["counts"][:8] != flat["counts"][:8] \
            or not np.allclose(h["ent"], flat["ent"], rtol=0, atol=1e-5):
        raise AssertionError("cross-host pod: merge differs from the 4-shard "
                             "pod's")
    priced = dict(zip(flat["keys"], flat["counts"]))
    if any(priced.get(k, n) != n for k, n in zip(h["keys"], h["counts"])):
        raise AssertionError("cross-host pod: a key priced differently")
    log(f"  cross-host pod (2 hosts x 2 shards, simulated DCN): "
        f"{len(windows[0]['ip_src']) / dt:.0f} records/s; rows, entropies and "
        f"top-8 = the 4-shard pod's; launches {launches}")

    faults = default_faults()
    fplanes = itertools.cycle(list(lane_planes(windows[1], HOSTPOD_BATCH)))
    co = HostPodCoordinator(cfg, n_hosts=2, shards_per_host=2,
                            transport="sim", device=dev)
    steps = {}

    def put(k):
        for _ in range(k):
            plane, n = next(fplanes)
            co.put_lanes(plane.copy(), n)
        if not co.drain(60):
            raise AssertionError("cross-host pod: hosts did not drain")

    def step(name, res, **want):
        c = conserve(co.counters(), f"cross-host {name}")
        for k, v in want.items():
            if getattr(res, k) != v:
                raise AssertionError(f"cross-host {name}: {k} "
                                     f"{getattr(res, k)} != {v}")
        steps[name] = {k: c[k] for k in (
            "pod_rows_sent", "pod_rows_delivered", "pod_rows_lost",
            "pod_rows_pending", "pod_hosts_missed", "pod_host_late_merges",
            "pod_host_rejoins", "dcn_markers_lost", "dcn_partitions",
            "dcn_heals")}
        log(f"  cross-host {name}: {steps[name]}")
        return c

    zero_launches()
    try:
        put(2)
        step("warm", co.close_epoch(), missed=[])
        faults.arm("dcn.marker_loss", count=1, match="host1")
        put(2)
        c = step("marker loss", co.close_epoch(deadline_s=0.6), missed=[1],
                 lossy=True)
        if c["dcn_markers_lost"] != 1 or c["pod_rows_pending"] == 0:
            raise AssertionError("cross-host: the marker loss was not counted")
        step("marker recovered", co.close_epoch(), missed=[])
        faults.disarm()
        faults.arm("dcn.partition", count=1, match="host1")
        put(2)
        c = step("partition", co.close_epoch(deadline_s=0.6), missed=[1],
                 lossy=True)
        if c["dcn_links_down"] != 1 or c["dcn_held_messages"] < 1:
            raise AssertionError("cross-host: the partition held nothing")
        co.transport.heal(1)
        c = step("healed", co.close_epoch(), missed=[])
        if c["pod_host_late_merges"] < 1:
            raise AssertionError("cross-host: no late merge after the heal")
        faults.disarm()
        put(2)
        if co.snapshot_host(1) <= 0:
            raise AssertionError("cross-host: host 1 closed no rows")
        faults.arm("host.lost", count=1, match="host1")
        res = co.close_epoch(deadline_s=0.6)
        if not res.lossy or not (res.missed == [1] or res.lost == [1]):
            raise AssertionError(f"cross-host host loss: {res}")
        step("host lost", res)
        step("host rejoined", co.close_epoch(), lost=[1])
    finally:
        faults.disarm()
        co.close()
    torch.cuda.synchronize()
    fault_launches = read_launches("cross-host faults")
    c = step("closed", None)
    if c["pod_rows_pending"] or c["pod_host_rejoins"] != 1 \
            or c["pod_rows_delivered"] + c["pod_rows_lost"] \
            != c["pod_rows_sent"] or c["pod_host_late_merges"] < 2:
        raise AssertionError(f"cross-host closed: {c}")
    return {"records_per_s": len(windows[0]["ip_src"]) / dt,
            "launches": launches, "fault_launches": fault_launches,
            "steps": steps}, ref


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def check_dcn_processes(torch, dev, window, ref, tmp):
    """Phase 11d: two processes of this script (`--dcn-worker`), one host
    of 2 shards each on this card, joined over gloo at
    tcp://127.0.0.1:<free port>; each one's merged epoch must equal 11c's
    fault-free merge of the same rows. A child that fails or outlives
    DCN_TIMEOUT_S fails the phase and is killed on the way out."""
    path = os.path.join(tmp, "dcn_planes.npy")
    np.save(path, np.stack([p for p, _ in lane_planes(window,
                                                      HOSTPOD_BATCH)]))
    coord = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    cwd = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dcn-worker", coord,
         str(pid), path, str(dev)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    results = []
    deadline = time.monotonic() + DCN_TIMEOUT_S
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"dcn worker {pid} exit {p.returncode}:"
                                     f"\n{err[-4000:]}")
            line = [x for x in out.splitlines() if x.startswith("RESULT ")]
            if not line:
                raise AssertionError(f"dcn worker {pid}: no result\n{out}")
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches = {}
    for r in results:
        if r["out"] != ref["out"] or r["bus"] != ref["bus"]:
            raise AssertionError(f"dcn worker {r['pid']}: merged epoch "
                                 "differs from the simulated DCN's")
        if r["sent"] != r["delivered"] or r["pending"] \
                or r["participated"] != [0, 1]:
            raise AssertionError(f"dcn worker {r['pid']}: {r}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if sum(r["sent"] for r in results) != len(window["ip_src"]):
        raise AssertionError("dcn workers: rows sent do not add up")
    log(f"  two processes over gloo (TorchDcnTransport): both merged epochs "
        f"= the simulated DCN's, leaf for leaf; {wall:.1f} s wall for both "
        f"(start-up included), in-process "
        f"{[round(r['seconds'], 3) for r in results]} s; launches {launches}")
    return {"wall_s": wall, "worker_seconds": [r["seconds"] for r in results],
            "exchange_s": [r["merge_s"] for r in results],
            "launches": launches}


def dcn_worker(coord, pid, path, device):
    """One host of phase 11d, in a child process on `device` (the
    parent's): load the kernels that the parent built, join the gloo
    group, feed this host's rows of the planes, close one collective
    epoch and print it."""
    import torch
    import torch.distributed as dist

    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.ops import _build
    from deepflow_tpu_torch.parallel import (HostPodCoordinator,
                                             TorchDcnTransport,
                                             init_distributed)
    from deepflow_tpu_torch.parallel.multihost import route_hosts

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        return 2
    pid = int(pid)
    if cuda:
        _build.load_built()
    init_distributed(coord, 2, pid, timeout_s=60)
    co = HostPodCoordinator(FlowSuiteConfig(), n_hosts=2, shards_per_host=2,
                            transport="torch", merge_deadline_s=60.0,
                            device=dev)
    assert isinstance(co.transport, TorchDcnTransport)
    zero_launches()
    t0 = time.perf_counter()
    for plane in np.load(path):
        n = plane.shape[1]
        mine = np.ascontiguousarray(plane[:, route_hosts(plane, n, 2) == pid])
        co.put_lanes(mine, mine.shape[1])
    if not co.drain(60):
        raise AssertionError("dcn worker: shards did not drain")
    res = co.close_epoch()
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches("dcn worker", wants=("hist",) if cuda else ())
    c = conserve(co.counters(), "dcn worker")
    rec = {"pid": pid, "out": out_record(res.out),
           "bus": leaf_hashes(co.bus.latest().leaves),
           "participated": res.participated, "sent": c["pod_rows_sent"],
           "delivered": c["pod_rows_delivered"],
           "pending": c["pod_rows_pending"], "seconds": dt,
           "merge_s": c["pod_merge_epoch_s"], "launches": launches}
    co.close(final_epoch=False)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(rec), flush=True)
    return 0


def check_pod(torch, dev, windows, card, tmp):
    a = check_pod_exporter(torch, dev, windows, card)
    b = walk_pod_ladder(torch, dev, windows)
    c, ref = check_hostpod(torch, dev, windows, a.pop("outs")[0])
    d = check_dcn_processes(torch, dev, windows[0], ref, tmp)
    return {"pod_exporter": a, "ladder": b, "hostpod": c, "dcn": d,
            "launches": [a["launches"], b["launches"], c["launches"],
                         c["fault_launches"], d["launches"]]}

# -- phase 12: the global mesh across processes -------------------------------

# phase 9a's forms that phase 12 runs across processes: cols and lanes
# split each global batch by rows; in the dict form every process passes
# the same full news and hits planes
MESH_FORMS = ("cols", "lanes", "dict")
MESH_WINDOWS = 16          # the ramp windows the metrics suite runs (of 28)
MESH_PROCS, MESH_LOCAL = 2, 2    # processes, shards each: phase 9's 4
MESH_TIMEOUT_S = 150       # the two gloo processes of phase 12, start to end


def save_mesh_inputs(tmp, windows, ref):
    """Phase 9's rows (the flow windows' columns, the app windows, the
    metrics Documents of the first MESH_WINDOWS ramp windows) in one
    uncompressed npz the workers read."""
    arrays = {}
    for w, cols in enumerate(windows):
        arrays.update({f"flow{w}_{k}": cols[k] for k in FLOW_KEYS})
    for w, cols in enumerate(ref["app"]["windows"]):
        arrays.update({f"app{w}_{k}": v for k, v in cols.items()})
    for w, rec in enumerate(ref["metrics"]):
        arrays.update({f"metrics{w}_{k}": v for k, v in rec["docs"].items()})
    path = os.path.join(tmp, "mesh_inputs.npz")
    np.savez(path, **arrays)
    return path


def npz_windows(z, prefix):
    """The per-window column dicts of `prefix` in a save_mesh_inputs npz."""
    out = {}
    for key in z.files:
        if key.startswith(prefix) and key[len(prefix)].isdigit():
            w, col = key[len(prefix):].split("_", 1)
            out.setdefault(int(w), {})[col] = z[key]
    return [out[w] for w in sorted(out)]


def mesh_worker(coord, pid, tmp, device):
    """One process of phase 12, on `device` (the parent's): load the
    kernels that the parent built, join the gloo group, form the global
    mesh of MESH_PROCS x MESH_LOCAL shards, and run the three sharded
    suites on this process's half of every global batch of phase 9's
    rows; print the merged states' hashes, the outputs and the times,
    and save the metrics outputs' arrays beside the inputs."""
    import torch
    import torch.distributed as dist

    from deepflow_tpu_torch.models import app_suite, flow_dict, flow_suite
    from deepflow_tpu_torch.models.metrics_suite import MetricsSuiteConfig
    from deepflow_tpu_torch.ops import _build
    from deepflow_tpu_torch.parallel import (ShardedAppSuite,
                                             ShardedFlowSuite,
                                             ShardedMetricsSuite,
                                             init_distributed, local_shard,
                                             make_global_mesh,
                                             process_local_batch, sharded)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        return 2
    pid = int(pid)
    if cuda:
        _build.load_built()
    init_distributed(coord, MESH_PROCS, pid, timeout_s=60)
    mesh = make_global_mesh(n_local=MESH_LOCAL, device=dev)
    if mesh.shape["data"] != MESH_PROCS * MESH_LOCAL \
            or mesh.local_indices("data") != tuple(
                range(pid * MESH_LOCAL, (pid + 1) * MESH_LOCAL)):
        raise AssertionError(f"mesh worker {pid}: {mesh.shape}, local "
                             f"{mesh.local_indices('data')}")
    z = np.load(os.path.join(tmp, "mesh_inputs.npz"))
    half = SHARD_BATCH // MESH_PROCS
    sl = slice(pid * half, (pid + 1) * half)

    def local(part):
        return {k: v[sl] for k, v in part.items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    rec = {"pid": pid, "flow": {}}
    arrays = {}
    zero_launches()
    # (a) the flow suite: columns through process_local_batch, lanes
    # through put_lanes of this process's columns (the global count n),
    # the dict wire as phase 9 packs it, every process passing the same
    # full news and hits planes (the packer runs in each process)
    cfg = flow_suite.FlowSuiteConfig()
    for form in MESH_FORMS:
        suite = ShardedFlowSuite(cfg, mesh)
        st = suite.init()
        box = {}
        if form == "dict":
            box["tables"] = suite.init_dict(DICT_CAP)
            box["packer"] = flow_dict.FlowDictPacker(capacity=DICT_CAP,
                                                     hits_batch=SHARD_BATCH)
        wins, shards, ingest_s, flush_s, coll = [], [], 0.0, 0.0, []
        for cols in npz_windows(z, "flow"):
            def ingest(st=st, cols=cols):
                for part, mask, n in global_batches(cols):
                    if form == "cols":
                        st = suite.update(st, *process_local_batch(
                            local(part), mask[sl], mesh))
                    elif form == "lanes":
                        lanes = flow_suite.pack_lanes(local(part))
                        st = suite.update_lanes(st, suite.put_lanes(np.stack(
                            [lanes[k] for k in flow_suite.SKETCH_LANE_NAMES]
                        )), n)
                    else:
                        packer = box["packer"]
                        for kind, plane, m in packer.pack(
                                {k: v[:n] for k, v in part.items()}) \
                                + packer.flush():
                            if kind == "news":
                                st, box["tables"] = suite.update_news(
                                    st, box["tables"], plane, m)
                            else:
                                st = suite.update_hits(st, box["tables"],
                                                       plane, m)
                return st
            st, dt = timed(ingest)
            ingest_s += dt
            merged = sharded._merge_axis0(st, suite._comm)
            wins.append({"leaves": leaf_hashes(snapshot(merged))})
            if form == "dict":
                shards.append({
                    "shards": [leaf_hashes(snapshot(x)) for x in st],
                    "tables": [leaf_hashes([t.table.cpu().numpy()])
                               for t in box["tables"]]})
            c0 = suite.collectives["seconds"]["flush"]
            (st, out), dt = timed(lambda st=st: suite.flush(st))
            flush_s += dt
            coll.append(suite.collectives["seconds"]["flush"] - c0)
            wins[-1]["out"] = out_record(out)
        rec["flow"][form] = {"windows": wins, "ingest_s": ingest_s,
                             "flush_s": flush_s, "collective_flush_s": coll,
                             "shards": shards}
    # (b) the app suite
    acfg = app_suite.AppSuiteConfig()
    asuite = ShardedAppSuite(acfg, mesh)
    ast = asuite.init()
    app_outs, app_s = [], 0.0
    for cols in npz_windows(z, "app"):
        def run(ast=ast, cols=cols):
            for part, mask, _ in global_batches(cols):
                ast = asuite.update(ast, *process_local_batch(
                    local(part), mask[sl], mesh))
            return asuite.flush(ast)
        (ast, out), dt = timed(run)
        app_s += dt
        app_outs.append(leaf_hashes([t.cpu().numpy() for t in out]))
    rec["app"] = {"outs": app_outs, "seconds": app_s,
                  "collectives": asuite.collectives}
    # (c) the metrics suite over the first MESH_WINDOWS ramp windows
    msuite = ShardedMetricsSuite(MetricsSuiteConfig(), mesh)
    ms = msuite.init()
    pre, alarms, metrics_s = [], [], 0.0
    for w, docs in enumerate(npz_windows(z, "metrics")):
        batches = list(global_batches(docs))

        def ingest(ms=ms, batches=batches):
            for part, mask, _ in batches:
                ms = msuite.update(ms, *process_local_batch(
                    local(part), mask[sl], mesh))
            return ms
        ms, dt = timed(ingest)
        metrics_s += dt
        pre.append(metrics_int_hashes(ms))
        last, mask, _ = batches[-1]
        last_d = process_local_batch(local(last), mask[sl], mesh)
        (ms, out), dt = timed(lambda ms=ms: msuite.flush(ms, *last_d))
        metrics_s += dt
        got = metrics_record(out, ms[0].pca.w)
        got["scores"] = local_shard(out.anomaly_scores)
        alarms.append(got.pop("alarm"))
        arrays.update({f"{k}{w}": v for k, v in got.items()})
    rec["metrics"] = {"pre": pre, "alarms": alarms, "seconds": metrics_s,
                      "collectives": msuite.collectives}
    if cuda:
        rec["profiles"] = profile_mesh_windows(
            torch, dev, z, local, sl, mesh, cfg, MetricsSuiteConfig())
    rec["launches"] = read_launches(
        f"mesh worker {pid}", wants=("hist",) if cuda else (),
        never=("fused_lane_hists", "fused_news_hists"))
    np.savez(os.path.join(tmp, f"mesh_out{pid}.npz"), **arrays)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(rec), flush=True)
    return 0


def profile_mesh_windows(torch, dev, z, local, sl, mesh, cfg, mcfg):
    """In a mesh worker: one window of the flow suite's columns form and
    the first ramp window of the metrics suite, each under
    torch.profiler in two sessions (ingest, flush), as phase 9 profiles
    them; both processes run the same collectives."""
    from deepflow_tpu_torch.parallel import (ShardedFlowSuite,
                                             ShardedMetricsSuite,
                                             process_local_batch)
    out = {}
    for name, suite, docs in (
            ("flow", ShardedFlowSuite(cfg, mesh), npz_windows(z, "flow")[0]),
            ("metrics", ShardedMetricsSuite(mcfg, mesh),
             npz_windows(z, "metrics")[0])):
        batches = list(global_batches(docs))
        box = {"st": suite.init()}

        def ingest(suite=suite, batches=batches, box=box):
            for part, mask, _ in batches:
                box["st"] = suite.update(box["st"], *process_local_batch(
                    local(part), mask[sl], mesh))
        last, mask, _ = batches[-1]
        extra = () if name == "flow" else process_local_batch(
            local(last), mask[sl], mesh)
        ingest_p, flush_p = profile_window(
            torch, dev, ingest,
            lambda suite=suite, box=box, extra=extra: suite.flush(
                box["st"], *extra))
        out[name] = {"ingest": ingest_p, "flush": flush_p,
                     "global_batches": len(batches)}
    return out


def run_mesh_workers(dev, tmp):
    """The MESH_PROCS workers on a free 127.0.0.1 port; a child that fails
    or outlives MESH_TIMEOUT_S fails the phase and is killed on the way
    out. Returns (their RESULT records, wall seconds)."""
    coord = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    cwd = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", coord,
         str(pid), tmp, str(dev)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(MESH_PROCS)]
    results = []
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"mesh worker {pid} exit "
                                     f"{p.returncode}:\n{err[-4000:]}")
            line = [x for x in out.splitlines() if x.startswith("RESULT ")]
            if not line:
                raise AssertionError(f"mesh worker {pid}: no result\n{out}")
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, time.perf_counter() - t0


def check_global_mesh(torch, dev, windows, ref, tmp, card):
    """Phase 12: the three sharded suites over a global mesh of
    MESH_PROCS processes x MESH_LOCAL shards on this card, against phase
    9's single-process 4-shard runs on the same rows (`ref`): the flow
    suite's merged leaves and outputs equal at every window close, in
    both forms and both processes, recall >= 0.99; the app outputs
    equal; the metrics suite's per-shard integer leaves equal at every
    window close, alarms equal, entropies within abs 1e-5, z within rtol
    1e-5, each process's anomaly scores (its own rows, `local_shard`)
    and the PCA projector within rtol 1e-4, the matrix-profile sum
    within rel 1e-4."""
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    save_mesh_inputs(tmp, windows, ref)
    results, wall = run_mesh_workers(dev, tmp)
    k = FlowSuiteConfig().top_k
    records = sum(len(w["ip_src"]) for w in windows)
    app_records = sum(len(c["rrt_us"]) for c in ref["app"]["windows"])
    metric_records = sum(len(next(iter(m["docs"].values())))
                         for m in ref["metrics"])
    report, launches = {"wall_s": wall}, {}
    for r in results:
        pid = r["pid"]
        for form in MESH_FORMS:
            got = r["flow"][form]
            if got["windows"] != ref["flow"][form]:
                raise AssertionError(f"mesh worker {pid} {form}: merged "
                                     "leaves or outputs differ from phase 9")
            recalls = [len(set(wi["out"]["keys"]) & exact_topk(cols, k)) / k
                       for wi, cols in zip(got["windows"], windows)]
            if min(recalls) < 0.99:
                raise AssertionError(f"mesh {form}: recall {recalls}")
        # the dict form: this process's shards are phase 9's shards
        # [pid * MESH_LOCAL, (pid + 1) * MESH_LOCAL), leaf for leaf, and
        # every table replica is phase 9's table
        for w, (got, want) in enumerate(zip(r["flow"]["dict"]["shards"],
                                            ref["flow"]["dict_shards"])):
            if got["shards"] != want["shards"][
                    pid * MESH_LOCAL:(pid + 1) * MESH_LOCAL] \
                    or any(t != want["table"] for t in got["tables"]):
                raise AssertionError(f"mesh worker {pid} dict window {w}: a "
                                     "shard's leaves or a table replica "
                                     "differ from phase 9")
        if r["app"]["outs"] != ref["app"]["outs"]:
            raise AssertionError(f"mesh worker {pid}: app outputs differ "
                                 "from phase 9")
        out = np.load(os.path.join(tmp, f"mesh_out{pid}.npz"))
        for w, want in enumerate(ref["metrics"]):
            if r["metrics"]["pre"][w] != \
                    want["pre"][pid * MESH_LOCAL:(pid + 1) * MESH_LOCAL]:
                raise AssertionError(f"mesh worker {pid} metrics window {w}:"
                                     " integer leaves differ from phase 9")
            if r["metrics"]["alarms"][w] != want["alarm"]:
                raise AssertionError(f"mesh worker {pid} window {w}: alarm")
            n = len(want["scores"]) // MESH_PROCS
            for name, b, tol in (
                    ("entropies", want["entropies"], dict(rtol=0, atol=1e-5)),
                    ("z", want["z"], dict(rtol=1e-5, atol=1e-6)),
                    ("scores", want["scores"][pid * n:(pid + 1) * n],
                     dict(rtol=1e-4, atol=1e-5)),
                    ("projector", want["projector"],
                     dict(rtol=1e-4, atol=1e-5))):
                np.testing.assert_allclose(
                    out[f"{name}{w}"], b, err_msg=f"mesh worker {pid} "
                    f"window {w}: {name}", **tol)
            a, b = float(out[f"mp{w}"].sum()), float(want["mp"].sum())
            if abs(a - b) > 1e-4 * abs(b) + 1e-6:
                raise AssertionError(f"mesh worker {pid} window {w}: mp sum "
                                     f"{a} against {b}")
        for kname, v in r["launches"].items():
            launches[kname] = launches.get(kname, 0) + v
        m = r["metrics"]["collectives"]
        report[pid] = {
            "flow_records_per_s": {
                f: records / (r["flow"][f]["ingest_s"]
                              + r["flow"][f]["flush_s"])
                for f in MESH_FORMS},
            "flow_flush_ms": {f: 1e3 * r["flow"][f]["flush_s"] / len(windows)
                              for f in MESH_FORMS},
            "flow_collective_per_flush_ms": {
                f: [1e3 * x for x in r["flow"][f]["collective_flush_s"]]
                for f in MESH_FORMS},
            "app_seconds": r["app"]["seconds"],
            "app_records_per_s": app_records / r["app"]["seconds"],
            "metrics_records_per_s": metric_records
            / r["metrics"]["seconds"],
            "app_collective_ms": 1e3 * r["app"]["collectives"]["seconds"][
                "flush"],
            "metrics_seconds": r["metrics"]["seconds"],
            "metrics_update_collective_ms": 1e3 * m["seconds"]["update"]
            / max(1, m["calls"]["update"]),
            "metrics_updates": m["calls"]["update"],
            "metrics_flush_collective_ms": 1e3 * m["seconds"]["flush"]
            / max(1, m["calls"]["flush"]),
        }
        for name, pr in r.get("profiles", {}).items():
            report[pid][f"{name}_profile"] = report_profile(
                f"mesh worker {pid} {name} (one window)", pr["ingest"],
                pr["flush"], pr["global_batches"], card)
        p = report[pid]
        log(f"  mesh worker {pid} on {card}: flow records/s "
            + ", ".join(f"{f} {p['flow_records_per_s'][f]:.0f}"
                        for f in MESH_FORMS)
            + "; flow flush " + ", ".join(
                f"{f} {p['flow_flush_ms'][f]:.2f} ms (collectives "
                f"{np.round(p['flow_collective_per_flush_ms'][f], 2).tolist()}"
                " ms)" for f in MESH_FORMS)
            + f"; app {p['app_records_per_s']:.0f} records/s "
            f"({p['app_seconds']:.3f} s; collective "
            f"{p['app_collective_ms']:.2f} ms over {len(ref['app']['outs'])}"
            f" flushes); metrics {p['metrics_records_per_s']:.0f} records/s "
            f"({p['metrics_seconds']:.3f} s), per-update "
            f"gradient sum {p['metrics_update_collective_ms']:.3f} ms over "
            f"{p['metrics_updates']} updates, flush sums "
            f"{p['metrics_flush_collective_ms']:.3f} ms per collective")
    report["launches"] = launches
    log(f"  the global mesh ({MESH_PROCS} processes x {MESH_LOCAL} shards "
        f"over gloo): flow ({', '.join(MESH_FORMS)}) merged leaves and "
        f"outputs = phase 9 at both window closes in both processes, app "
        f"outputs = phase 9, metrics integer leaves = phase 9 and floats "
        f"within tolerance over {len(ref['metrics'])} windows; {wall:.1f} s "
        f"wall for both (start-up included); launches {launches}")
    return report


# -- phase 13: the ingester entry point --------------------------------------

ING_TAGGED = 1 << 16       # window 0's first records, as TAGGEDFLOW protobuf
ING_L7 = 1 << 16           # phase 8's l7 requests, as PROTOCOLLOG (cut
#                            from 2^17 for time)
ING_DOC_TUPLES = 2048      # phase 10's tag tuples x seconds: 2^16 Documents,
ING_DOC_SECONDS = 32       # as METRICS (cut from 64 s for time)
ING_PB_PER_FRAME = 1024    # protobuf records per frame
ING_COL_PER_FRAME = 1024   # planar L4 rows per COLUMNAR_FLOW frame (~459 KB)
ING_VTAPS = 4              # (b), (c): connections, one vtap_id each
ING_PROFILED_FRAMES = 128  # (b), (c): window 1's first planar frames, profiled
#                            (cut from 256 for time; phase 15 (b) too)
ING_AUTOTUNE_S = 0.25
ING_STAGES = ("receiver", "decode", "queue.ingest.l4_flow_log",
              "queue.exporter.tpu_sketch", "kernel.h2d", "kernel.dispatch",
              "kernel.device")
ING_NOWS = (3000.0, 3001.0)


def l4_wide(rng, cols, second):
    """Phase 3's rows as L4_SCHEMA columns: the drawn columns as they
    are, `timestamp` the given second, v4 rows, every other column from
    the seed."""
    from deepflow_tpu_torch.batch.schema import L4_SCHEMA
    n = len(cols["ip_src"])
    out = {}
    for name, dt in L4_SCHEMA.columns:
        dt = np.dtype(dt)
        if name in cols:
            out[name] = cols[name].astype(dt)
        elif name == "timestamp":
            out[name] = np.full(n, second, dt)
        elif name in ("_id", "is_ipv6"):
            out[name] = np.zeros(n, dt)
        elif dt.itemsize == 8:
            out[name] = rng.integers(0, 1 << 48, n, dtype=np.uint64)
        else:
            out[name] = rng.integers(0, 1 << 16, n).astype(dt)
    return out


def l4_pb_records(wide, lo, hi):
    """TaggedFlow records (the reference agent's wire) of rows [lo, hi)."""
    from deepflow_tpu_torch.wire.gen import flow_log_pb2
    c = {k: wide[k][lo:hi].tolist() for k in (
        "ip_src", "ip_dst", "port_src", "port_dst", "proto", "vtap_id",
        "mac_src", "mac_dst", "packet_tx", "packet_rx", "byte_tx",
        "byte_rx", "l3_epc_id", "l3_epc_id_1", "flow_id", "timestamp",
        "duration_us", "close_type", "tap_side", "rtt", "retrans")}
    out = []
    for i in range(hi - lo):
        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        k = f.flow_key
        k.ip_src, k.ip_dst = c["ip_src"][i], c["ip_dst"][i]
        k.port_src, k.port_dst = c["port_src"][i], c["port_dst"][i]
        k.proto, k.vtap_id = c["proto"][i], c["vtap_id"][i]
        k.mac_src, k.mac_dst = c["mac_src"][i], c["mac_dst"][i]
        s, d = f.metrics_peer_src, f.metrics_peer_dst
        s.packet_count, d.packet_count = c["packet_tx"][i], c["packet_rx"][i]
        s.byte_count, d.byte_count = c["byte_tx"][i], c["byte_rx"][i]
        s.l3_epc_id, d.l3_epc_id = c["l3_epc_id"][i], c["l3_epc_id_1"][i]
        f.flow_id = c["flow_id"][i]
        f.start_time = c["timestamp"][i] * 1_000_000_000
        f.duration = c["duration_us"][i] * 1000
        f.close_type, f.tap_side = c["close_type"][i], c["tap_side"][i]
        f.perf_stats.tcp.rtt = c["rtt"][i]
        f.perf_stats.tcp.total_retrans_count = c["retrans"][i]
        out.append(m.SerializeToString())
    return out


def l7_pb_records(rng, cols, second):
    """AppProtoLogsData records of phase 8's l7 requests: the RED
    columns as drawn (rrt in ns on the wire), clients, endpoints and
    trace ids from the seed."""
    from deepflow_tpu_torch.wire.gen import flow_log_pb2
    n = len(cols["rrt_us"])
    c = {k: cols[k].tolist() for k in ("ip_dst", "port_dst", "protocol",
                                       "status", "rrt_us")}
    src = (0x0A000000 + rng.integers(0, 1 << 20, n)).tolist()
    ep = rng.integers(0, 256, n).tolist()
    out = []
    for i in range(n):
        m = flow_log_pb2.AppProtoLogsData()
        b = m.base
        b.start_time = second * 1_000_000_000 + i
        b.ip_src, b.ip_dst = src[i], c["ip_dst"][i]
        b.port_dst, b.protocol = c["port_dst"][i], c["protocol"][i]
        b.head.proto = 20
        b.head.rrt = c["rrt_us"][i] * 1000
        m.req.endpoint = f"/api/v1/item/{ep[i]}"
        m.resp.status = c["status"][i]
        m.trace_info.trace_id = f"{src[i]:08x}{i:08x}"
        out.append(m.SerializeToString())
    return out


def doc_pb_records(cols):
    """metric Documents of phase 10's rows: every tag dimension and meter
    of the METRIC_SCHEMA row on its protobuf field; the two hashed
    strings become names (the decoder hashes them again)."""
    from deepflow_tpu_torch.batch.schema import METRIC_SCHEMA
    from deepflow_tpu_torch.wire.gen import metric_pb2
    tags = {"server_port": "server_port", "vtap_id": "vtap_id",
            "protocol": "protocol", "l3_epc_id": "l3_epc_id",
            "direction": "direction", "tap_side": "tap_side",
            "tap_type": "tap_type", "tap_port": "tap_port",
            "l7_protocol": "l7_protocol", "gprocess_id": "gpid",
            "signal_source": "signal_source", "pod_id": "pod_id"}
    flow = metric_pb2.FlowMeter.DESCRIPTOR
    meters = []
    for name, _ in METRIC_SCHEMA.columns:
        for sub in ("traffic", "latency", "performance", "anomaly"):
            if name in flow.fields_by_name[sub].message_type.fields_by_name:
                meters.append((sub, name))
    lists = {k: cols[k].tolist() for k in
             list(tags) + [m for _, m in meters]
             + ["timestamp", "tag_code", "ip", "app_service_hash",
                "endpoint_hash"]}
    out = []
    for i in range(len(cols["timestamp"])):
        d = metric_pb2.Document()
        d.timestamp = lists["timestamp"][i]
        d.tag.code = lists["tag_code"][i]
        fld = d.tag.field
        fld.ip = lists["ip"][i].to_bytes(4, "big")
        for col, field in tags.items():
            setattr(fld, field, lists[col][i])
        fld.app_service = f"svc-{lists['app_service_hash'][i] % 512}"
        fld.endpoint = f"/ep/{lists['endpoint_hash'][i] % 4096}"
        fm = d.meter.flow
        for sub, name in meters:
            setattr(getattr(fm, sub), name, lists[name][i])
        out.append(d.SerializeToString())
    return out


class FrameSequencer:
    """Wire frames with the sequence numbers an agent gives them: one
    counter per (vtap_id, message type)."""

    def __init__(self):
        self.seq = {}

    def frame(self, msg_type, payload, vtap):
        from deepflow_tpu_torch.wire import FlowHeader, encode_frame
        key = (vtap, int(msg_type))
        self.seq[key] = self.seq.get(key, 0) + 1
        return encode_frame(msg_type, payload,
                            FlowHeader(sequence=self.seq[key], vtap_id=vtap))

    def pb(self, msg_type, records, vtap=1):
        from deepflow_tpu_torch.wire import pack_pb_records
        return [self.frame(msg_type,
                           pack_pb_records(records[s:s + ING_PB_PER_FRAME]),
                           vtap)
                for s in range(0, len(records), ING_PB_PER_FRAME)]

    def columnar(self, wide, lo, hi, vtap=1):
        from deepflow_tpu_torch.wire import MessageType
        from deepflow_tpu_torch.wire.columnar_wire import encode_columnar
        return [self.frame(MessageType.COLUMNAR_FLOW, encode_columnar(
            {k: v[s:min(hi, s + ING_COL_PER_FRAME)] for k, v in wide.items()}),
            vtap) for s in range(lo, hi, ING_COL_PER_FRAME)]

    def revtap(self, frames, n_vtaps):
        """The same frames spread over `n_vtaps` agents round robin, each
        agent's sequence its own; [frames of agent v]."""
        import struct
        out = [[] for _ in range(n_vtaps)]
        for j, f in enumerate(frames):
            v = j % n_vtaps
            key = (v + 1, f[4])
            self.seq[key] = self.seq.get(key, 0) + 1
            out[v].append(f[:9] + struct.pack("<QH", self.seq[key], v + 1)
                          + f[19:])
        return out


def ingester_traffic(rng, windows):
    """(a)'s frames: per l4 window [TAGGEDFLOW frames, COLUMNAR_FLOW
    frames] (window 0 starts with ING_TAGGED protobuf records, the rest
    planar), phase 8's l7 requests and phase 10's Documents, with the
    source columns and the build time."""
    from deepflow_tpu_torch.pipelines.tag_code import VTAP_FLOW_PORT
    from deepflow_tpu_torch.wire import MessageType
    t0 = time.perf_counter()
    second = int(time.time())
    seqr = FrameSequencer()
    l4 = []
    for w, cols in enumerate(windows):
        wide = l4_wide(rng, cols, second + w)
        n = len(wide["ip_src"])
        k = ING_TAGGED if w == 0 else 0
        l4.append((seqr.pb(MessageType.TAGGEDFLOW,
                           l4_pb_records(wide, 0, k)),
                   seqr.columnar(wide, k, n)))
    pool, p = red_pool(rng)
    l7_cols = red_window(rng, pool, p, ING_L7)
    l7 = seqr.pb(MessageType.PROTOCOLLOG,
                 l7_pb_records(rng, l7_cols, second))
    doc_t0 = (int(time.time()) // 3600 + 2) * 3600   # ahead: the ticker waits
    docs = fm_rows(rng, doc_t0, fm_tuples(rng, ING_DOC_TUPLES),
                   seconds=ING_DOC_SECONDS)
    docs["tag_code"][:] = int(VTAP_FLOW_PORT)
    metrics = seqr.pb(MessageType.METRICS, doc_pb_records(docs))
    return {"l4": l4, "l7": l7, "l7_cols": l7_cols, "metrics": metrics,
            "doc_t0": doc_t0, "seq": seqr,
            "build_s": time.perf_counter() - t0}


def decode_frames(frames, platform, l7_dict=None):
    """The yardstick's decode of a run of frames, frame by frame, in
    order: the port's decoders, the ingester's PlatformDataManager and
    row ids. Yields (stream, cols)."""
    from deepflow_tpu_torch.decode import columnar
    from deepflow_tpu_torch.pipelines.flow_log import stamp_row_ids
    from deepflow_tpu_torch.wire import FrameReader, MessageType
    from deepflow_tpu_torch.wire.codec import iter_pb_records
    from deepflow_tpu_torch.wire.columnar_wire import decode_columnar
    reader = FrameReader()
    for raw in frames:
        for f in reader.feed(raw):
            if f.msg_type == MessageType.COLUMNAR_FLOW:
                cols, bad = decode_columnar(f.payload)
            elif f.msg_type == MessageType.TAGGEDFLOW:
                cols, bad = columnar.decode_l4_records(
                    list(iter_pb_records(f.payload))), 0
            elif f.msg_type == MessageType.PROTOCOLLOG:
                cols = columnar.decode_l7_records(
                    list(iter_pb_records(f.payload)), endpoint_dict=l7_dict)
                yield "l7_flow_log", stamp_row_ids(platform.stamp_l7(cols))
                continue
            else:
                yield "flow_metrics", columnar.decode_metric_records(
                    list(iter_pb_records(f.payload)))
                continue
            if bad:
                raise AssertionError("the yardstick could not decode a frame")
            yield "l4_flow_log", stamp_row_ids(platform.stamp_l4(cols))


def wait_for(fn, what, timeout=300):
    deadline = time.monotonic() + timeout
    while not fn():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 13: timed out waiting for {what}")
        time.sleep(0.001)


def send_all(port, frames):
    """One agent connection: every frame, in order, then close."""
    import socket
    with socket.create_connection(("127.0.0.1", port)) as s:
        for f in frames:
            s.sendall(f)


def send_parallel(port, per_conn):
    """One connection per frame list, all sending at once."""
    errs = []

    def run(frames):
        try:
            send_all(port, frames)
        except Exception as e:       # noqa: BLE001 -- re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(f,)) for f in per_conn]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def ingester_config(root, surface=True, **kw):
    """Phase 13's ingester: the exporter defaults with the anomaly plane
    and a store. `surface`: the operations surface on its defaults (the
    timeline at IngesterConfig's 1.0 s with its SLO rules, the
    Prometheus and debug listeners on ephemeral ports, a spill and an
    incident directory under `root`); else the timeline off and no
    listener, spill or recorder."""
    from deepflow_tpu_torch.pipelines import IngesterConfig
    ops = dict(prom_port=0, debug_port=0,
               spill_dir=os.path.join(root, "spill"),
               incident_dir=os.path.join(root, "incidents")) if surface \
        else dict(timeline_sample_s=0)
    return IngesterConfig(**{**dict(
        listen_port=0, store_path=root, tpu_sketch_window_s=3600,
        app_red_window_s=3600, anomaly_enabled=True), **ops, **kw})


def probe_surface(ing, name):
    """The operations surface of a running ingester: one strict
    validate_exposition of a /metrics scrape, a /healthz read, UDP round
    trips of `counters`, `queues`, `breakers` and `spill`."""
    import urllib.error
    import urllib.request

    from deepflow_tpu_torch.runtime.debug import debug_request
    from deepflow_tpu_torch.runtime.promexpo import validate_exposition
    base = f"http://127.0.0.1:{ing.prom_port}"
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        body = r.read().decode()
    problems = validate_exposition(body)
    if problems:
        raise AssertionError(f"{name}: /metrics is not valid: {problems[:5]}")
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            code, health = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, health = e.code, json.loads(e.read())
    if code != (200 if health.get("ok") else 503) \
            or "slo_burning" not in health:
        raise AssertionError(f"{name}: /healthz {code} {health}")
    replies = {}
    for cmd, kw in (("counters", {"module": "exporter.tpu_sketch"}),
                    ("queues", {}), ("breakers", {}), ("spill", {})):
        rep = debug_request(cmd, port=ing.debug.port, timeout=10, **kw)
        if not rep.get("ok"):
            raise AssertionError(f"{name}: debug {cmd}: {rep}")
        replies[cmd] = rep["data"]
    if ("rows_in" not in replies["counters"].get("exporter.tpu_sketch", {})
            or "ingest.l4_flow_log" not in replies["queues"]
            or "tpu_sketch" not in replies["breakers"]
            or replies["spill"].get("enabled") is not True):
        raise AssertionError(f"{name}: debug replies {replies}")
    tl = ing.timeline.counters()
    if tl["ticks"] < 1 or tl["rule_errors"]:
        raise AssertionError(f"{name}: timeline {tl}")
    return {"metrics_lines": len(body.splitlines()),
            "metrics_bytes": len(body), "healthz": code,
            "slo_burning": health["slo_burning"], "timeline": tl,
            "spilled": sum(q["spilled"] for q in replies["queues"].values())}


def yardstick(dev, cfg):
    """The directly fed exporters: the ingester's configuration, no store
    and no checkpoint directory (neither touches the state)."""
    from deepflow_tpu_torch.anomaly import AnomalyConfig
    from deepflow_tpu_torch.runtime.app_red import AppRedExporter
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
    sketch = TpuSketchExporter(
        window_seconds=3600, wire=cfg.tpu_sketch_wire,
        prefetch_depth=cfg.prefetch_depth,
        coalesce_batches=cfg.coalesce_batches, zero_copy=cfg.zero_copy,
        pack_workers=cfg.pack_workers, audit_rate=cfg.audit_sample_rate,
        anomaly=AnomalyConfig(active_log2=cfg.anomaly_active_log2,
                              entropy_z=cfg.anomaly_entropy_z,
                              pca_z=cfg.anomaly_pca_z,
                              mp_threshold=cfg.anomaly_mp_threshold,
                              warmup_windows=cfg.anomaly_warmup_windows),
        device=dev)
    red = AppRedExporter(window_seconds=3600, device=dev)
    return sketch, red


def decoder(ing, stream):
    return next(d for d in ing.flow_log.decoders if d.stream == stream)


def assert_native_registered(ing, name):
    """Every l4 decoder of the ingester decodes TAGGEDFLOW frames with the
    native walker (decode/native.py, built in phase 1)."""
    from deepflow_tpu_torch.decode import native
    from deepflow_tpu_torch.wire import MessageType
    l4 = [d for d in ing.flow_log.decoders if d.stream == "l4_flow_log"]
    if not l4 or any(d.payload_decode_fns.get(MessageType.TAGGEDFLOW)
                     is not native.decode_l4_payload for d in l4):
        raise AssertionError(f"phase 13 {name}: an l4 decoder has no native "
                             "TAGGEDFLOW fast path")


NATIVE_THREADS = (1, 4)


def check_native_decode(frames, card):
    """Phase 13: the TAGGEDFLOW frames' payloads through the Python
    decoder and the native walker at 1 and 4 threads: columns equal,
    dtype for dtype and bit for bit, no bad record; records/s of each
    (host numbers: the card host's CPU)."""
    from deepflow_tpu_torch.decode import columnar, native
    from deepflow_tpu_torch.wire import FrameReader
    from deepflow_tpu_torch.wire.codec import iter_pb_records
    reader = FrameReader()
    payloads = [f.payload for raw in frames for f in reader.feed(raw)]
    t0 = time.perf_counter()
    want = [columnar.decode_l4_records(list(iter_pb_records(p)))
            for p in payloads]
    dt = time.perf_counter() - t0
    records = sum(len(c["ip_src"]) for c in want)
    rates = {"python": records / dt}
    for threads in NATIVE_THREADS:
        t0 = time.perf_counter()
        got = [native.decode_l4_payload(p, n_threads=threads)
               for p in payloads]
        dt = time.perf_counter() - t0
        rates[f"native_x{threads}"] = records / dt
        for (cols, bad), ref in zip(got, want):
            if bad or sorted(cols) != sorted(ref) or any(
                    cols[k].dtype != ref[k].dtype
                    or not np.array_equal(cols[k], ref[k]) for k in ref):
                raise AssertionError(f"phase 13: the native decoder "
                                     f"({threads} threads) differs from "
                                     "the Python decoder")
    log(f"  TAGGEDFLOW decode of {records} records in {len(payloads)} "
        f"frames on the host of {card}: native columns = the Python "
        f"decoder's at 1 and 4 threads; records/s "
        + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
        + f" (native x1 / python {rates['native_x1'] / rates['python']:.1f})")
    return {"records": records, "records_per_s": rates}


def check_ingester_identity(torch, dev, traffic, windows, tmp, card):
    """Phase 13(a): one decoder, one connection; the socket-fed ingester
    against the directly fed yardstick, hop-by-hop conservation."""
    import socket

    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.pipelines import Ingester
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    from deepflow_tpu_torch.store.db import Store
    from deepflow_tpu_torch.store.dict_store import TagDict

    cfg = ingester_config(os.path.join(tmp, "a"), n_decoders=1)
    ing = Ingester(cfg, device=dev)
    assert_native_registered(ing, "(a)")
    y_sketch, y_red = yardstick(dev, cfg)
    counters = launch_counters()
    i_snaps, y_snaps = bus_snapshots(ing.tpu_sketch), bus_snapshots(y_sketch)
    i_planes, y_planes, i_outs, y_outs = [], [], [], []
    l4, l7 = decoder(ing, "l4_flow_log"), decoder(ing, "l7_flow_log")
    frames_sent = 0
    n_docs = ING_DOC_TUPLES * ING_DOC_SECONDS
    l7_dict = TagDict()
    try:
        ing.start()
        y_sketch.start()
        y_red.start()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t_first = time.perf_counter()
        conn = socket.create_connection(("127.0.0.1", ing.port))
        try:
            for w, (tagged, planar) in enumerate(traffic["l4"]):
                before = sum(len(x["ip_src"]) for x in windows[:w])
                # one wire at a time: a decoder batch of mixed frames
                # decodes its planar frames first
                for f in tagged:
                    conn.sendall(f)
                if tagged:
                    wait_for(lambda: l4.records == before + ING_TAGGED,
                             "the TAGGEDFLOW decode")
                for f in planar:
                    conn.sendall(f)
                frames_sent += len(tagged) + len(planar)
                n = before + len(windows[w]["ip_src"])
                wait_for(lambda: ing.tpu_sketch.rows_in == n,
                         "the sketch exporter")
                i_outs.append(ing.tpu_sketch.flush_window(now=ING_NOWS[w]))
                torch.cuda.synchronize()
                i_planes.append(convert.anomaly_to_numpy(
                    ing.tpu_sketch.anomaly.state))
            t_l4 = time.perf_counter() - t_first
            for f in traffic["l7"]:
                conn.sendall(f)
            frames_sent += len(traffic["l7"])
            wait_for(lambda: ing.app_red.rows_in == ING_L7, "the RED exporter")
            i_red = ing.app_red.flush_window(now=ING_NOWS[0])
            for f in traffic["metrics"]:
                conn.sendall(f)
            frames_sent += len(traffic["metrics"])
            wait_for(lambda: ing.flow_metrics.records == n_docs,
                     "the unmarshaller")
        finally:
            conn.close()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        # the yardstick: the same frames decoded here, in the same order
        y_docs = []
        for w, segments in enumerate(traffic["l4"]):
            for frames in segments:
                for _, cols in decode_frames(frames, ing.platform):
                    y_sketch.put("l4_flow_log", 0, cols)
            n = sum(len(x["ip_src"]) for x in windows[:w + 1])
            wait_for(lambda: y_sketch.rows_in == n, "the yardstick sketch")
            y_outs.append(y_sketch.flush_window(now=ING_NOWS[w]))
            torch.cuda.synchronize()
            y_planes.append(convert.anomaly_to_numpy(y_sketch.anomaly.state))
        for _, cols in decode_frames(traffic["l7"], ing.platform, l7_dict):
            y_red.put("l7_flow_log", 0, cols)
        wait_for(lambda: y_red.rows_in == ING_L7, "the yardstick RED")
        y_red_out = y_red.flush_window(now=ING_NOWS[0])
        for _, cols in decode_frames(traffic["metrics"], ing.platform):
            y_docs.append(cols)
        torch.cuda.synchronize()
        ing.flush()
        # the writers' own threads may still be writing what they took
        tables = {w.table.schema.name: w.table for w in ing.flow_log.writers
                  if w.table.schema.name in ("l4_flow_log", "l7_flow_log")}
        emitted = {s: sum(d.throttler.counters()["emitted"]
                          for d in ing.flow_log.decoders if d.stream == s)
                   for s in tables}
        base = ing.flow_metrics.rollups.base
        wait_for(lambda: all(tables[s].rows_written >= emitted[s]
                             for s in tables)
                 and base.rows_written >= n_docs, "the store writers")
        rollups = ing.flow_metrics.rollups
        # every minute the Documents touch is complete
        rollups.advance(traffic["doc_t0"] + -(-ING_DOC_SECONDS // 60) * 60
                        + rollups.allowance)
        rc = ing.receiver.counters()
        dc = {d.stream: d.counters() for d in ing.flow_log.decoders}
        ec = ing.exporters.counters()
        chunks = ing.tpu_sketch.processed + ing.app_red.processed
        sampled = {s: sum(d.throttler.counters()["sampled_out"]
                          for d in ing.flow_log.decoders if d.stream == s)
                   for s in ("l4_flow_log", "l7_flow_log")}
        store = Store(cfg.store_path)
        stored = {s: store.table("flow_log", s).row_count()
                  for s in ("l4_flow_log", "l7_flow_log")}
        tier = store.table("flow_metrics", METRICS_TABLE.name + ".1m").scan()
        sc = ing.tpu_sketch.counters()
        alerts = (list(ing.tpu_sketch.anomaly.alerts_total),
                  list(y_sketch.anomaly.alerts_total))
    finally:
        ing.close()
        y_sketch.close()
        y_red.close()
    l4_rows = sum(len(x["ip_src"]) for x in windows)
    compare_snaps(i_snaps[:len(windows)], y_snaps[:len(windows)], None,
                  "the socket-fed ingester", "the directly fed exporter")
    compare_planes(i_planes, y_planes, "the ingester's anomaly plane",
                   "the yardstick's")
    if alerts[0] != alerts[1]:
        raise AssertionError(f"anomaly alerts differ: {alerts}")
    for w, (a, b) in enumerate(zip(i_outs, y_outs)):
        for name in a._fields:
            x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
            if not torch.equal(x, y):
                raise AssertionError(f"window {w}: output {name} differs")
    for name in i_red._fields:
        if not torch.equal(getattr(i_red, name).cpu(),
                           getattr(y_red_out, name).cpu()):
            raise AssertionError(f"RED output {name} differs")
    fcfg, recalls = FlowSuiteConfig(), []
    for w, out in enumerate(i_outs):
        check_output(torch, out, fcfg)
        got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
        recalls.append(len(got & exact_topk(windows[w], fcfg.top_k))
                       / fcfg.top_k)
    if min(recalls) < 0.99:
        raise AssertionError(f"phase 13: top-K recall {recalls} < 0.99")
    if int(i_red.requests.sum()) != ING_L7 or AppSuiteConfig().groups != \
            i_red.requests.shape[0]:
        raise AssertionError("RED requests do not add up")
    # conservation, hop by hop
    if (rc["rx_frames"] != frames_sent or rc["no_handler"]
            or rc["rx_duplicate"] or rc["rx_errors"]):
        raise AssertionError(f"receiver counters {rc} ({frames_sent} sent)")
    if (dc["l4_flow_log"]["records"] != l4_rows
            or dc["l7_flow_log"]["records"] != ING_L7
            or any(c["decode_errors"] for c in dc.values())):
        raise AssertionError(f"decoder counters {dc}")
    if sc["rows_in"] != l4_rows or sc["lost_rows"] or sc["device_errors"]:
        raise AssertionError(f"sketch exporter counters {sc}")
    if ec["put"] != chunks or ec["put_errors"] or ec["shed"]:
        raise AssertionError(f"registry counters {ec}, {chunks} chunks "
                             "processed")
    for s, n in (("l4_flow_log", l4_rows), ("l7_flow_log", ING_L7)):
        if stored[s] + sampled[s] != n:
            raise AssertionError(f"{s}: {stored[s]} rows stored + "
                                 f"{sampled[s]} sampled out != {n}")
    if ing.flow_metrics.records != n_docs or ing.flow_metrics.decode_errors:
        raise AssertionError("unmarshaller counters")
    want = numpy_rollup({k: np.concatenate([c[k] for c in y_docs])
                         for k in y_docs[0]})
    assert_tables_equal(want, tier, "phase 13 1m tier vs numpy GROUP BY")
    log(f"  (a) one decoder, one connection, on {card}: {frames_sent} frames "
        f"({rc['rx_bytes'] / 1e6:.1f} MB); l4 {l4_rows} rows in {t_l4:.2f} s "
        f"({l4_rows / t_l4:.0f} records/s, first byte to the last window "
        f"flushed); every sketch leaf, the anomaly states and alerts "
        f"{alerts[0]}, every window and RED output = the directly fed "
        f"exporters; recall {recalls}; stored l4 {stored['l4_flow_log']} + "
        f"sampled out {sampled['l4_flow_log']}, l7 {stored['l7_flow_log']} "
        f"+ {sampled['l7_flow_log']}; registry {ec}; 1m tier "
        f"{len(tier['timestamp'])} rows = numpy GROUP BY; launches {launches}")
    return {"frames": frames_sent, "rx_bytes": rc["rx_bytes"],
            "l4_rows": l4_rows, "l4_seconds": t_l4,
            "l4_records_per_s": l4_rows / t_l4, "recall": recalls,
            "stored": stored, "sampled_out": sampled, "registry": ec,
            "tier_rows": len(tier["timestamp"]), "launches": launches,
            "snaps": i_snaps[:len(windows)]}


def run_ingester_throughput(torch, dev, name, per_window, profiled, windows,
                            ref_snaps, tmp, card, surface=True, **knobs):
    """Phase 13(b)/(c): the default two decoders, ING_VTAPS connections
    (one vtap_id each) sending at once, the tracer on. Windows 0 and 1
    unprofiled (records/s from the first byte sent to the last window
    flushed, stage medians, launches); then `profiled` = (frames per
    connection, rows) sent again with the ingest under torch.profiler
    (the feed drained inside it) for the ingest path's syncs. Returns
    the run's record."""
    from deepflow_tpu_torch.pipelines import Ingester
    from deepflow_tpu_torch.runtime.profiler import default_profiler
    from deepflow_tpu_torch.runtime.tracing import default_tracer
    from torch.profiler import ProfilerActivity, profile

    ing = Ingester(ingester_config(os.path.join(tmp, name), surface=surface,
                                   **knobs), device=dev)
    assert_native_registered(ing, name)
    exp = ing.tpu_sketch
    snaps = bus_snapshots(exp)
    counters = launch_counters()
    tr = default_tracer()
    l4_rows = sum(len(w["ip_src"]) for w in windows)
    try:
        ing.start()
        tr.reset()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        done = 0
        for w, per_conn in enumerate(per_window):
            send_parallel(ing.port, per_conn)
            done += len(windows[w]["ip_src"])
            wait_for(lambda: exp.rows_in == done, "the sketch exporter")
            exp.flush_window(now=ING_NOWS[w])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        lat = tr.latency()
        busy_s = {s: sk.sum for s, sk in tr.stages().items()}
        c0 = exp.counters()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        occ = default_profiler()
        occ.reset()
        with profile(activities=acts) as prof:
            mark(torch, dev)
            tp, wp = time.perf_counter(), time.time()
            send_parallel(ing.port, profiled[0])
            done += profiled[1]
            wait_for(lambda: exp.rows_in == done, "the sketch exporter")
            if not exp._feed.drain(60):
                raise AssertionError(f"{name}: the feed did not drain")
            t_prof = time.perf_counter() - tp
            occ_busy = occupancy_share(occ, wp, time.time())
            gauge_busy = occ.busy_fraction(horizon_s=t_prof)
            mark(torch, dev)
        c1 = exp.counters()
        exp.flush_window(now=ING_NOWS[-1] + 1)
        surface_probe = probe_surface(ing, name) if surface else None
        tuner = None if ing.autotuner is None else ing.autotuner.counters()
        knob_values = None if ing.autotuner is None else {
            k.name: k.get() for k in ing.autotuner.knobs}
        rc, ec = ing.receiver.counters(), ing.exporters.counters()
        dc = [d.counters() for d in ing.flow_log.decoders
              if d.stream == "l4_flow_log"]
    finally:
        ing.close()
        tr.disable()
    session = trace_session(torch, prof, t_prof)
    calls = session["runtime_calls"]
    fences = c1["feed_fences"] - c0["feed_fences"]
    compare_snaps(ref_snaps, snaps[:len(windows)], WIRE_FREE_LEAVES,
                  "(a)", name)
    if sum(d["records"] for d in dc) != l4_rows + profiled[1] \
            or any(d["decode_errors"] for d in dc) or rc["no_handler"] \
            or rc["rx_duplicate"] or ec["put_errors"] or ec["shed"]:
        raise AssertionError(f"{name}: counters {rc} {dc} {ec}")
    for k in ("fused_news_hists", "fused_lane_hists"):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if (calls["cudaStreamSynchronize"] or calls["cudaDeviceSynchronize"]
            or calls["cudaEventSynchronize"] != fences
            or session["d2h_copy_activities"]):
        raise AssertionError(f"{name}: the ingest path synced or read back "
                             f"outside its fences: {calls}, {fences} fences")
    stages = {s: round(lat[s]["p50_ms"], 4) for s in ING_STAGES if s in lat}
    # (a CPU rehearsal has no device stages: its groups carry no fence)
    missing = [s for s in ING_STAGES if s not in lat
               and (torch.device(dev).type == "cuda"
                    or not s.startswith("kernel."))]
    if missing:
        raise AssertionError(f"{name}: no {missing} stage in the tracer")
    # the decoders' summed busy time over the wall (two decoders: <= 2)
    decode_share = busy_s["decode"] / dt
    r = {"records": l4_rows, "seconds": dt, "records_per_s": l4_rows / dt,
         "stage_p50_ms": stages,
         "stage_counts": {s: lat[s]["count"] for s in stages},
         "stage_sum_s": {s: busy_s[s] for s in stages},
         "decode_share": decode_share,
         "launches": launches, "stream_syncs": calls["cudaStreamSynchronize"],
         "event_syncs": calls["cudaEventSynchronize"], "fences": fences,
         "device_syncs": calls["cudaDeviceSynchronize"],
         "profiled_ingest_ms": session["wall_ms"],
         "device_busy_share": session["device_busy_share"],
         "kernel_busy_share": session["kernel_busy_share"],
         "occupancy_busy": occ_busy, "busy_gauge": gauge_busy,
         "busy_ratio": occ_busy / session["kernel_busy_share"]
         if session["kernel_busy_share"] else None,
         "busy_counters": {k: v for k, v in c1.items()
                           if k.startswith("busy_")},
         "surface": surface_probe,
         "autotune": tuner, "knobs": knob_values, "snaps": snaps}
    log(f"  {name} on {card}: {l4_rows / dt:.0f} records/s ({dt:.2f} s for "
        f"{l4_rows} l4 records over {ING_VTAPS} connections, first byte to "
        f"the last window flushed); stage p50 ms {stages}; decode spans "
        f"{busy_s['decode']:.2f} s = {decode_share:.3f} of the wall; launches "
        f"{launches}; profiled ingest of one window {session['wall_ms']:.0f} "
        f"ms, device busy {100 * session['device_busy_share']:.1f}%, syncs: "
        f"stream {calls['cudaStreamSynchronize']}, event "
        f"{calls['cudaEventSynchronize']} = {fences} fences, device "
        f"{calls['cudaDeviceSynchronize']}; tpu_device_busy_fraction's "
        f"spans over it {occ_busy:.4f} (the gauge {gauge_busy:.4f}) vs "
        f"torch.profiler's kernel share "
        f"{session['kernel_busy_share']:.4f} (ratio {r['busy_ratio']}; "
        f"{session['gate_kernels']} gate kernels, "
        f"{session['gate_ms']:.1f} ms, left out), {r['busy_counters']}"
        + ("" if tuner is None else f"; autotuner {tuner}, knobs "
           f"{knob_values}")
        + ("; operations surface off" if surface_probe is None else
           f"; operations surface: /metrics {surface_probe['metrics_lines']}"
           f" lines valid, /healthz {surface_probe['healthz']}, slo_burning "
           f"{surface_probe['slo_burning']}, timeline "
           f"{surface_probe['timeline']}, debug counters/queues/breakers/"
           f"spill answered"))
    return r


def check_ingester(torch, dev, rng, windows, card, dict_feed_rate):
    """Phase 13: the port's Ingester fed over loopback TCP: (a) identity
    and conservation at one decoder, (b) throughput at two decoders and
    ING_VTAPS connections, (c) (b) with the feed autotuner on."""
    traffic = ingester_traffic(rng, windows)
    n_frames = sum(len(a) + len(b) for a, b in traffic["l4"]) \
        + len(traffic["l7"]) + len(traffic["metrics"])
    log(f"  {n_frames} frames built in {traffic['build_s']:.1f} s: "
        f"{len(traffic['l4'][0][0])} TAGGEDFLOW, "
        f"{sum(len(b) for _, b in traffic['l4'])} COLUMNAR_FLOW, "
        f"{len(traffic['l7'])} PROTOCOLLOG, {len(traffic['metrics'])} "
        "METRICS")
    native_decode = check_native_decode(traffic["l4"][0][0], card)
    seqr = traffic["seq"]
    per_window = [seqr.revtap(a + b, ING_VTAPS) for a, b in traffic["l4"]]
    again = traffic["l4"][1][1][:ING_PROFILED_FRAMES]
    profiled = (seqr.revtap(again, ING_VTAPS), ING_PROFILED_FRAMES
                * ING_COL_PER_FRAME)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ing_") as tmp:
        a = check_ingester_identity(torch, dev, traffic, windows, tmp, card)
        del traffic
        # (b), (c) and (b) off over window 0 (cut from both windows
        # for time); (a) runs both
        one = (per_window[:1], profiled, windows[:1], a["snaps"][:1])
        b = run_ingester_throughput(torch, dev, "(b)", *one, tmp, card)
        off = run_ingester_throughput(torch, dev, "(b) surface off", *one,
                                      tmp, card, surface=False)
        c = run_ingester_throughput(
            torch, dev, "(c) autotune", *one, tmp, card, autotune=True,
            autotune_interval_s=ING_AUTOTUNE_S)
    if c["stream_syncs"] != b["stream_syncs"] \
            or c["device_syncs"] != b["device_syncs"]:
        raise AssertionError(f"the autotuner changed the ingest syncs: "
                             f"{b['stream_syncs']} -> {c['stream_syncs']}")
    # the recorder's rule: the operations surface adds no sync (each run
    # already holds its event syncs to its fences)
    if (b["stream_syncs"], b["device_syncs"]) != \
            (off["stream_syncs"], off["device_syncs"]):
        raise AssertionError(
            f"the operations surface changed the ingest syncs: off "
            f"{off['stream_syncs']}/{off['device_syncs']}, on "
            f"{b['stream_syncs']}/{b['device_syncs']}")
    log(f"  (b) with the operations surface on: {b['records_per_s']:.0f} "
        f"records/s, off {off['records_per_s']:.0f} (ratio "
        f"{b['records_per_s'] / off['records_per_s']:.3f}); ingest syncs "
        f"stream {b['stream_syncs']} = {off['stream_syncs']}, device "
        f"{b['device_syncs']} = {off['device_syncs']}, event syncs = fences "
        f"in both")
    log(f"  (b), (c): the partition-free leaves {sorted(WIRE_FREE_LEAVES)} = "
        f"(a)'s at window 0; ingest stream syncs {b['stream_syncs']} = "
        f"{c['stream_syncs']}; records/s (b) {b['records_per_s']:.0f}, "
        f"(c) {c['records_per_s']:.0f}, phase 6's dict feed through put() "
        f"{dict_feed_rate:.0f} ((b) / dict feed "
        f"{b['records_per_s'] / dict_feed_rate:.3f})")
    for r in (a, b, off, c):
        r.pop("snaps")
    launches = {}
    for r in (a, b, off, c):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"identity": a, "throughput": b, "surface_off": off,
            "autotune": c, "launches": launches,
            "native_decode": native_decode,
            "dict_feed_records_per_s": dict_feed_rate, "card": card}

# -- the gate instrument (ops/cuda_gate.py), checked in phase 2 ----------------

GATE_LAUNCHES = 512
GATE_ELEMS = 1 << 22       # one add over 16 MiB: ~10 us on the device
GATE_HOST_US = 30          # host work between launches, as a program's Python


def _spin_us(us):
    end = time.perf_counter() + us * 1e-6
    while time.perf_counter() < end:
        pass


def check_gate(torch, dev, card):
    """The device gate against torch.profiler: GATE_LAUNCHES launches of
    one kernel with GATE_HOST_US of host work between them, timed three
    ways: gated (events behind a gate the host opens after the last
    launch), ungated (events around the launches) and by torch.profiler
    (the kernels' summed device time). The gated median must lie within
    20% of the profiler's time and the ungated one above it; a gate the
    host holds past its timeout must report the timeout."""
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.ops.cuda_gate import DeviceGate, gate_launch
    x = torch.zeros(GATE_ELEMS, device=dev)
    stream = torch.cuda.current_stream(dev)
    gate = DeviceGate(dev, timeout_s=2.0)

    def launches():
        for _ in range(GATE_LAUNCHES):
            x.add_(1.0)
            _spin_us(GATE_HOST_US)

    launches()             # the kernel loaded before any gate holds
    torch.cuda.synchronize()
    gate_launch.launches = 0
    gated, ungated, verdicts, host = [], [], [], []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ticket = gate.hold()
        ev[0].record(stream)
        t0 = time.perf_counter()
        launches()
        host.append((time.perf_counter() - t0) * 1e3)
        ev[1].record(stream)
        gate.release(ticket)
        torch.cuda.synchronize()
        verdicts.append(gate.verdict(ticket))
        gated.append(ev[0].elapsed_time(ev[1]))
        ev[2].record(stream)
        launches()
        ev[3].record(stream)
        torch.cuda.synchronize()
        ungated.append(ev[2].elapsed_time(ev[3]))
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        launches()
        torch.cuda.synchronize()
    kern = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == cuda
            and not e.name.startswith(("Memcpy", "Memset"))]
    prof_ms = sum(kern) / 1e3
    short = DeviceGate(dev, timeout_s=0.002)
    ticket = short.hold()
    time.sleep(0.05)          # the host holds it past the timeout
    short.release(ticket)
    torch.cuda.synchronize()
    timeout_verdict = short.verdict(ticket)
    # the launch queue's depth: tiny launches behind a held gate until
    # one blocks the host (the gate's timeout then releases it)
    tiny = torch.zeros(1024, device=dev)
    tiny.add_(1.0)
    torch.cuda.synchronize()
    probe = DeviceGate(dev, timeout_s=0.3)
    ticket = probe.hold()
    depth = None
    for i in range(4096):
        t0 = time.perf_counter()
        tiny.add_(1.0)
        if time.perf_counter() - t0 > 0.1:
            depth = i
            break
    probe.release(ticket)
    torch.cuda.synchronize()
    probe_verdict = probe.verdict(ticket)
    r = {"launches": GATE_LAUNCHES, "gate_launches": gate_launch.launches,
         "gated_ms": gated, "ungated_ms": ungated, "host_launch_ms": host,
         "profiler_kernel_ms": prof_ms, "profiler_kernels": len(kern),
         "gated_over_profiler": float(np.median(gated)) / prof_ms,
         "ungated_over_profiler": float(np.median(ungated)) / prof_ms,
         "timeout_verdict": timeout_verdict,
         "timed_out": gate.timed_out + short.timed_out,
         "launch_queue_depth": depth, "depth_probe_verdict": probe_verdict,
         "card": card}
    log(f"  gate on {card}: {GATE_LAUNCHES} launches of a 2^22-element add "
        f"with {GATE_HOST_US} us of host work between them: gated "
        f"{np.median(gated):.3f} ms, ungated {np.median(ungated):.3f} ms, "
        f"torch.profiler's kernels {prof_ms:.3f} ms ({len(kern)} kernels); "
        f"gated/profiler {r['gated_over_profiler']:.3f}, ungated/profiler "
        f"{r['ungated_over_profiler']:.3f}; host launching "
        f"{np.median(host):.2f} ms; a gate held past its 2 ms timeout "
        f"reports {timeout_verdict}; launches queued behind a held gate "
        f"before one blocked the host: {depth}; {gate_launch.launches} gate "
        "launches")
    if (verdicts != [True] * 3 or len(kern) != GATE_LAUNCHES
            or abs(r["gated_over_profiler"] - 1) > 0.2
            or not r["ungated_over_profiler"] > 1
            or timeout_verdict is not False or gate.timed_out != 0):
        raise AssertionError(f"the gate check failed: {r}, verdicts "
                             f"{verdicts}")
    for g in (gate, short, probe):
        g.close()
    return r


# -- phase 14: the operations surface under injected faults --------------------

OPS_FRAMES = 128           # planar frames of ING_COL_PER_FRAME rows per run
OPS_QUEUE = 64             # the spill runs' ingest queue capacity (frames)
OPS_BREAKER_S = 2.0        # exporter.raise armed this long on tpu_sketch


def ops_frames(rng, windows):
    """OPS_FRAMES planar COLUMNAR_FLOW frames of window 0's first rows."""
    n = OPS_FRAMES * ING_COL_PER_FRAME
    wide = l4_wide(rng, {k: v[:n] for k, v in windows[0].items()},
                   int(time.time()))
    return FrameSequencer().columnar(wide, 0, n), n


def _ops_ingester(torch, dev, root, **kw):
    from deepflow_tpu_torch.pipelines import Ingester
    return Ingester(ingester_config(root, **kw), device=dev)


def check_ops_breaker(torch, dev, frames, n, tmp, card):
    """Phase 14 (a), (c): exporter.raise on tpu_sketch for OPS_BREAKER_S
    opens its breaker; the watcher captures exactly one incident bundle
    (the healthz and SLO edges of the same moment are suppressed by the
    rate limit, counted) whose timeline window holds the put errors'
    rise; then health()["slo_burning"] and the deepflow_slo_burn_rate
    gauges read as the SLO rules say, recomputed from the timeline's
    rings."""
    import urllib.request

    from deepflow_tpu_torch.runtime.faults import default_faults
    root = os.path.join(tmp, "breaker")
    ing = _ops_ingester(torch, dev, root)
    faults = default_faults()
    try:
        ing.start()
        wait_for(lambda: ing.timeline.ticks >= 2, "two timeline ticks")
        faults.arm_spec(f"exporter.raise:p=1.0,for_s={OPS_BREAKER_S},"
                        "match=tpu_sketch;seed=14")
        t_armed = time.time()

        def tripped():
            return ing.exporters.breakers()["tpu_sketch"]["trips"] >= 1
        # rounds of new frames while the fault is armed: each round's
        # decoded chunks are puts that raise
        for i in range(0, len(frames), 8):
            if tripped() or time.time() - t_armed > OPS_BREAKER_S:
                break
            send_all(ing.port, frames[i:i + 8])
            time.sleep(0.05)
        wait_for(tripped, "the breaker to open", timeout=60)
        t_open = time.time()
        ticks = ing.timeline.ticks
        wait_for(lambda: ing.timeline.ticks >= ticks + 2
                 and ing.incidents.captured >= 1, "the incident capture",
                 timeout=60)
        faults.disarm()
        # the sampler stopped: the scrape and the rings hold one tick
        ing.timeline.stop()
        inc = ing.incidents.counters()
        bundles = ing.incidents.list()
        health = ing.health()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ing.prom_port}/metrics", timeout=30) as r:
            body = r.read().decode()
        slo = slo_readback(ing, body)
        ec = ing.exporters.counters()
    finally:
        faults.disarm()
        ing.close()
    if inc["captured"] != 1 or len(bundles) != 1:
        raise AssertionError(f"phase 14: {inc['captured']} incidents "
                             f"captured, {len(bundles)} bundles: {inc}")
    m = bundles[0]
    with open(os.path.join(m["path"], "timeline.json")) as f:
        tl = json.load(f)
    errs = [sv for sv in tl["series"]
            if sv["metric"] == "exporters_put_errors"]
    lo, hi = m["window"]
    covers = (lo <= t_armed <= hi and errs and errs[0]["values"][0] == 0
              and errs[0]["values"][-1] > 0)
    if m["kind"] != "breaker_open" or not covers:
        raise AssertionError(f"phase 14: bundle {m['id']} kind {m['kind']}"
                             f", window {m['window']} vs armed {t_armed}, "
                             f"put errors {errs[:1]}")
    if "ingest_availability" not in health["slo_burning"] \
            or sorted(health["slo_burning"]) != slo["fast_burning"]:
        raise AssertionError(f"phase 14: slo_burning {health} vs {slo}")
    log(f"  (a) breaker on {card}: exporter.raise for {OPS_BREAKER_S} s "
        f"opened tpu_sketch's breaker {t_open - t_armed:.2f} s after "
        f"arming; incidents {inc}; bundle {m['id']} ({m['kind']}, files "
        f"{sorted(m['files'])}), its window [{lo:.1f}, {hi:.1f}] holds the "
        f"put errors' rise 0 -> {errs[0]['values'][-1]:.0f}; registry {ec}")
    log(f"  (c) SLO on {card}: slo_burning {health['slo_burning']}; burn "
        f"rates read back {slo['gauges']} = recomputed from the rings")
    return {"incidents": inc, "bundle": m["id"], "kind": m["kind"],
            "window": m["window"], "armed": t_armed,
            "open_after_s": t_open - t_armed, "registry": ec,
            "slo_burning": health["slo_burning"], "slo": slo}


def slo_readback(ing, body):
    """Each deepflow_slo_burn_rate sample of a scrape against the burn
    recomputed with numpy from the timeline's rings at the sample's
    tick: ratio SLOs as window deltas of the bad over the total
    counters, threshold SLOs as the share of samples over the bound."""
    from deepflow_tpu_torch.runtime.timeline import (SLO_FAST_WINDOW_S,
                                                     SLO_SLOW_WINDOW_S)
    tl = ing.timeline
    got = {}
    for line in body.splitlines():
        if line.startswith("deepflow_slo_burn_rate{"):
            lbl, v = line.rsplit(" ", 1)
            got[lbl[len("deepflow_slo_burn_rate"):]] = float(v)
    windows = {"fast": SLO_FAST_WINDOW_S, "slow": SLO_SLOW_WINDOW_S}
    want = {}
    for ring in tl._rings_of("slo_burn_rate"):
        now, _ = ring.last
        slo = next(r for r in tl._slos if r.name == ring.labels["slo"])
        lo = now - windows[ring.labels["window"]]
        if slo.kind == "threshold":
            vs = [ring2.samples(lo, None)[1]
                  for ring2 in tl._rings_of(slo.series)]
            vs = np.concatenate(vs) if vs else np.zeros(0)
            frac = float(np.mean(vs > slo.bound)) if len(vs) else 0.0
        else:
            def delta(metric):
                d = 0.0
                for r2 in tl._rings_of(metric):
                    ts, v = r2.samples()
                    b = np.searchsorted(ts, now, side="right") - 1
                    a = max(np.searchsorted(ts, lo, side="right") - 1, 0)
                    if len(ts) >= 2 and b > 0 and b > a:
                        d += max(0.0, float(v[b] - v[a]))
                return d
            bad = sum(delta(m) for m in slo.bad)
            tot = sum(delta(m) for m in slo.total)
            frac = (1.0 if bad > 0 else 0.0) if tot <= 0 \
                else min(1.0, bad / tot)
        key = '{slo="%s",window="%s"}' % (ring.labels["slo"],
                                          ring.labels["window"])
        want[key] = frac / max(1.0 - slo.objective, 1e-9)
    if set(got) != set(want) or len(want) != 6:
        raise AssertionError(f"phase 14: burn gauges {got} vs {want}")
    for k in want:
        if not np.isclose(got[k], want[k], rtol=1e-9, atol=0):
            raise AssertionError(f"phase 14: {k} scraped {got[k]}, "
                                 f"recomputed {want[k]}")
    fast = sorted(ring.labels["slo"] for ring in tl._rings_of(
        "slo_burn_rate") if ring.labels["window"] == "fast"
        and ring.last[1] > tl.fast_burn_threshold)
    return {"gauges": got, "fast_burning": fast}


def check_ops_spill(torch, dev, frames, n, tmp, card):
    """Phase 14 (b): the same frames through a fault-free ingester and
    one whose l4 ingest queue stalls (queue.stall on its consumer) with
    the spill armed on OPS_QUEUE-frame queues: segments are written and
    replayed, delivered + counted loss == sent, and the partition-free
    sketch leaves equal the fault-free run's."""
    from deepflow_tpu_torch.runtime.faults import default_faults
    out = {}
    for name, spec in (("fault-free", None),
                       ("stalled", "queue.stall:p=1.0,for_s=2.0,"
                        "delay_s=0.25,match=ingest.l4_flow_log;seed=14")):
        ing = _ops_ingester(torch, dev, os.path.join(tmp, name),
                            n_decoders=1, queue_size=OPS_QUEUE)
        exp = ing.tpu_sketch
        snaps = bus_snapshots(exp)
        faults = default_faults()
        try:
            ing.start()
            if spec:
                faults.arm_spec(spec)
            t0 = time.perf_counter()
            send_all(ing.port, frames)
            lost = lambda: sum(  # noqa: E731
                c["spill_evicted"] for c in ing.spill.per_queue().values())
            wait_for(lambda: exp.rows_in + lost() * ING_COL_PER_FRAME >= n
                     and ing.spill.pending_segments() == 0,
                     f"{name}: every frame delivered or counted", timeout=120)
            dt = time.perf_counter() - t0
            faults.disarm()
            exp.flush_window(now=ING_NOWS[0])
            sc = ing.spill.counters()
            qc = ing._own_queues()["ingest.l4_flow_log"].counters()
            rows_in = exp.rows_in
        finally:
            faults.disarm()
            ing.close()
        out[name] = {"rows_in": rows_in, "spill": sc, "queue": qc,
                     "seconds": dt, "snaps": snaps[:1]}
    st = out["stalled"]
    loss_rows = (st["spill"]["spill_evicted"] + st["queue"]["overwritten"]
                 + st["queue"]["closed_dropped"]) * ING_COL_PER_FRAME
    if st["spill"]["spilled_records"] <= 0 \
            or st["spill"]["replayed"] != st["spill"]["spilled_records"] \
            or st["rows_in"] + loss_rows != n \
            or out["fault-free"]["rows_in"] != n:
        raise AssertionError(f"phase 14: spill conservation {out}")
    compare_snaps(out["fault-free"]["snaps"], st["snaps"], WIRE_FREE_LEAVES,
                  "fault-free", "spilled")
    log(f"  (b) spill on {card}: queue.stall on the l4 ingest queue for 2 s "
        f"({OPS_QUEUE}-frame rings, watermark 0.75): {st['spill']} ; queue "
        f"{st['queue']}; delivered {st['rows_in']} + counted loss "
        f"{loss_rows} = sent {n}; partition-free leaves "
        f"{sorted(WIRE_FREE_LEAVES)} = the fault-free run's; "
        f"{st['seconds']:.2f} s stalled vs {out['fault-free']['seconds']:.2f}"
        " s fault-free")
    for r in out.values():
        r.pop("snaps")
    return out


def check_ops(torch, dev, rng, windows, card):
    """Phase 14: the operations surface under injected faults at phase
    13's widths (planar frames of phase 3's rows, the ingester of phase
    13 on its defaults)."""
    frames, n = ops_frames(rng, windows)
    counters = launch_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_") as tmp:
        breaker = check_ops_breaker(torch, dev, frames, n, tmp, card)
        spill = check_ops_spill(torch, dev, frames, n, tmp, card)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for k in ("fused_news_hists", "fused_lane_hists"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 14: kernel {k} never launched")
    return {"breaker_slo": breaker, "spill": spill, "launches": launches,
            "card": card}


# -- phase 15: serving and the querier --------------------------------------

QUERY_RUNS = 3             # wall p50 over this many runs per statement
#                            (cut from 5 for time)
SERVE_RPS = 20.0           # (b)'s client: requests a second over HTTP
SERVE_MIN_S = 3.0          # (b)'s client runs at least this long
SERVE_CMS_KEYS = 1 << 16   # keys of the CMS multiget against ops/cms.query


def querier_statements(t0):
    """(a)'s statements, the DeepFlow UI's kinds: (label, sql)."""
    b = "vtap_flow_port"
    w = f"timestamp >= {t0 + 30} AND timestamp < {t0 + 90}"
    return [
        ("1 tag", f"SELECT ip, Sum(byte_tx) AS b, Max(rtt_max) AS r, "
         f"Avg(packet_tx) AS p FROM {b} GROUP BY ip"),
        ("2 tags", f"SELECT ip, server_port, Sum(packet_tx) AS p FROM {b} "
         f"GROUP BY ip, server_port ORDER BY p DESC LIMIT 100"),
        ("3 tags", f"SELECT vtap_id, server_port, l3_epc_id, "
         f"Avg(rtt_sum) AS a, Max(rtt_max) AS m, Sum(byte_rx) AS r "
         f"FROM {b} GROUP BY vtap_id, server_port, l3_epc_id"),
        ("derived", f"SELECT server_port, rtt_avg, byte, retrans_ratio "
         f"FROM {b} GROUP BY server_port"),
        ("time(60)", f"SELECT time(60) AS t, Sum(byte_tx) AS b, "
         f"Sum(packet_tx) AS p FROM {b} GROUP BY time(60)"),
        ("where+having", f"SELECT ip, Sum(byte_tx) AS b FROM {b} WHERE {w} "
         f"GROUP BY ip HAVING b > 1000000 ORDER BY b DESC LIMIT 100"),
        ("percentile", f"SELECT vtap_id, Percentile(rtt_max, 99) AS p "
         f"FROM {b} GROUP BY vtap_id"),
        ("1m tier", f"SELECT ip, vtap_id, Sum(byte_tx) AS b FROM {b}.1m "
         f"GROUP BY ip, vtap_id ORDER BY b DESC LIMIT 100"),
        ("show", f"SHOW TAG vtap_id VALUES FROM {b}"),
    ]


class PathCounter:
    """Wraps the querier's group_reduce: per call the rows grouped and
    the path taken ("device": the whole GROUP BY on the card; "host":
    the host lexsort, the reduce on the engine's device; "host+inverse":
    the same with the row->group map, a Percentile's)."""

    def __init__(self):
        from deepflow_tpu_torch.querier import engine
        from deepflow_tpu_torch.store import rollup
        self.calls = []
        self._engine, self._rollup = engine, rollup
        self._real, self._real_dev = engine.group_reduce, \
            rollup.group_reduce_device
        self._took_device = False

    def __enter__(self):
        def dev_path(*a, **kw):
            self._took_device = True
            return self._real_dev(*a, **kw)

        def wrapped(cols, keys, aggs, **kw):
            self._took_device = False
            out = self._real(cols, keys, aggs, **kw)
            path = "device" if self._took_device else (
                "host+inverse" if kw.get("return_inverse") else "host")
            self.calls.append((len(next(iter(cols.values()))), path))
            return out
        self._rollup.group_reduce_device = dev_path
        self._engine.group_reduce = wrapped
        return self

    def __exit__(self, *exc):
        self._engine.group_reduce = self._real
        self._rollup.group_reduce_device = self._real_dev


def numpy_groupby_checks(cols, t0, results):
    """Two statements against a plain numpy GROUP BY of phase 10's
    columns: "1 tag" and "time(60)"."""
    ip, inv = np.unique(cols["ip"], return_inverse=True)
    inv = inv.reshape(-1)
    n = np.bincount(inv)
    b = np.bincount(inv, cols["byte_tx"].astype(np.float64))
    r = np.zeros(len(ip), np.int64)
    np.maximum.at(r, inv, cols["rtt_max"].astype(np.int64))
    p = np.bincount(inv, cols["packet_tx"].astype(np.float64))
    want = [[int(ip[i]), int(b[i]), int(r[i]), float(p[i] / n[i])]
            for i in range(len(ip))]
    if results["1 tag"] != want:
        raise AssertionError("querier '1 tag' != numpy GROUP BY")
    bucket = cols["timestamp"].astype(np.int64) // 60 * 60
    tb, tinv = np.unique(bucket, return_inverse=True)
    tinv = tinv.reshape(-1)
    want = [[int(tb[i]),
             int(cols["byte_tx"].astype(np.int64)[tinv == i].sum()),
             int(cols["packet_tx"].astype(np.int64)[tinv == i].sum())]
            for i in range(len(tb))]
    if results["time(60)"] != want:
        raise AssertionError("querier 'time(60)' != numpy GROUP BY")


def check_querier_sql(torch, dev, root, db, cols, t0, card):
    """Phase 15 (a): the DeepFlow UI's kinds of SQL over phase 10's store
    through QueryEngine on the card and on the CPU: identical rows, two
    statements = numpy, the GROUP BY path of each, wall p50 of
    QUERY_RUNS runs each way, one device-path query profiled."""
    from deepflow_tpu_torch.querier import QueryEngine
    from deepflow_tpu_torch.store.db import Store
    from deepflow_tpu_torch.store.dict_store import TagDictRegistry
    t_a = time.perf_counter()
    store = Store(root)
    engines = {"card": QueryEngine(store, TagDictRegistry(None),
                                   device=dev),
               "cpu": QueryEngine(store, TagDictRegistry(None),
                                  device="cpu")}
    rows, results = [], {}
    for label, sql in querier_statements(t0):
        got, walls, paths = {}, {}, {}
        for where, eng in engines.items():
            with PathCounter() as pc:
                got[where] = eng.execute(sql, db=db)
            paths[where] = pc.calls
            times = []
            for _ in range(QUERY_RUNS):
                t = time.perf_counter()
                eng.execute(sql, db=db)
                times.append(time.perf_counter() - t)
            walls[where] = float(np.median(times)) * 1e3
        if got["card"].columns != got["cpu"].columns \
                or got["card"].values != got["cpu"].values:
            raise AssertionError(f"querier {label!r}: card rows != CPU rows")
        if not got["card"].values:
            raise AssertionError(f"querier {label!r} answered no rows")
        results[label] = got["card"].values
        row = {"statement": label, "rows_out": len(got["card"].values),
               "groupby": paths["card"], "cpu_groupby": paths["cpu"],
               "card_p50_ms": walls["card"], "cpu_p50_ms": walls["cpu"]}
        rows.append(row)
        log(f"  querier {label!r} on {card}: GROUP BY "
            + (", ".join(f"{n} rows on the {p} path"
                         for n, p in paths["card"]) or "none")
            + f"; {row['rows_out']} rows out; wall p50 card "
            f"{walls['card']:.1f} ms, cpu {walls['cpu']:.1f} ms; "
            "card rows = cpu rows")
    numpy_groupby_checks(cols, t0, results)
    taken = {p for r in rows for _, p in r["groupby"]}
    if "host+inverse" not in taken or (
            "device" not in taken and torch.device(dev).type == "cuda"):
        raise AssertionError(f"querier paths {[r['groupby'] for r in rows]}"
                             ": no device or no inverse GROUP BY")
    label, sql = querier_statements(t0)[0]
    prof = profile_call(torch, dev, lambda: engines["card"].execute(sql,
                                                                    db=db))
    log(f"  querier {label!r} profiled on {card}: {prof['wall_ms']:.1f} ms "
        f"wall, {prof['kernels']} kernels ({prof['kernel_ms']:.3f} ms), "
        f"syncs " + ", ".join(f"{k} {prof['runtime_calls'][k]}"
                              for k in SYNC_CALLS)
        + f", {prof['d2h_copy_activities']} device-to-host copies; "
        "'1 tag' and 'time(60)' = numpy GROUP BY")
    return {"statements": rows, "profile": {
        k: prof[k] for k in ("wall_ms", "kernels", "kernel_ms",
                             "d2h_copy_activities", "runtime_calls",
                             "attempts")},
        "seconds": time.perf_counter() - t_a, "card": card}


class ServingClient(threading.Thread):
    """(b)'s client: SERVE_RPS requests a second over HTTP, round robin
    over the sketch SQL and the PromQL the dashboards send; latencies
    kept, any answer but 200 kept as an error. PromQL over a
    self-telemetry series is sent once the timeline carries it (before
    that the evaluator looks for it in the store's ext_samples table,
    which this store does not have, and answers 400)."""

    def __init__(self, port, keys, timeline):
        super().__init__(daemon=True)
        self.port = port
        self.timeline = timeline
        self.lat, self.errors = [], []
        self._halt = threading.Event()
        k = int(keys[0])
        self.requests = [
            ("sql", "SELECT sketch.topk(100) FROM sketch"),
            ("sql", f"SELECT sketch.cms_point({k}) FROM sketch"),
            ("sql", "SELECT sketch.hll_card() FROM sketch"),
            ("sql", "SELECT sketch.entropy() FROM sketch"),
            ("query", "sketch_topk(10)"),
            ("query", 'anomaly_score{detector="entropy_ddos"}'),
            ("query", "tpu_sketch_rows_in"),
            ("query", "querier_read_p99_s"),
            ("range", "sketch_topk(10)"),
            ("range", "tpu_sketch_rows_in"),
            ("range", "querier_read_p99_s"),
        ]

    def call(self, kind, q):
        import urllib.error
        import urllib.parse
        import urllib.request
        base = f"http://127.0.0.1:{self.port}"
        now = int(time.time())
        if kind == "sql":
            req = urllib.request.Request(
                base + "/v1/query",
                data=urllib.parse.urlencode({"sql": q}).encode())
        elif kind == "query":
            req = base + "/api/v1/query?" + urllib.parse.urlencode(
                {"query": q, "time": now})
        else:
            req = base + "/api/v1/query_range?" + urllib.parse.urlencode(
                {"query": q, "start": now - 10, "end": now, "step": 1})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def run(self):
        i = 0
        while not self._halt.is_set():
            kind, q = self.requests[i % len(self.requests)]
            i += 1
            series = q if q in ("tpu_sketch_rows_in",
                                "querier_read_p99_s") else None
            if series and not self.timeline.has_metric(series):
                continue
            t = time.perf_counter()
            code, body = self.call(kind, q)
            self.lat.append(time.perf_counter() - t)
            if code != 200:
                self.errors.append((kind, q, code, body))
            self._halt.wait(max(0.0, 1.0 / SERVE_RPS
                                - (time.perf_counter() - t)))

    def stop(self):
        self._halt.set()
        self.join(timeout=60)


def check_served_sketch(torch, dev, exp, tables, window, card):
    """(b)'s checks on the current window, drained and published by
    checkpoint_now: SketchTables against the card's own ops on the
    exporter's state (read after a synchronize), top-K recall and the
    CMS's one-sided error against exact counts."""
    from deepflow_tpu_torch.ops import cms, hll
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    if not exp.checkpoint_now():
        raise AssertionError("phase 15: checkpoint_now did not publish")
    torch.cuda.synchronize()
    keys = fold_columns_np([window[c] for c in ("ip_src", "ip_dst",
                                                "port_src", "port_dst",
                                                "proto")])
    uniq, counts = np.unique(keys, return_counts=True)
    # the window's keys (up to SERVE_CMS_KEYS), topped up with keys it
    # never sent (exact count 0)
    rng = np.random.default_rng(15)
    sent = uniq[rng.permutation(len(uniq))[:SERVE_CMS_KEYS]]
    extra = np.setdiff1d(rng.integers(0, 1 << 32, 2 * SERVE_CMS_KEYS,
                                      dtype=np.uint64).astype(np.uint32),
                         uniq)[:SERVE_CMS_KEYS - len(sent)]
    probe = np.concatenate([sent, rng.permutation(extra)])
    exact = np.zeros(len(probe), np.int64)
    exact[:len(sent)] = counts[np.searchsorted(uniq, sent)]
    t = time.perf_counter()
    served = tables.cms_points(probe)["estimates"]
    walls = {"cms_points": time.perf_counter() - t}
    on_card = cms.query(exp.state.sketch, torch.from_numpy(
        probe.astype(np.int64)).to(dev)).cpu().numpy()
    if len(probe) != SERVE_CMS_KEYS or served.dtype != on_card.dtype \
            or not np.array_equal(served, on_card):
        raise AssertionError("SketchTables.cms_points != ops/cms.query")
    if (served < exact).any():
        raise AssertionError("a CMS point estimate is below its exact count")
    card_hll = float(hll.estimate(exp.state.services).sum().item())
    t = time.perf_counter()
    served_hll = tables.hll_card()["cardinality"]
    walls["hll_card"] = time.perf_counter() - t
    if not np.isclose(served_hll, card_hll, rtol=1e-6, atol=0.0):
        raise AssertionError(f"hll_card {served_hll} != ops/hll.estimate "
                             f"{card_hll}")
    t = time.perf_counter()
    top = {r["flow_key"] for r in tables.topk(100)}
    walls["topk"] = time.perf_counter() - t
    rec = len(top & exact_topk(window, 100)) / 100
    if rec < 0.99:
        raise AssertionError(f"served top-K recall {rec} < 0.99")
    return {"cms_keys": len(probe), "cms_keys_sent": len(sent),
            "hll_card": served_hll, "recall": rec,
            "cms_over": int((served - exact).sum()),
            "read_ms": {k: round(v * 1e3, 3) for k, v in walls.items()}}


def serve_run(torch, dev, name, frames, profiled, window, tmp, card,
              client_on):
    """Phase 15 (b), one run: the ingester of phase 13 (b) with serving
    mounted on its buses and a QuerierServer on port 0; window 0 sent
    over ING_VTAPS connections (records/s), checked and flushed, then
    ING_PROFILED_FRAMES more frames under torch.profiler (syncs). With
    `client_on` a ServingClient queries throughout."""
    from deepflow_tpu_torch.pipelines import Ingester
    from deepflow_tpu_torch.querier.server import QuerierServer
    from deepflow_tpu_torch.runtime.tracing import default_tracer
    from deepflow_tpu_torch.serving import (AnomalyTables, SketchTables,
                                            SnapshotCache)
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    from torch.profiler import ProfilerActivity, profile

    ing = Ingester(ingester_config(os.path.join(tmp, name)), device=dev)
    exp = ing.tpu_sketch
    tables = SketchTables(SnapshotCache(exp.snapshot_bus))
    atables = AnomalyTables(SnapshotCache(exp.anomaly.bus))
    srv = QuerierServer(ing.store, ing.tag_dicts, port=0, sketch=tables,
                        anomaly=atables, timeline=ing.timeline,
                        incidents=ing.incidents, device=dev)
    keys = fold_columns_np([window[c][:1] for c in (
        "ip_src", "ip_dst", "port_src", "port_dst", "proto")])
    client = ServingClient(srv.port, keys, ing.timeline) if client_on \
        else None
    counters = launch_counters()
    tr = default_tracer()
    n = len(window["ip_src"])
    served = None
    try:
        ing.start()
        srv.start()
        tr.enable()
        t_client = time.perf_counter()
        if client is not None:
            client.start()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        send_parallel(ing.port, frames)
        wait_for(lambda: exp.rows_in == n, "the sketch exporter")
        if not exp._feed.drain(60):
            raise AssertionError(f"{name}: the feed did not drain")
        dt = time.perf_counter() - t0
        if client is not None:
            served = check_served_sketch(torch, dev, exp, tables, window,
                                         card)
        exp.flush_window(now=time.time())
        if client is not None:
            after = {r["flow_key"] for r in tables.topk(100)}
            if len(after & exact_topk(window, 100)) / 100 < 0.99:
                raise AssertionError("the flushed window's served top-K "
                                     "recall < 0.99")
        c0 = exp.counters()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            mark(torch, dev)
            tp = time.perf_counter()
            send_parallel(ing.port, profiled[0])
            wait_for(lambda: exp.rows_in == n + profiled[1],
                     "the sketch exporter")
            if not exp._feed.drain(60):
                raise AssertionError(f"{name}: the feed did not drain")
            t_prof = time.perf_counter() - tp
            mark(torch, dev)
        c1 = exp.counters()
        exp.flush_window(now=time.time())
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        answers = None
        if client is not None:
            wait_for(lambda: time.perf_counter() - t_client >= SERVE_MIN_S
                     and len(ing.timeline.prom_fetch(
                         "querier_read_p99_s", [], 0, 1 << 62)) > 0,
                     "querier_read_p99_s samples in the timeline", 60)
            client.stop()
            answers = {q: client.call("sql", q) for q in (
                "SELECT * FROM timeline", "SELECT * FROM incidents")}
            for q, (code, body) in answers.items():
                if code != 200:
                    raise AssertionError(f"{q}: {code} {body}")
            slo = ing.timeline.prom_fetch("querier_read_p99_s", [], 0,
                                          1 << 62)
            if client.errors:
                raise AssertionError(f"client errors {client.errors[:3]}")
        tc = tables.counters()
    finally:
        if client is not None and client.is_alive():
            client.stop()
        srv.close()
        ing.close()
        tr.disable()
    session = trace_session(torch, prof, t_prof)
    calls = session["runtime_calls"]
    fences = c1["feed_fences"] - c0["feed_fences"]
    for k in ("fused_news_hists", "fused_lane_hists"):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if (calls["cudaStreamSynchronize"] or calls["cudaDeviceSynchronize"]
            or calls["cudaEventSynchronize"] != fences
            or session["d2h_copy_activities"]):
        raise AssertionError(f"{name}: the ingest synced or read back "
                             f"outside its fences: {calls}, {fences} fences")
    r = {"records": n, "seconds": dt, "records_per_s": n / dt,
         "launches": launches, "stream_syncs": calls["cudaStreamSynchronize"],
         "event_syncs": calls["cudaEventSynchronize"], "fences": fences,
         "device_syncs": calls["cudaDeviceSynchronize"],
         "profiled_ingest_ms": t_prof * 1e3}
    if client is not None:
        lat = np.asarray(client.lat)
        r.update({"served": served, "requests": len(lat),
                  "http_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                  "http_p99_ms": float(np.percentile(lat, 99)) * 1e3,
                  "serving_p50_ms": tc["read_p50_s"] * 1e3,
                  "serving_p99_ms": tc["read_p99_s"] * 1e3,
                  "serving_reads": tc["reads"],
                  "slo_samples": int(sum(len(ts) for _, ts, _ in slo)),
                  "timeline_rows": len(answers["SELECT * FROM timeline"][1]
                                       ["result"]["values"]),
                  "incident_rows": len(answers["SELECT * FROM incidents"][1]
                                       ["result"]["values"])})
    log(f"  {name} on {card}: {n / dt:.0f} records/s ({dt:.2f} s for {n} "
        f"records over {ING_VTAPS} connections); profiled ingest of "
        f"{profiled[1]} records: syncs stream {r['stream_syncs']}, event "
        f"{r['event_syncs']} = {fences} fences, device "
        f"{r['device_syncs']}; launches {launches}"
        + ("" if client is None else
           f"; {r['requests']} HTTP requests, p50 {r['http_p50_ms']:.2f} "
           f"ms, p99 {r['http_p99_ms']:.2f} ms; serving reads "
           f"{r['serving_reads']}, p50 {r['serving_p50_ms']:.3f} ms, p99 "
           f"{r['serving_p99_ms']:.3f} ms (host); served: {served}; "
           f"serving_p99 SLO samples {r['slo_samples']}; timeline "
           f"{r['timeline_rows']} rows, incidents {r['incident_rows']} "
           "rows"))
    return r


def check_serving(torch, dev, rng, windows, card):
    """Phase 15 (b): serving and the querier's HTTP API on a live
    ingester, phase 3's window 0 sent with the client off and then on."""
    t_b = time.perf_counter()
    window = windows[0]
    n = len(window["ip_src"])
    seqr = FrameSequencer()
    planar = seqr.columnar(l4_wide(rng, window, int(time.time())), 0, n)
    frames = seqr.revtap(planar, ING_VTAPS)
    profiled = (seqr.revtap(planar[:ING_PROFILED_FRAMES], ING_VTAPS),
                ING_PROFILED_FRAMES * ING_COL_PER_FRAME)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        off = serve_run(torch, dev, "(b) client off", frames, profiled,
                        window, tmp, card, client_on=False)
        on = serve_run(torch, dev, "(b) client on", frames, profiled,
                       window, tmp, card, client_on=True)
    if (on["stream_syncs"], on["device_syncs"]) != \
            (off["stream_syncs"], off["device_syncs"]):
        raise AssertionError(f"the client changed the ingest syncs: off "
                             f"{off}, on {on}")
    log(f"  (b): records/s with the client on {on['records_per_s']:.0f}, "
        f"off {off['records_per_s']:.0f} (ratio "
        f"{on['records_per_s'] / off['records_per_s']:.3f}); ingest syncs "
        f"equal (event syncs = fences in both: {on['event_syncs']}, "
        f"{off['event_syncs']})")
    launches = {}
    for r in (off, on):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"client_off": off, "client_on": on, "launches": launches,
            "seconds": time.perf_counter() - t_b, "card": card}


# -- phase 16: the whole ingest surface and the server --------------------

SRV_L4 = 1 << 18           # phase 3's window 0, cut, as planar frames
SRV_RED_WINDOWS = 4
SRV_RED_RECORDS = 1 << 15  # l7 requests per RED window (cut from 2^18)
SRV_RED_STEP = 15          # seconds between the RED windows' stamps
SRV_PROM_BUCKETS = 8       # le bounds every 8th gamma bucket (g^8 ~ 1.38)
SRV_OTEL_SPANS = 1 << 14   # half of them in zlib-compressed frames
SRV_OTEL_PER_REQ = 256
SRV_PSEQ_FLOWS = 1 << 12
SRV_PROM_SERIES = 1024     # remote-write series x samples
SRV_PROM_SAMPLES = 60
SRV_TELEGRAF_LINES = 2048  # two fields a line
SRV_PROC_EVENTS = 1024
SRV_ALARMS = 256
SRV_PROFILES = 1024
SRV_SAMPLED = 64           # services whose p95 is held against the exact one
SRV_FRAME_BYTES = 400_000  # raw payloads packed below the 512 KB frame cap


def red_services(rng, cfg):
    """One server endpoint per service group, so every one of cfg.groups
    is active, and the group of each."""
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    n = 1 << 15
    cand = {"ip_dst": (0xAC100000 + rng.permutation(1 << 20)[:n])
            .astype(np.uint32),
            "port_dst": rng.choice(np.array([80, 443, 8080, 9092],
                                            np.uint32), n),
            "protocol": np.full(n, 6, np.uint32)}
    group = (fold_columns_np([cand["ip_dst"], cand["port_dst"],
                              cand["protocol"]])
             % np.uint32(cfg.groups)).astype(np.int64)
    first = np.unique(group, return_index=True)[1]
    if len(first) != cfg.groups:
        raise AssertionError("the candidate endpoints miss a service group")
    return {k: v[first] for k, v in cand.items()}, group[first]


def red_server_window(rng, pool, records):
    """One RED window over every service: the first len(pool) records
    one per service, the rest uniform over them; rrt_us log-normal with
    a median per service (500 us to 20 ms) and sigma 1.0, 1% zeros."""
    n_svc = len(pool["ip_dst"])
    pick = np.concatenate([np.arange(n_svc),
                           rng.integers(0, n_svc, records - n_svc)])
    median = np.exp(np.linspace(np.log(500.0), np.log(20_000.0), n_svc))
    rrt = np.round(rng.lognormal(np.log(median[pick]), 1.0))
    rrt[rng.random(records) < 0.01] = 0
    cols = {k: v[pick] for k, v in pool.items()}
    cols["rrt_us"] = np.minimum(rrt, 2 ** 32 - 1).astype(np.uint32)
    cols["status"] = rng.choice(RED_CODES, records, p=RED_P)
    return cols, pick


def raw_frames(seqr, msg_type, payloads, vtap=1):
    """Self-delimited payloads packed into frames below the frame cap."""
    out, batch, size = [], [], 0
    for p in payloads + [None]:
        if p is not None and size + len(p) < SRV_FRAME_BYTES:
            batch.append(p)
            size += len(p)
            continue
        if batch:
            out.append(seqr.frame(msg_type, b"".join(batch), vtap))
        batch, size = ([p], len(p)) if p is not None else ([], 0)
    return out


def pseq_blocks(rng, n_flows, t0_us):
    """PACKETSEQUENCE blocks in the envelope l4_packet.go decodes (u32
    size, u64 flow_id, u64 count<<56 | end_us, 20-byte entries, the
    format of agent/packet_sequence.py): 1 to 255 packets a flow."""
    import struct
    blocks = []
    fids = rng.integers(1, 1 << 62, n_flows, dtype=np.uint64)
    counts = rng.integers(1, 256, n_flows)
    for f in range(n_flows):
        k = int(counts[f])
        e = np.zeros((k, 5), np.uint32)
        e[:, 0] = np.sort(rng.integers(0, 3_000_000, k))
        e[:, 1] = rng.integers(0, 1 << 32, k, dtype=np.uint64)
        e[:, 2] = rng.integers(0, 1 << 32, k, dtype=np.uint64)
        e[:, 3] = (rng.integers(0, 1500, k).astype(np.uint32) << 16) \
            | rng.integers(0, 1 << 16, k).astype(np.uint32)
        e[:, 4] = rng.integers(0, 256, k).astype(np.uint32) \
            | (rng.integers(0, 2, k).astype(np.uint32) << 8)
        end = t0_us + int(e[-1, 0])
        blocks.append(struct.pack("<IQQ", 16 + e.nbytes, int(fids[f]),
                                  (k << 56) | end) + e.tobytes())
    return blocks


def otel_payloads(rng, n_req, per_req, t0):
    """ExportTraceServiceRequests of seeded spans: http and grpc
    attributes, peer ports, status codes, random ids, service names."""
    from deepflow_tpu_torch.wire.gen import otel_pb2
    names = ["GET /api/users", "POST /api/orders", "UserService/Get",
             "db.query", "cache.get"]
    out = []
    for _ in range(n_req):
        req = otel_pb2.ExportTraceServiceRequest()
        rs = req.resource_spans.add()
        kv = rs.resource.attributes.add()
        kv.key = "service.name"
        kv.value.string_value = f"svc-{int(rng.integers(0, 64))}"
        ss = rs.scope_spans.add()
        starts = t0 * 1_000_000_000 + rng.integers(0, 10 ** 10, per_req)
        durs = rng.lognormal(15, 1.5, per_req).astype(np.int64)
        kinds = rng.integers(0, 3, per_req)
        for i in range(per_req):
            s = ss.spans.add()
            s.name = names[int(kinds[i] + i) % len(names)]
            s.trace_id = rng.bytes(16)
            s.span_id = rng.bytes(8)
            s.parent_span_id = rng.bytes(8)
            s.kind = 2
            s.start_time_unix_nano = int(starts[i])
            s.end_time_unix_nano = int(starts[i] + durs[i])
            s.status.code = int(kinds[i] == 2) * 2
            a = s.attributes.add()
            if kinds[i] == 1:
                a.key, a.value.string_value = "rpc.system", "grpc"
            else:
                a.key, a.value.int_value = "http.status_code", 200
            a = s.attributes.add()
            a.key, a.value.int_value = "net.peer.port", 8080
        out.append(req.SerializeToString())
    return out


def server_traffic(rng, window, t_data):
    """Phase 16's frames, a list per stream, with what the checks need
    (the RED windows' columns and groups, the counts per stream)."""
    import zlib

    from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
    from deepflow_tpu_torch.utils import snappy
    from deepflow_tpu_torch.wire import MessageType
    from deepflow_tpu_torch.wire.gen import telemetry_pb2
    t0 = time.perf_counter()
    seqr = FrameSequencer()
    cut = {k: v[:SRV_L4] for k, v in window.items()}
    l4 = seqr.columnar(l4_wide(rng, cut, t_data), 0, SRV_L4)
    pool, group = red_services(rng, AppSuiteConfig())
    red, red_cols, red_groups = [], [], []
    for w in range(SRV_RED_WINDOWS):
        cols, pick = red_server_window(rng, pool, SRV_RED_RECORDS)
        red.append(seqr.pb(MessageType.PROTOCOLLOG, l7_pb_records(
            rng, cols, t_data + SRV_RED_STEP * w)))
        red_cols.append(cols)
        red_groups.append(group[pick])
    half = SRV_OTEL_SPANS // SRV_OTEL_PER_REQ // 2
    otel = [seqr.frame(MessageType.OPENTELEMETRY, p, 1)
            for p in otel_payloads(rng, half, SRV_OTEL_PER_REQ, t_data)] \
        + [seqr.frame(MessageType.OPENTELEMETRY_COMPRESSED,
                      zlib.compress(p), 1)
           for p in otel_payloads(rng, half, SRV_OTEL_PER_REQ, t_data)]
    pseq = raw_frames(seqr, MessageType.PACKETSEQUENCE,
                      pseq_blocks(rng, SRV_PSEQ_FLOWS, t_data * 1_000_000))
    prom = []
    per = SRV_PROM_SERIES // 4
    for part in range(4):
        wr = telemetry_pb2.WriteRequest()
        for i in range(part * per, (part + 1) * per):
            ts = wr.timeseries.add()
            ts.labels.add(name="__name__", value=f"node_metric_{i % 16}")
            ts.labels.add(name="instance",
                          value=f"10.1.{i // 256}.{i % 256}")
            ts.labels.add(name="job", value=f"job{i % 8}")
            vals = rng.normal(100, 30, SRV_PROM_SAMPLES)
            for k in range(SRV_PROM_SAMPLES):
                ts.samples.add(value=float(vals[k]),
                               timestamp=(t_data + k) * 1000)
        body = wr.SerializeToString()
        if part == 3:      # a direct remote-write sender: bare, snappy
            prom.append(seqr.frame(MessageType.PROMETHEUS,
                                   snappy.compress(body), 1))
        else:
            pm = telemetry_pb2.PrometheusMetric(
                metrics=body, extra_label_names=["cluster"],
                extra_label_values=["prod"])
            prom.append(seqr.frame(MessageType.PROMETHEUS,
                                   pm.SerializeToString(), 1))
    lines = [f"cpu,host=h{i % 32},cpu=c{i % 4} usage_idle="
             f"{rng.uniform(0, 100):.3f},usage_user={rng.uniform(0, 50):.3f}"
             f" {(t_data + i % 60) * 1_000_000_000}"
             for i in range(SRV_TELEGRAF_LINES)]
    telegraf = [seqr.frame(MessageType.TELEGRAF,
                           "\n".join(lines[s:s + 1024]).encode(), 1)
                for s in range(0, SRV_TELEGRAF_LINES, 1024)]
    procs = []
    for i in range(SRV_PROC_EVENTS):
        ev = telemetry_pb2.ProcEvent(
            pid=100 + i % 97, thread_id=i, pod_id=i % 7,
            start_time=(t_data + i % 60) * 1_000_000_000,
            end_time=(t_data + i % 60) * 1_000_000_000
            + int(rng.integers(0, 1 << 24)),
            event_type=telemetry_pb2.IoEvent)
        ev.io_event_data.bytes_count = int(rng.integers(0, 1 << 20))
        ev.io_event_data.operation = telemetry_pb2.Read
        ev.io_event_data.filename = f"/data/f{i % 50}.log\x00".encode()
        procs.append(ev.SerializeToString())
    alarms = [telemetry_pb2.AlarmEvent(
        timestamp=t_data + i % 60, policy_id=i % 8,
        policy_name=f"policy-{i % 8}", event_level=i % 3,
        alarm_target=f"svc-{i % 32}",
        trigger_value=float(rng.uniform(0, 1000))).SerializeToString()
        for i in range(SRV_ALARMS)]
    events = seqr.pb(MessageType.PROC_EVENT, procs) \
        + seqr.pb(MessageType.ALARM_EVENT, alarms)
    funcs = ["main", "serve", "handle", "query", "encode", "gc", "read"]
    profiles = seqr.pb(MessageType.PROFILE, [telemetry_pb2.Profile(
        timestamp=(t_data + i % 60) * 1_000_000_000,
        app_service=f"svc-{i % 16}", pid=200 + i % 13, vtap_id=1,
        pod_id=i % 5, event_type="on-cpu",
        stack=";".join(funcs[int(k)] for k in rng.integers(0, 7, 4)),
        value=int(rng.integers(1, 1 << 20))).SerializeToString()
        for i in range(SRV_PROFILES)])
    statsd = "\n".join(f"api.rps.{i % 8}:{int(rng.integers(0, 500))}|c"
                       f"|#env:prod,az:{i % 3}" for i in range(256))
    pcap = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    droplet = [seqr.frame(MessageType.SYSLOG, "".join(
        f"<14>host{i % 4} app: request {i} done\n"
        for i in range(512)).encode(), 1),
        seqr.frame(MessageType.STATSD, statsd.encode(), 1)] \
        + [seqr.frame(MessageType.RAW_PCAP, pcap[s:s + 16384],
                      1 + s // 16384 % 3)
           for s in range(0, len(pcap), 16384)]
    return {"l4": l4, "red": red, "red_cols": red_cols,
            "red_groups": red_groups, "otel": otel, "pseq": pseq,
            "prom": prom, "telegraf": telegraf, "events": events,
            "profiles": profiles, "droplet": droplet,
            "counts": {"prom": SRV_PROM_SERIES * SRV_PROM_SAMPLES,
                       "telegraf": 2 * SRV_TELEGRAF_LINES,
                       "events": SRV_PROC_EVENTS + SRV_ALARMS,
                       "profiles": SRV_PROFILES, "statsd": 256,
                       "syslog": 512, "pcap": len(pcap)},
            "build_s": time.perf_counter() - t0}


def server_config(root):
    """Phase 16's deployment as a JSON config: the controller off, the
    querier on, self-telemetry on, one decoder a stream, the sketch and
    RED lanes with their windows closed by hand (flush_window(now)), the
    RED lane's le buckets, the incident bundles beside the store."""
    cfg = {"controller": {"enabled": False},
           "ingester": {"port": 0, "store_path": os.path.join(root, "store"),
                        "n_decoders": 1, "tpu_sketch_window_s": 3600,
                        "app_red_window_s": 3600,
                        "app_red_prom_buckets": SRV_PROM_BUCKETS,
                        # beside the store, not in it: a Store reopened on
                        # reload reads <root>/<db>/<table>/manifest.json,
                        # and a bundle's manifest is not a table's
                        "incident_dir": os.path.join(root, "incidents")},
           "querier": {"enabled": True, "port": 0},
           "self_telemetry": True}
    path = os.path.join(root, "server.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def http_json(url, form=None):
    import urllib.parse
    import urllib.request
    data = None if form is None else urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=30) as r:
        return json.loads(r.read())


def sorted_rows(cols):
    """Columns with their rows sorted (integer columns first)."""
    if not cols or not len(next(iter(cols.values()))):
        return cols
    keys = sorted(cols, key=lambda k: (cols[k].dtype.kind == "f", k))
    order = np.lexsort([cols[k] for k in reversed(keys)])
    return {k: cols[k][order] for k in keys}


def store_rows(root):
    """{(db, table): sorted rows} of every table of a store."""
    from deepflow_tpu_torch.store.db import Store
    store = Store(root)
    return {(db, name): sorted_rows(store.table(db, name).scan())
            for db, name in store.tables()}


def dir_bytes(root, prefix=""):
    """{name: bytes} of a directory's files whose name starts with
    `prefix`."""
    out = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isfile(p) and name.startswith(prefix):
            with open(p, "rb") as f:
                out[name] = f.read()
    return out


def profile_red_flush(torch, dev, red, now):
    """The last RED window's flush, le buckets on, under torch.profiler
    between two marks: wall time, syncs by kind, device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mark(torch, dev)
        t0 = time.perf_counter()
        red.flush_window(now=now)
        wall = time.perf_counter() - t0
        mark(torch, dev)
    s = trace_session(torch, prof, wall)
    return {"wall_ms": wall * 1e3, "syncs": {k: s["runtime_calls"][k]
                                             for k in SYNC_CALLS},
            "d2h_copy_activities": s["d2h_copy_activities"],
            "memcpy_calls": s["memcpy_calls"]}


SRV_SQL = ("SELECT Count(*) AS n FROM l7_flow_log", "flow_log")
# the range starts two steps before the first window's sample: rate()
# then extrapolates every series of a service by the same half interval
# (a range starting one step before lets the zero-point limit cut some
# series' extrapolation, which bends the quantile)
SRV_PROMQL = ("histogram_quantile(0.95, rate(app_rrt_bucket"
              "{service_group=~\"%s\"}"
              f"[{(SRV_RED_WINDOWS + 1) * SRV_RED_STEP}s]))")


def sampled_services(groups):
    return np.linspace(0, groups - 1, SRV_SAMPLED).astype(int)


def served_answers(dev, srv, t_data):
    """One SQL and one PromQL request through the Server's HTTP (the p95
    of the sampled services), and the same through the engines directly
    on its store: equal."""
    import urllib.parse

    from deepflow_tpu_torch.querier.engine import QueryEngine
    from deepflow_tpu_torch.querier.promql import PromEngine
    ing = srv.ingester
    base = f"http://127.0.0.1:{srv.querier.port}"
    at = t_data + SRV_RED_STEP * SRV_RED_WINDOWS
    promql = SRV_PROMQL % "|".join(
        str(g) for g in sampled_services(ing.app_red.cfg.groups))
    t0 = time.perf_counter()
    sql = http_json(f"{base}/v1/query", form={"db": SRV_SQL[1],
                                               "sql": SRV_SQL[0]})
    prom = http_json(f"{base}/api/v1/query?" + urllib.parse.urlencode(
        {"query": promql, "time": at}))
    http_s = time.perf_counter() - t0
    d_sql = QueryEngine(ing.store, ing.tag_dicts, device=dev).execute(
        SRV_SQL[0], db=SRV_SQL[1]).as_dict()
    d_prom = PromEngine(ing.store, ing.tag_dicts, device=dev).query(
        promql, at=at)
    if json.dumps(sql.get("result"), sort_keys=True) != \
            json.dumps(d_sql, sort_keys=True):
        raise AssertionError("phase 16: /v1/query differs from QueryEngine")
    if prom.get("status") != "success" or json.dumps(
            prom["data"]["result"], sort_keys=True) != json.dumps(
            d_prom, sort_keys=True):
        raise AssertionError("phase 16: /api/v1/query differs from "
                             "PromEngine")
    return {"sql": d_sql, "prom": d_prom, "http_s": http_s}


def reload_answers(srv, path, before):
    """Reload with a changed config: the roles rebuild on the same store
    and answer the same SQL again."""
    with open(path) as f:
        cfg = json.load(f)
    cfg["ingester"]["throttle_per_s"] = 60_000
    with open(path, "w") as f:
        json.dump(cfg, f)
    old = srv.ingester
    t0 = time.perf_counter()
    srv.reload()
    if srv.reload_error is not None or srv.ingester is old \
            or srv.ingester.cfg.throttle_per_s != 60_000:
        raise AssertionError(f"phase 16: reload failed ({srv.reload_error})")
    got = http_json(f"http://127.0.0.1:{srv.querier.port}/v1/query",
                    form={"db": SRV_SQL[1], "sql": SRV_SQL[0]})["result"]
    if json.dumps(got, sort_keys=True) != json.dumps(before["sql"],
                                                     sort_keys=True):
        raise AssertionError("phase 16: the reloaded server answers "
                             f"{got}, before {before['sql']}")
    return {"reload_s": time.perf_counter() - t0}


def drive_server(torch, dev, path, traffic, t_data, card_run):
    """Start a Server from `path` on `dev`, feed every stream over one
    connection (each waited for before the next), close the sketch and
    RED windows by hand, ship one DFSTATS scrape; on the card run also
    profile the last RED flush, answer over HTTP and reload. Returns what
    the checks need, the server closed."""
    import socket

    from deepflow_tpu_torch.ops import cuda_hist
    from deepflow_tpu_torch.pipelines import flow_log
    from deepflow_tpu_torch.server import Server
    cuda = torch.device(dev).type == "cuda"
    res = {"rates": {}}
    # the row-id counter is process-wide: both runs start it at 1, so
    # their rows carry the same _id
    flow_log._ID_NEXT[0] = 1
    t_start = time.perf_counter()
    srv = Server(path, device=dev)
    try:
        srv.start()
        ing = srv.ingester
        red = ing.app_red
        http_json(f"http://127.0.0.1:{srv.querier.port}/v1/query", form={
            "db": "flow_log", "sql": "SELECT Count(*) AS n FROM l4_flow_log"})
        res["start_to_first_answer_s"] = time.perf_counter() - t_start
        # the shipper's 10 s background scrape would add DFSTATS frames
        # while the streams are counted: it is stopped, and one scrape is
        # shipped by hand after the ingest
        ing.stats.stop()
        if cuda:
            torch.cuda.synchronize()
        zero_launches()
        # hist's launches by width: the wrapper counts into the module's
        # `hist_add_cuda.launches`, which is this shim's while it stands
        widths = {}
        orig = cuda_hist.hist_add_cuda

        def counting(acc, idx, width, *a, **k):
            out = orig(acc, idx, width, *a, **k)
            widths[width] = widths.get(width, 0) + 1
            return out
        counting.launches = 0
        cuda_hist.hist_add_cuda = counting
        sent = 0
        conn = socket.create_connection(("127.0.0.1", ing.port))
        try:
            def stream(name, frames, done, records):
                nonlocal sent
                t0 = time.perf_counter()
                for f in frames:
                    conn.sendall(f)
                sent += len(frames)
                wait_for(done, f"phase 16: {name}", timeout=600)
                dt = time.perf_counter() - t0
                res["rates"][name] = {"records": records, "s": dt,
                                      "records_per_s": records / dt}
            stream("l4 (COLUMNAR_FLOW)", traffic["l4"],
                   lambda: ing.tpu_sketch.rows_in == SRV_L4, SRV_L4)
            if not ing.tpu_sketch._feed.drain(120):
                raise AssertionError("phase 16: the feed did not drain")
            ing.tpu_sketch.flush_window(now=t_data + 120)
            flushes = []
            for w, frames in enumerate(traffic["red"]):
                n = SRV_RED_RECORDS * (w + 1)
                stream(f"l7 window {w} (PROTOCOLLOG)", frames,
                       lambda n=n: red.rows_in == n, SRV_RED_RECORDS)
                now = t_data + SRV_RED_STEP * (w + 1)
                c0 = red.counters()
                if cuda and card_run and w == SRV_RED_WINDOWS - 1:
                    flushes.append(profile_red_flush(torch, dev, red, now))
                else:
                    t0 = time.perf_counter()
                    red.flush_window(now=now)
                    flushes.append({"wall_ms": (time.perf_counter() - t0)
                                    * 1e3})
                c1 = red.counters()
                flushes[-1]["bucket_d2h_bytes"] = \
                    c1["bucket_d2h_bytes"] - c0["bucket_d2h_bytes"]
                flushes[-1]["d2h_transfers"] = \
                    c1["d2h_transfers"] - c0["d2h_transfers"]
            res["flushes"] = flushes
            otel = decoder(ing, "l7_flow_log.otel")
            stream("OTel (raw + zlib)", traffic["otel"],
                   lambda: otel.throttler.in_count == SRV_OTEL_SPANS,
                   SRV_OTEL_SPANS)
            pseq = decoder(ing, "l4_packet")
            stream("PACKETSEQUENCE", traffic["pseq"],
                   lambda: pseq.records == SRV_PSEQ_FLOWS, SRV_PSEQ_FLOWS)
            em, c = ing.ext_metrics, traffic["counts"]
            stream("Prometheus remote write", traffic["prom"],
                   lambda: em.samples == c["prom"], c["prom"])
            stream("Telegraf", traffic["telegraf"],
                   lambda: em.samples == c["prom"] + c["telegraf"],
                   c["telegraf"])
            stream("proc and alarm events", traffic["events"],
                   lambda: ing.event.events == c["events"], c["events"])
            stream("profiles", traffic["profiles"],
                   lambda: ing.profile.profiles == c["profiles"],
                   c["profiles"])
            dr = ing.droplet
            stream("syslog, StatsD, pcap", traffic["droplet"],
                   lambda: (dr.syslog_lines, dr.statsd_samples,
                            dr.pcap_bytes)
                   == (c["syslog"], c["statsd"], c["pcap"]),
                   c["syslog"] + c["statsd"])
        finally:
            conn.close()
            cuda_hist.hist_add_cuda = orig
            orig.launches += counting.launches
        if cuda:
            torch.cuda.synchronize()
        res["launches"] = {k: ctr.launches
                           for k, ctr in launch_counters().items()}
        res["hist_widths"] = widths
        res["frames_sent"] = sent
        # DFSTATS: one scrape through the shipper, back through the socket
        ing.stats.collect()
        srv.stats_shipper.flush()
        shipper = srv.stats_shipper.sender
        wait_for(lambda: shipper.pending_frames() == 0
                 and ing.receiver.rx_frames == sent + shipper.sent_frames,
                 "phase 16: the DFSTATS frames")
        md = ing.tag_dicts.get("metric_name")
        system = ing.store.table("deepflow_system", "ext_samples")

        def dfstats_landed():
            ing.flush()
            names = {md.decode(int(h)) for h in
                     set(system.scan(["metric"])["metric"].tolist())}
            return "receiver.rx_frames" in names
        wait_for(dfstats_landed, "phase 16: DFSTATS in deepflow_system")
        # a writer's own thread may still be appending what it took: wait
        # for the rows the queries read
        n_le = SRV_RED_WINDOWS * red.cfg.groups * len(red._bucket_les)
        for (db, name), n in (
                (("flow_log", "l7_flow_log"),
                 SRV_RED_WINDOWS * SRV_RED_RECORDS + SRV_OTEL_SPANS),
                (("ext_metrics", "ext_samples"),
                 c["prom"] + c["telegraf"] + c["statsd"] + n_le)):
            table = ing.store.table(db, name)
            wait_for(lambda: ing.flush() or table.row_count() == n,
                     f"phase 16: {db}.{name}'s rows")
        res["receiver"] = ing.receiver.counters()
        res["shipper"] = shipper.counters()
        res["decoders"] = {d.stream: d.counters()
                           for d in ing.flow_log.decoders}
        res["aux"] = {"ext": ing.ext_metrics.counters(),
                      "event": ing.event.counters(),
                      "profile": ing.profile.counters(),
                      "droplet": ing.droplet.counters()}
        res["exporters"] = ing.exporters.counters()
        res["sketch"] = ing.tpu_sketch.counters()
        res["red"] = red.counters()
        if card_run:
            res["http"] = served_answers(dev, srv, t_data)
            res["reload"] = reload_answers(srv, path, res["http"])
    finally:
        srv.close()
    with open(path) as f:
        root = json.load(f)["ingester"]["store_path"]
    res["tables"] = store_rows(root)
    res["droplet"] = dir_bytes(os.path.join(root, "droplet"))
    res["blobs"] = dir_bytes(os.path.join(root, "flow_log", "l4_packet"),
                             "batches-p")
    res["dicts"] = {n: sorted(v.decode().splitlines()) for n, v in
                    dir_bytes(os.path.join(root, "flow_tag")).items()}
    return res


def compare_server_runs(a, b, t_data, names):
    """The card run against the CPU twin: every table but deepflow_system
    (self-telemetry values differ by run) row for row, the sketch and RED
    tables' floats within rtol 1e-5; the droplet files and the l4_packet
    blobs byte for byte, the dictionaries entry for entry. Rows stamped by the wall
    clock: StatsD's compare without their timestamp; the sketch and RED
    windows that close() writes are left out (the card run's reload
    closes one ingester more)."""
    if sorted(a["tables"]) != sorted(b["tables"]):
        raise AssertionError(f"phase 16: tables {sorted(a['tables'])} vs "
                             f"{sorted(b['tables'])}")
    for key in a["tables"]:
        if key[0] == "deepflow_system":
            continue
        x, y = a["tables"][key], b["tables"][key]
        if sorted(x) != sorted(y):
            raise AssertionError(f"phase 16: {key} columns differ")
        if not x:
            continue
        split = []
        for cols in (x, y):
            late = cols["timestamp"] >= t_data + 600
            split.append(({k: v[~late] for k, v in cols.items()},
                          {} if key[0] == "tpu_sketch" else
                          sorted_rows({k: v[late] for k, v in cols.items()
                                       if k != "timestamp"})))
        for part in (0, 1):
            p, q = split[0][part], split[1][part]
            for col in q:
                if p[col].dtype != q[col].dtype \
                        or len(p[col]) != len(q[col]):
                    raise AssertionError(f"phase 16: {names} differ in "
                                         f"{key} {col}")
                if key[0] == "tpu_sketch" and q[col].dtype.kind == "f":
                    same = np.allclose(p[col], q[col], rtol=1e-5, atol=1e-6)
                else:
                    same = np.array_equal(p[col], q[col])
                if not same:
                    raise AssertionError(f"phase 16: {names} differ in "
                                         f"{key} {col}")
    for what in ("droplet", "blobs"):
        if a[what] != b[what]:
            raise AssertionError(f"phase 16: {names} differ in {what}")
    # the metric and label-set dictionaries also hold the self-telemetry
    # names, which differ by device: compared on the entries the
    # compared tables reference
    ext = a["tables"][("ext_metrics", "ext_samples")]
    used = {"metric_name.jsonl": set(ext["metric"].tolist()),
            "label_set.jsonl": set(ext["labels"].tolist())}
    if sorted(a["dicts"]) != sorted(b["dicts"]):
        raise AssertionError(f"phase 16: {names} differ in dictionaries")
    for name in a["dicts"]:
        x, y = a["dicts"][name], b["dicts"][name]
        if name in used:
            x, y = ([e for e in d if json.loads(e)["h"] in used[name]]
                    for d in (x, y))
        if x != y:
            raise AssertionError(f"phase 16: {names} differ in {name}")


def check_server_run(r, traffic, t_data, cfg):
    """One run's own checks: conservation hop by hop, no_handler 0, the
    tables' rows, the le rows per window, and the p95 of sampled services
    through histogram_quantile against the exact one."""
    from deepflow_tpu_torch.ops import ddsketch
    rc = r["receiver"]
    if rc["no_handler"] or rc["rx_duplicate"] or rc["rx_errors"] \
            or rc["rx_frames"] != r["frames_sent"] \
            + r["shipper"]["sent_frames"]:
        raise AssertionError(f"phase 16: receiver {rc}, {r['frames_sent']} "
                             f"sent + {r['shipper']['sent_frames']} DFSTATS")
    dc = r["decoders"]
    want = {"l4_flow_log": SRV_L4,
            "l7_flow_log": SRV_RED_RECORDS * SRV_RED_WINDOWS,
            "l7_flow_log.otel": SRV_OTEL_SPANS,
            "l4_packet": SRV_PSEQ_FLOWS}
    if any(dc[s]["records"] != n for s, n in want.items()) \
            or any(c["decode_errors"] for c in dc.values()):
        raise AssertionError(f"phase 16: decoders {dc}")
    ec = r["exporters"]
    if ec["put_errors"] or ec["shed"]:
        raise AssertionError(f"phase 16: registry {ec}")
    if r["sketch"]["rows_in"] != SRV_L4 or r["sketch"]["lost_rows"] \
            or r["red"]["rows_in"] != want["l7_flow_log"]:
        raise AssertionError("phase 16: exporter rows")
    aux = r["aux"]
    if aux["ext"]["decode_errors"] or aux["event"]["decode_errors"] \
            or aux["profile"]["decode_errors"]:
        raise AssertionError(f"phase 16: aux pipelines {aux}")
    t = r["tables"]
    for (db, name), n in ((("flow_log", "l4_flow_log"), SRV_L4),
                          (("flow_log", "l7_flow_log"),
                           want["l7_flow_log"] + SRV_OTEL_SPANS),
                          (("flow_log", "l4_packet"), SRV_PSEQ_FLOWS),
                          (("event", "perf_event"), SRV_PROC_EVENTS),
                          (("event", "alarm_event"), SRV_ALARMS),
                          (("profile", "in_process_profile"), SRV_PROFILES)):
        got = len(next(iter(t[(db, name)].values()))) if t[(db, name)] else 0
        if got != n:
            raise AssertionError(f"phase 16: {db}.{name} holds {got} rows, "
                                 f"{n} sent")
    md = {json.loads(x)["s"]: json.loads(x)["h"]
          for x in r["dicts"]["metric_name.jsonl"]}
    ext = t[("ext_metrics", "ext_samples")]
    le = ext["metric"] == md["app_rrt_bucket"]
    n_le = len(range(SRV_PROM_BUCKETS - 1, cfg.dd.buckets, SRV_PROM_BUCKETS))
    per_window = [int((le & (ext["timestamp"] == t_data + SRV_RED_STEP
                             * (w + 1))).sum())
                  for w in range(SRV_RED_WINDOWS)]
    if per_window != [cfg.groups * n_le] * SRV_RED_WINDOWS:
        raise AssertionError(f"phase 16: le rows per window {per_window}")
    out = {"le_rows_per_window": per_window}
    if "http" not in r:
        return out
    # rate() over the range takes the counters' rise from the first
    # sample in it, so windows 1-3 carry the quantile
    g = ddsketch.gamma(cfg.dd)
    limit = cfg.dd.alpha + (g ** SRV_PROM_BUCKETS - 1)
    est = {int(s["metric"]["service_group"]): float(s["value"][1])
           for s in r["http"]["prom"]}
    if len(est) != SRV_SAMPLED:
        raise AssertionError(f"phase 16: histogram_quantile answers "
                             f"{len(est)} services")
    rrt = np.concatenate([c["rrt_us"] for c in traffic["red_cols"][1:]])
    grp = np.concatenate(traffic["red_groups"][1:])
    worst = 0.0
    for gi in sampled_services(cfg.groups):
        exact = float(np.quantile(rrt[grp == gi], 0.95,
                                  method="inverted_cdf"))
        worst = max(worst, abs(est[int(gi)] - exact) / exact)
    if worst > limit:
        raise AssertionError(f"phase 16: p95 relative error {worst} > "
                             f"{limit}")
    out.update(p95_worst_rel_err=worst, p95_limit=limit)
    return out


def check_server(torch, dev, rng, windows, card):
    """Phase 16: one production cluster's ingester as server.py builds
    it, every ingest stream over loopback TCP, on the card and on the
    CPU."""
    from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
    cfg = AppSuiteConfig()
    t_data = (int(time.time()) // 60) * 60 - 1200
    traffic = server_traffic(rng, windows[0], t_data)
    log(f"  traffic built in {traffic['build_s']:.1f} s: "
        f"{len(traffic['l4'])} l4, {sum(len(f) for f in traffic['red'])} "
        f"l7, {len(traffic['otel'])} OTel, {len(traffic['pseq'])} "
        f"PACKETSEQUENCE, {len(traffic['prom'])} remote-write frames")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_srv_") as tmp:
        for name, d in (("card", dev), ("cpu", "cpu")):
            root = os.path.join(tmp, name)
            os.makedirs(root)
            t0 = time.perf_counter()
            runs[name] = drive_server(torch, d, server_config(root),
                                      traffic, t_data, name == "card")
            runs[name]["seconds"] = time.perf_counter() - t0
            runs[name]["checks"] = check_server_run(runs[name], traffic,
                                                    t_data, cfg)
        compare_server_runs(runs["card"], runs["cpu"], t_data,
                            "the card run and the CPU twin")
    r = runs["card"]
    launches, widths = r["launches"], r["hist_widths"]
    if not {cfg.groups * cfg.dd.buckets, cfg.groups} <= set(widths) \
            or launches["fused_lane_hists"] <= 0 \
            or launches["fused_news_hists"] <= 0:
        raise AssertionError(f"phase 16: launches {launches}, hist widths "
                             f"{widths}")
    fl = r["flushes"][-1]
    syncs = fl.get("syncs")
    if syncs is not None and (syncs["cudaStreamSynchronize"] != 2
                              or syncs["cudaEventSynchronize"]
                              or syncs["cudaDeviceSynchronize"]):
        raise AssertionError(f"phase 16: the le-bucket flush syncs {syncs}")
    plane = cfg.groups * cfg.dd.buckets * 4
    log(f"  on {card}")
    for s, v in r["rates"].items():
        log(f"  {s}: {v['records']} records in {v['s']:.3f} s, "
            f"{v['records_per_s']:.0f} records/s through the socket "
            f"(CPU twin {runs['cpu']['rates'][s]['records_per_s']:.0f})")
    log(f"  le rows per window {r['checks']['le_rows_per_window']}; flush "
        "wall ms " + ", ".join(f"{f['wall_ms']:.2f}" for f in r["flushes"])
        + "; device-to-host bytes gathered per window "
        f"{[f['bucket_d2h_bytes'] for f in r['flushes']]} against the full "
        f"plane's {plane}; copies per flush "
        f"{[f['d2h_transfers'] for f in r['flushes']]} (the readout and the "
        f"gathered rows); the profiled flush's syncs {syncs}, d2h copy "
        f"activities {fl.get('d2h_copy_activities')}")
    log(f"  histogram_quantile(0.95) over windows 1-3 against the exact "
        f"p95 of {SRV_SAMPLED} services: worst relative error "
        f"{r['checks']['p95_worst_rel_err']:.4f} (limit "
        f"{r['checks']['p95_limit']:.4f})")
    log(f"  server start to first answer {r['start_to_first_answer_s']:.2f}"
        f" s (CPU twin {runs['cpu']['start_to_first_answer_s']:.2f} s); "
        f"HTTP SQL + PromQL {r['http']['http_s'] * 1e3:.1f} ms = the "
        f"engines; reload {r['reload']['reload_s']:.2f} s; DFSTATS "
        f"{r['shipper']['sent_records']} records in deepflow_system; "
        f"launches {launches}, hist widths {widths}; card run "
        f"{r['seconds']:.1f} s, CPU twin {runs['cpu']['seconds']:.1f} s; "
        "every table, blob, artifact and dictionary = the CPU twin's")
    return {"launches": launches, "hist_widths": widths,
            "rates": {s: v["records_per_s"] for s, v in r["rates"].items()},
            "cpu_rates": {s: v["records_per_s"]
                          for s, v in runs["cpu"]["rates"].items()},
            "flushes": r["flushes"], "plane_bytes": plane,
            "checks": r["checks"],
            "start_to_first_answer_s": r["start_to_first_answer_s"],
            "cpu_start_to_first_answer_s":
                runs["cpu"]["start_to_first_answer_s"],
            "reload_s": r["reload"]["reload_s"],
            "http_s": r["http"]["http_s"], "build_s": traffic["build_s"],
            "card_s": r["seconds"], "cpu_s": runs["cpu"]["seconds"]}


# -- phase 17: an agent's l4 stream into the ingester --------------------------

AG_FLOWS = 1 << 16         # the FlowMap's table: concurrent flows at most
AG_TURNOVER = AG_FLOWS // 8   # flows that close (and open) every tick
AG_BATCH = 4096            # frames per capture batch (the dispatcher's batch)
AG_PACKETS = 1 << 18       # packets over the run (a cut for time)
AG_TICKS = 4               # one-second ticks
AG_SERVERS = 4096          # server endpoints, in 172.16.0.0/12
AG_PORTS = np.array([80, 443, 3306, 6379, 8080, 9092, 5432, 8443], np.uint32)
AG_ZIPF = 1.1              # packets over the live flows
AG_RETRANS = 0.01          # payload segments sent again after an RTO
AG_ZERO_WIN = 0.005        # ACKs that advertise a zero window
AG_HS_RETRANS = 0.02       # SYNs, and SYN/ACKs, sent twice
AG_VTAPS = 4               # (b): agents, each with a TAGGEDFLOW and a METRICS
#                            sender
AG_NOW = 5000.0            # (b): the sketch window's stamp
NS = 1_000_000_000
MS = 1_000_000
# eth / ipv4 (no options) / tcp (no options): 54 bytes, the fields that
# vary patched per packet
AG_HDR = np.frombuffer(
    b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00"
    + b"\x45\x00\x00\x00\x00\x00\x00\x00\x40\x06\x00\x00" + b"\x00" * 8
    + b"\x00" * 12 + b"\x50\x10\x20\x00\x00\x00\x00\x00", np.uint8)
_PSH_ACK, _ACK, _SYN, _FIN, _RST = 0x18, 0x10, 0x02, 0x01, 0x04


def _run_index(keys):
    """Position of each row inside its run of equal sorted keys."""
    n = len(keys)
    start = np.ones(n, np.bool_)
    start[1:] = keys[1:] != keys[:-1]
    pos = np.arange(n)
    return pos - np.maximum.accumulate(np.where(start, pos, 0))


class AgentFlows:
    """The generator's TCP connections: AG_FLOWS slots, each one live
    connection (client in 10.0.0.0/8 or 192.168.0.0/16, server one of
    AG_SERVERS endpoints in 172.16.0.0/12), with its sequence numbers and
    where it stands in its request/response cycle. Slot i draws packets
    at Zipf rank rank_of[i]. In tick 0, AG_FLOWS - AG_TURNOVER
    connections are already established (the capture starts mid-stream)
    and AG_TURNOVER open; every tick AG_TURNOVER established ones close
    at its end and as many new ones open in their slots in the next, so
    the FlowMap never holds more than AG_FLOWS."""

    def __init__(self, rng, l7=False):
        n = AG_FLOWS
        self.rng = rng
        # l7: payloads in the protocol of the server's port (phase 18);
        # they draw nothing from rng, so phase 17's stream is the same
        self.l7 = l7
        self.payloads = []
        self.srv_ip = (0xAC100000 + rng.integers(0, 1 << 20, AG_SERVERS)
                       ).astype(np.uint32)
        self.srv_port = rng.choice(AG_PORTS, AG_SERVERS)
        self.cip = np.zeros(n, np.uint32)
        self.cport = np.zeros(n, np.uint32)
        self.srv = np.zeros(n, np.int64)
        self.cseq = np.zeros(n, np.int64)
        self.sseq = np.zeros(n, np.int64)
        self.phase = np.zeros(n, np.int64)
        w = np.arange(1, n + 1, dtype=np.float64) ** -AG_ZIPF
        self.rank_p = w / w.sum()
        self.slot_of_rank = rng.permutation(n)
        self._renew(np.arange(n))
        self.opening = np.arange(n - AG_TURNOVER, n)

    def _renew(self, slots):
        rng, k = self.rng, len(slots)
        self.cip[slots] = np.where(
            rng.random(k) < 0.75, 0x0A000000 + rng.integers(0, 1 << 24, k),
            0xC0A80000 + rng.integers(0, 1 << 16, k))
        self.cport[slots] = rng.integers(1024, 1 << 16, k)
        self.srv[slots] = rng.integers(0, AG_SERVERS, k)
        self.cseq[slots] = rng.integers(0, 1 << 32, k)
        self.sseq[slots] = rng.integers(0, 1 << 32, k)
        self.phase[slots] = 0

    def tick(self, t, packets):
        """About `packets` packets of the second starting at t (ns),
        sorted by time, as columns: slot, up (client to server), flags,
        payload, seq, ack, win, ts. Handshakes in its first 10 ms, data
        between 10 and 990 ms (the 4-packet cycle client PSH/ACK, server
        ACK, server PSH/ACK, client ACK), retransmissions 200-300 ms after
        their segment, closes (3/4 FIN both ways, 1/4 RST) after 995 ms."""
        rng, n = self.rng, AG_FLOWS
        parts = []

        def add(slot, up, flags, payload, seq, ack, ts, win=8192, pidx=-1):
            k = len(slot)
            parts.append({"slot": slot, "up": np.broadcast_to(up, k),
                          "flags": np.broadcast_to(flags, k),
                          "payload": np.broadcast_to(payload, k),
                          "seq": seq, "ack": ack, "ts": ts,
                          "win": np.broadcast_to(win, k),
                          "pidx": np.broadcast_to(pidx, k)})
        # handshakes
        o = self.opening
        m = len(o)
        t0 = t + rng.integers(0, 3 * MS, m)
        c, s = self.cseq[o], self.sseq[o]
        add(o, True, _SYN, 0, c, np.zeros(m, np.int64), t0)
        d = rng.random(m) < AG_HS_RETRANS
        add(o[d], True, _SYN, 0, c[d], np.zeros(d.sum(), np.int64),
            t0[d] + 3 * MS // 2)
        add(o, False, _SYN | _ACK, 0, s, c + 1, t0 + 4 * MS)
        d = rng.random(m) < AG_HS_RETRANS
        add(o[d], False, _SYN | _ACK, 0, s[d], c[d] + 1, t0[d] + 5 * MS)
        add(o, True, _ACK, 0, c + 1, s + 1, t0 + 7 * MS)
        self.cseq[o] += 1
        self.sseq[o] += 1
        # which close, and how
        established = np.ones(n, np.bool_)
        established[o] = False
        closing = rng.choice(np.nonzero(established)[0], AG_TURNOVER,
                             replace=False)
        fin = rng.random(AG_TURNOVER) < 0.75
        fixed = sum(len(p["slot"]) for p in parts) \
            + 3 * int(fin.sum()) + int((~fin).sum())
        # data: the 4-packet cycle, the retransmissions on top
        n_data = int((packets - fixed) / (1 + AG_RETRANS / 2))
        slot = self.slot_of_rank[rng.choice(n, n_data, p=self.rank_p)]
        ts = t + rng.integers(10 * MS, 990 * MS, n_data)
        order = np.lexsort((ts, slot))
        slot, ts = slot[order], ts[order]
        ph = (self.phase[slot] + _run_index(slot)) % 4
        plen = np.where(ph % 2 == 0, rng.integers(64, 1401, n_data), 0)
        pidx = np.full(n_data, -1, np.int64)
        if self.l7:
            # a request on the client's PSH/ACK, a response on the
            # server's, each as long as its bytes
            data = np.nonzero(ph % 2 == 0)[0]
            base = len(self.payloads)
            ports = self.srv_port[self.srv[slot[data]]].tolist()
            self.payloads += [l7_payload(port, resp, base + j)
                              for j, (port, resp) in enumerate(
                                  zip(ports, (ph[data] == 2).tolist()))]
            pidx[data] = base + np.arange(len(data))
            plen[data] = [len(b) for b in self.payloads[base:]]
        cpl = np.where(ph == 0, plen, 0)
        spl = np.where(ph == 2, plen, 0)
        cin = np.cumsum(cpl)
        sin = np.cumsum(spl)
        first = np.ones(n_data, np.bool_)
        first[1:] = slot[1:] != slot[:-1]
        # segmented inclusive sums: subtract the running sum before the run
        run0 = np.maximum.accumulate(np.where(first, np.arange(n_data), 0))
        cin = cin - (cin - cpl)[run0]
        sin = sin - (sin - spl)[run0]
        up = ph % 3 == 0
        seq = np.where(up, self.cseq[slot] + cin - cpl,
                       self.sseq[slot] + sin - spl)
        ack = np.where(up, self.sseq[slot] + sin, self.cseq[slot] + cin)
        flags = np.where(ph % 2 == 0, _PSH_ACK, _ACK)
        win = np.where((ph % 2 == 1) & (rng.random(n_data) < AG_ZERO_WIN),
                       0, 8192)
        add(slot, up, flags, plen, seq, ack, ts, win, pidx)
        rt = rng.choice(np.nonzero(plen > 0)[0], packets - fixed - n_data,
                        replace=False)
        add(slot[rt], up[rt], flags[rt], plen[rt], seq[rt], ack[rt],
            np.minimum(ts[rt] + rng.integers(200 * MS, 300 * MS, len(rt)),
                       t + 993 * MS), win[rt], pidx[rt])
        np.add.at(self.cseq, slot, cpl)
        np.add.at(self.sseq, slot, spl)
        self.phase += np.bincount(slot, minlength=n)
        self.phase %= 4
        # closes
        f, r = closing[fin], closing[~fin]
        c, s = self.cseq[f], self.sseq[f]
        tf = t + 995 * MS + rng.integers(0, MS, len(f))
        add(f, True, _FIN | _ACK, 0, c, s, tf)
        add(f, False, _FIN | _ACK, 0, s, c + 1, tf + MS)
        add(f, True, _ACK, 0, c + 1, s + 1, tf + 2 * MS)
        side = rng.random(len(r)) < 0.5
        add(r, side, _RST, 0, np.where(side, self.cseq[r], self.sseq[r]),
            np.zeros(len(r), np.int64),
            t + 995 * MS + rng.integers(0, MS, len(r)))
        cols = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in parts[0]}
        order = np.argsort(cols["ts"], kind="stable")
        cols = {k: v[order] for k, v in cols.items()}
        sl, upc = cols.pop("slot"), cols["up"]
        sip, sport = self.srv_ip[self.srv[sl]], self.srv_port[self.srv[sl]]
        cols["ip_src"] = np.where(upc, self.cip[sl], sip)
        cols["ip_dst"] = np.where(upc, sip, self.cip[sl])
        cols["port_src"] = np.where(upc, self.cport[sl], sport)
        cols["port_dst"] = np.where(upc, sport, self.cport[sl])
        self._renew(closing)
        self.opening = closing
        return cols


def agent_frames(cols, payloads=None):
    """Raw Ethernet frames of a tick's packet columns: AG_HDR patched
    column by column, zero payload bytes behind it, or a packet's bytes
    from `payloads` where its `pidx` names one."""
    n = len(cols["ts"])
    hdr = np.tile(AG_HDR, (n, 1))
    plen = cols["payload"].astype(np.int64)

    def put(off, a, dt):
        hdr[:, off:off + np.dtype(dt).itemsize] = \
            np.asarray(a).astype(dt).view(np.uint8).reshape(n, -1)
    put(16, 40 + plen, ">u2")
    put(26, cols["ip_src"], ">u4")
    put(30, cols["ip_dst"], ">u4")
    put(34, cols["port_src"], ">u2")
    put(36, cols["port_dst"], ">u2")
    put(38, cols["seq"] & 0xFFFFFFFF, ">u4")
    put(42, cols["ack"] & 0xFFFFFFFF, ">u4")
    put(47, cols["flags"], "u1")
    put(48, cols["win"], ">u2")
    lens = 54 + plen
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.zeros(int(lens.sum()), np.uint8)
    buf[offs[:, None] + np.arange(54)] = hdr
    if payloads is not None:
        has = np.nonzero(cols["pidx"] >= 0)[0]
        body = np.frombuffer(b"".join(payloads[i] for i in
                                      cols["pidx"][has].tolist()), np.uint8)
        ln = plen[has]
        first = np.repeat(np.cumsum(ln) - ln, ln)
        buf[np.repeat(offs[has] + 54, ln) + np.arange(len(body)) - first] = \
            body
    raw = buf.tobytes()
    return [raw[o:o + k] for o, k in zip(offs.tolist(), lens.tolist())]


def same_maps(a, b, what):
    """Two FlowMaps' host state: every c_* column and TcpPerf array."""
    from deepflow_tpu_torch.agent.tcp_perf import TcpPerf
    cols = [k for k in vars(b) if k.startswith("c_")]
    assert_tables_equal({k: getattr(a, k) for k in cols},
                        {k: getattr(b, k) for k in cols}, what)
    assert_tables_equal({k: getattr(a.perf, k) for k in TcpPerf._FIELDS},
                        {k: getattr(b.perf, k) for k in TcpPerf._FIELDS},
                        what)
    if a.counters() != b.counters():
        raise AssertionError(f"{what}: {a.counters()} != {b.counters()}")


AG_NONZERO = ("rtt", "rtt_client", "rtt_server", "srt_sum", "srt_count",
              "srt_max", "art_sum", "art_count", "art_max", "cit_sum",
              "cit_count", "cit_max", "zero_win_tx", "zero_win_rx",
              "syn_count", "synack_count", "retrans_syn", "retrans_synack",
              "retrans", "retrans_tx", "rtt_client_sum", "rtt_server_sum")


def check_agent_leg(torch, dev, rng, card):
    """Phase 17(a): AG_PACKETS packets over AG_TICKS ticks through
    decode_packets, FlowMap(device=dev).inject in AG_BATCH-frame
    batches, tick_columns each second, the TaggedFlow records, and
    flows_to_documents(device=dev) with its METRICS records; the same
    decoded batches through a CPU twin, equal at every step. The last
    tick's card injects and Documents run under torch.profiler (syncs,
    launches, device time per batch)."""
    from deepflow_tpu_torch.agent import FlowMap, decode_packets
    from deepflow_tpu_torch.agent.quadruple import (documents_to_records,
                                                    flows_to_documents)
    from deepflow_tpu_torch.agent.trident import columns_to_l4_records
    flows = AgentFlows(rng)
    t_data = (int(time.time()) // 3600 + 2) * 3600
    maps = {"card": FlowMap(vtap_id=1, capacity=AG_FLOWS, device=dev),
            "cpu": FlowMap(vtap_id=1, capacity=AG_FLOWS, device="cpu")}
    wall = dict.fromkeys(("generate", "decode", "inject_card", "inject_cpu",
                          "tick_columns", "records", "documents"), 0.0)
    timed_packets = doc_ticks = 0
    warm = True
    l4, docs, sent, prof = [], [], [], {}
    packets = 0
    per_tick = AG_PACKETS // AG_TICKS
    for k in range(AG_TICKS):
        t = time.perf_counter()
        p = flows.tick((t_data + k) * NS, per_tick)
        frames = agent_frames(p)
        ts = p["ts"].astype(np.uint64)
        wall["generate"] += time.perf_counter() - t
        t = time.perf_counter()
        batches = [decode_packets(frames[i:i + AG_BATCH], ts[i:i + AG_BATCH])
                   for i in range(0, len(frames), AG_BATCH)]
        wall["decode"] += time.perf_counter() - t
        del frames
        packets += len(ts)

        def inject(name):
            for b in batches:
                maps[name].inject(b)
        if warm:
            # the reduction's first launches (lazy module loads) on a
            # scratch map, outside the timing
            FlowMap(capacity=AG_FLOWS, device=dev).inject(batches[0])
            warm = False
        if k == AG_TICKS - 1 and torch.device(dev).type == "cuda":
            prof["inject"] = profile_call(torch, dev,
                                          lambda: inject("card"), attempts=1)
            prof["inject"]["batches"] = len(batches)
            t = time.perf_counter()
            inject("cpu")
            prof["inject"]["cpu_wall_ms"] = (time.perf_counter() - t) * 1e3
        else:
            # the ticks both maps are timed over
            for name in ("card", "cpu"):
                t = time.perf_counter()
                inject(name)
                wall[f"inject_{name}"] += time.perf_counter() - t
            timed_packets += len(ts)
        now = (t_data + k + 1) * NS
        t = time.perf_counter()
        cols = maps["card"].tick_columns(now_ns=now)
        wall["tick_columns"] += time.perf_counter() - t
        cpu_cols = maps["cpu"].tick_columns(now_ns=now)
        assert_tables_equal(cpu_cols, cols,
                            f"phase 17 tick {k}: card vs CPU tick columns")
        t = time.perf_counter()
        recs = columns_to_l4_records(cols)
        wall["records"] += time.perf_counter() - t
        if recs != columns_to_l4_records(cpu_cols):
            raise AssertionError(f"phase 17 tick {k}: TaggedFlow records "
                                 "differ")
        if k == AG_TICKS - 1 and torch.device(dev).type == "cuda":
            # flows_to_documents changes no state: a session the profiler
            # recorded no kernel of is run again
            d = {}
            prof["documents"] = profile_call(
                torch, dev, lambda: d.update(
                    flows_to_documents(cols, t_data + k, device=dev)))
            drecs = documents_to_records(d)
        else:
            t = time.perf_counter()
            d = flows_to_documents(cols, t_data + k, device=dev)
            drecs = documents_to_records(d)
            wall["documents"] += time.perf_counter() - t
            doc_ticks += 1
        dc = flows_to_documents(cpu_cols, t_data + k, device="cpu")
        assert_tables_equal(dc, d, f"phase 17 tick {k}: card vs CPU "
                            "Documents")
        if drecs != documents_to_records(dc):
            raise AssertionError(f"phase 17 tick {k}: METRICS records "
                                 "differ")
        same_maps(maps["card"], maps["cpu"], f"phase 17 tick {k}")
        l4.append(recs)
        docs.append(drecs)
        sent.append(cols)
    allc = {c: np.concatenate([s[c] for s in sent]) for c in sent[0]}
    zero = [c for c in AG_NONZERO if not allc[c].any()]
    if zero:
        raise AssertionError(f"phase 17: columns never set: {zero}")
    # forced reports, FIN and RST closes (no flow idles past the timeout
    # in four seconds)
    closes = np.bincount(allc["close_type"], minlength=4).tolist()
    if not all(closes[:3]) or len(maps["card"]) > AG_FLOWS:
        raise AssertionError(f"phase 17: close types {closes}, "
                             f"{len(maps['card'])} live flows")
    rates = {n: timed_packets / wall[f"inject_{n}"] for n in maps}
    n_l4 = sum(len(r) for r in l4)
    n_docs = sum(len(r) for r in docs)
    r = {"packets": packets, "ticks": AG_TICKS, "batch": AG_BATCH,
         "flows_created": maps["card"].flows_created, "records": n_l4,
         "documents": n_docs, "close_types": closes,
         "inject_packets_per_s": rates, "wall_s": wall,
         "documents_ticks_timed": doc_ticks,
         "counters": maps["card"].counters(), "t_data": t_data}
    if prof:
        pi, pd = prof["inject"], prof["documents"]
        # the syncs fn made (profile_call's own synchronize is a device
        # sync between the markers)
        for x in (pi, pd):
            x["syncs"] = (x["runtime_calls"]["cudaStreamSynchronize"]
                          + x["runtime_calls"]["cudaEventSynchronize"])
        r["inject_profile"] = {
            "batches": pi["batches"], "syncs": pi["syncs"],
            "syncs_per_batch": pi["syncs"] / pi["batches"],
            "launches_per_batch": pi["kernels"] / pi["batches"],
            "device_ms_per_batch": pi["device_ms"] / pi["batches"],
            "kernel_ms_per_batch": pi["kernel_ms"] / pi["batches"],
            "wall_ms": pi["wall_ms"], "cpu_wall_ms": pi["cpu_wall_ms"],
            "runtime_calls": pi["runtime_calls"]}
        r["documents_profile"] = {
            "syncs": pd["syncs"], "launches": pd["kernels"],
            "device_ms": pd["device_ms"], "wall_ms": pd["wall_ms"],
            "attempts": pd["attempts"], "runtime_calls": pd["runtime_calls"]}
        if pi["syncs"] != pi["batches"] or pd["syncs"] != 1:
            raise AssertionError(
                f"phase 17: syncs {pi['syncs']} over {pi['batches']} "
                f"batches, {pd['syncs']} in flows_to_documents (one each "
                f"expected): {pi['runtime_calls']}, {pd['runtime_calls']}")
    tick_n = n_l4 / AG_TICKS
    log(f"  (a) on {card}: {packets} packets over {AG_TICKS} ticks in "
        f"{AG_BATCH}-frame batches, {maps['card'].flows_created} flows, "
        f"{n_l4} TaggedFlow records, {n_docs} Documents, close types "
        f"{closes}; card = CPU twin at every tick (columns, Documents, "
        f"records, map state); inject packets/s card {rates['card']:.0f}, "
        f"CPU {rates['cpu']:.0f} (ticks 0-{AG_TICKS - 2})"
        + ("" if not prof else
           f"; the last tick under the profiler "
           f"{r['inject_profile']['wall_ms']:.0f} ms (the CPU twin "
           f"{r['inject_profile']['cpu_wall_ms']:.0f} ms), per batch "
           f"{r['inject_profile']['launches_per_batch']:.1f} launches, "
           f"{r['inject_profile']['syncs_per_batch']:.2f} syncs, "
           f"{r['inject_profile']['device_ms_per_batch']:.4f} device ms; "
           f"flows_to_documents {pd['kernels']} launches, {pd['syncs']} "
           f"sync, {pd['device_ms']:.4f} device ms")
        + f"; tick wall per tick ({tick_n:.0f} records): tick_columns "
        f"{wall['tick_columns'] / AG_TICKS * 1e3:.1f} ms, records "
        f"{wall['records'] / AG_TICKS * 1e3:.1f} ms, Documents "
        f"{wall['documents'] / doc_ticks * 1e3:.1f} ms; generate "
        f"{wall['generate']:.1f} s, decode {wall['decode']:.1f} s")
    return r, l4, docs, allc


def topk_against_exact(out, cols, k):
    """The window's top-K against an exact GROUP BY of the 5-tuples.
    An agent reports a flow at most once a tick, so the exact top-K of
    its stream ends in a tie among the flows live in every tick: a
    reported key counts as a hit when its exact count reaches the K-th
    largest. Returns (tie-aware recall, K-th count, keys at or above it,
    strict recall, reported keys whose count is below their exact count
    (the Count-Min never underestimates), reported keys never sent)."""
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    keys = fold_columns_np([cols["ip_src"], cols["ip_dst"], cols["port_src"],
                            cols["port_dst"], cols["proto"]])
    uniq, counts = np.unique(keys, return_counts=True)
    kth = int(np.sort(counts)[-k])
    count = dict(zip(uniq.tolist(), counts.tolist()))
    got = out.topk_keys.cpu().numpy().view(np.uint32).tolist()
    est = out.topk_counts.cpu().numpy().tolist()
    hits = sum(count.get(g, 0) >= kth for g in got)
    under = sum(c < count.get(g, 0) for g, c in zip(got, est))
    unknown = sum(g not in count for g in got)
    return (hits / k, kth, int((counts >= kth).sum()),
            recall(out, cols, k), under, unknown)


def check_agent_ingester(torch, dev, l4, docs, allc, card):
    """Phase 17(b): the records of (a) into the port's Ingester as phase
    13(b) runs it, through AG_VTAPS agents' UniformSenders (a TAGGEDFLOW
    and a METRICS sender each, one connection each; each agent ships a
    quarter of every tick; all agents send their TaggedFlow records at
    once, the window is flushed, then their Documents), then the same
    TaggedFlow records decoded here and put straight into a yardstick
    exporter: the partition-free leaves equal."""
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.pipelines import Ingester
    from deepflow_tpu_torch.runtime.tracing import default_tracer
    from deepflow_tpu_torch.wire import MessageType
    n_l4, n_docs = sum(len(r) for r in l4), sum(len(r) for r in docs)
    shares = []
    for v in range(AG_VTAPS):
        shares.append([(recs[v * len(recs) // AG_VTAPS:
                             (v + 1) * len(recs) // AG_VTAPS],
                        drecs[v * len(drecs) // AG_VTAPS:
                              (v + 1) * len(drecs) // AG_VTAPS])
                       for recs, drecs in zip(l4, docs)])
    counters = launch_counters()
    tr = default_tracer()
    cuda = torch.device(dev).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_agent_") as tmp:
        cfg = ingester_config(tmp)
        ing = Ingester(cfg, device=dev)
        assert_native_registered(ing, "phase 17")
        exp = ing.tpu_sketch
        snaps = bus_snapshots(exp)
        senders = []
        try:
            ing.start()
            addr = f"127.0.0.1:{ing.port}"
            senders = [(UniformSender(MessageType.TAGGEDFLOW, addr,
                                      vtap_id=v + 1),
                        UniformSender(MessageType.METRICS, addr,
                                      vtap_id=v + 1))
                       for v in range(AG_VTAPS)]
            tr.reset()
            if cuda:
                torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            errs = []

            def agent(v, kind):
                try:
                    for tick in shares[v]:
                        senders[v][kind].send(tick[kind])
                except Exception as e:  # noqa: BLE001 -- re-raised below
                    errs.append(e)

            def ship(kind):
                ts = [threading.Thread(target=agent, args=(v, kind))
                      for v in range(AG_VTAPS)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if errs:
                    raise errs[0]
            # the TaggedFlow records first, then the Documents: the l4
            # rate is phase 13 (b)'s measure, with no Python METRICS
            # decode holding the interpreter lock beside it
            t0 = time.perf_counter()
            ship(0)
            wait_for(lambda: exp.rows_in == n_l4, "phase 17: the sketch "
                     "exporter")
            t_rows = time.perf_counter() - t0
            out = exp.flush_window(now=AG_NOW)
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            ship(1)
            wait_for(lambda: ing.flow_metrics.records == n_docs,
                     "phase 17: the flow_metrics lane")
            dt_docs = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            lat = tr.latency()
            busy_s = {s: sk.sum for s, sk in tr.stages().items()}
            rc, ec = ing.receiver.counters(), ing.exporters.counters()
            dc = [d.counters() for d in ing.flow_log.decoders
                  if d.stream == "l4_flow_log"]
            sc = [(a.counters(), b.counters()) for a, b in senders]
            fm_records, rows_in = ing.flow_metrics.records, exp.rows_in
        finally:
            for pair in senders:
                for x in pair:
                    x.close()
            ing.close()
            tr.disable()
        # the yardstick: the TaggedFlow records framed and decoded here
        y_sketch, y_red = yardstick(dev, cfg)
        y_snaps = bus_snapshots(y_sketch)
        try:
            y_sketch.start()
            y_red.start()
            frames = FrameSequencer().pb(MessageType.TAGGEDFLOW,
                                         [r for recs in l4 for r in recs])
            t = time.perf_counter()
            decoded_cols = [c for _, c in decode_frames(frames, ing.platform)]
            y_decode_s = time.perf_counter() - t
            t = time.perf_counter()
            for cols in decoded_cols:
                y_sketch.put("l4_flow_log", 0, cols)
            wait_for(lambda: y_sketch.rows_in == n_l4,
                     "phase 17: the yardstick")
            y_sketch.flush_window(now=AG_NOW)
            if cuda:
                torch.cuda.synchronize()
            y_export_s = time.perf_counter() - t
        finally:
            y_sketch.close()
            y_red.close()
    compare_snaps(y_snaps[:1], snaps[:1], WIRE_FREE_LEAVES,
                  "the yardstick", "phase 17 (b)")
    sent_l4 = sum(a["sent_records"] for a, _ in sc)
    sent_docs = sum(b["sent_records"] for _, b in sc)
    sent_frames = sum(a["sent_frames"] + b["sent_frames"] for a, b in sc)
    decoded = sum(d["records"] for d in dc)
    if not (sent_l4 == decoded == rows_in == n_l4) \
            or not (sent_docs == fm_records == n_docs) \
            or rc["rx_frames"] != sent_frames \
            or any(d["decode_errors"] for d in dc) or rc["no_handler"] \
            or rc["rx_duplicate"] or ec["put_errors"] or ec["shed"] \
            or any(x["retransmit_shed"] or x["dropped_records"]
                   for pair in sc for x in pair):
        raise AssertionError(f"phase 17 (b): sent {sent_l4} TaggedFlow / "
                             f"{sent_docs} Documents in {sent_frames} "
                             f"frames, decoded {decoded}, rows_in {rows_in}, "
                             f"flow_metrics {fm_records}: {rc} {dc} {ec} "
                             f"{sc}")
    for k in ("fused_news_hists", "fused_lane_hists"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 17 (b): kernel {k} never launched")
    k = FlowSuiteConfig().top_k
    rec, kth, tied, strict, under, unknown = topk_against_exact(out, allc, k)
    if under or unknown:
        raise AssertionError(f"phase 17 (b): of the top-{k}, {under} counts "
                             f"below their exact count, {unknown} keys never "
                             "sent")
    decode_share = busy_s["decode"] / dt
    stages = {st: {"count": lat[st]["count"],
                   "p50_ms": round(lat[st]["p50_ms"], 4),
                   "sum_s": round(busy_s[st], 4)}
              for st in sorted(lat) if st in busy_s}
    r = {"records": n_l4, "documents": n_docs, "frames": sent_frames,
         "seconds": dt, "records_per_s": n_l4 / dt,
         "rows_in_s": t_rows, "documents_s": dt_docs,
         "documents_per_s": n_docs / dt_docs, "stages": stages,
         "yardstick_decode_s": y_decode_s, "yardstick_export_s": y_export_s,
         "decode_share": decode_share, "launches": launches,
         "tie_recall": rec, "kth_count": kth, "keys_at_kth": tied,
         "strict_recall": strict}
    log(f"  (b) on {card}: {n_l4} TaggedFlow records and {n_docs} "
        f"Documents in {sent_frames} frames over {AG_VTAPS} agents x 2 "
        f"senders: {n_l4 / dt:.0f} TaggedFlow records/s through the socket "
        f"(first byte to the window flushed, {dt:.2f} s; rows_in complete "
        f"at {t_rows:.2f} s), then the Documents at {n_docs / dt_docs:.0f} "
        f"records/s ({dt_docs:.2f} s to the flow_metrics lane); "
        f"sent = decoded = "
        f"rows_in = {n_l4}, Documents sent = flow_metrics records = "
        f"{n_docs}, frames sent = received; partition-free leaves "
        f"{sorted(WIRE_FREE_LEAVES)} = the yardstick's; decode spans "
        f"{busy_s['decode']:.2f} s = {decode_share:.3f} of the wall; "
        f"launches {launches}; top-{k}: no count below its exact count, "
        f"recall {rec:.3f} with ties (K-th exact count {kth}, {tied} keys "
        f"at or above it), strict {strict:.3f}; stages {stages}; the "
        f"yardstick: Python decode + enrichment {y_decode_s:.2f} s, put() "
        f"to the window flushed {y_export_s:.2f} s "
        f"({n_l4 / y_export_s:.0f} records/s)")
    return r


def check_agent(torch, dev, rng, card):
    """Phase 17: (a) the agent leg on the card and its CPU twin, (b) its
    records into the ingester."""
    leg, l4, docs, allc = check_agent_leg(torch, dev, rng, card)
    ing = check_agent_ingester(torch, dev, l4, docs, allc, card)
    return {"agent": leg, "ingester": ing, "launches": ing["launches"],
            "card": card}



# -- phase 18: the agent process on the card --------------------------------

AP_PACKETS = 1 << 18       # packets over AG_TICKS ticks: cut from phase 17's
#                            2^19 for the per-packet L7 parse on the host
AP_DNS = 2048              # DNS queries a tick over UDP, 9/10 answered
AP_DNS_SERVERS = 4         # resolvers, in 172.31.0.0/24
AP_WAIT_S = 120            # (b): the longest wait for the server to take in
#                            the pcap's packets


def l7_payload(port, resp, i):
    """A request (or, `resp`, a response) in the protocol of the server
    port: HTTP/1.1 on 80 and 8080, a TLS ClientHello / ServerHello on
    443 and 8443, MySQL, Redis, Kafka and PostgreSQL on theirs."""
    if port in (80, 8080):
        if resp:
            return (f"HTTP/1.1 {(200, 200, 200, 404, 503)[i % 5]} X\r\n"
                    f"Content-Length: {i % 997}\r\n\r\n").encode()
        return (f"GET /api/v{i % 3}/items/{i % 4099}?page={i % 7} HTTP/1.1"
                f"\r\nHost: svc{i % 61}.prod\r\nUser-Agent: curl/8\r\n"
                f"X-Request-Id: {i:x}\r\n\r\n").encode()
    if port in (443, 8443):
        if resp:
            body = b"\x03\x03" + bytes(32) + b"\x00\x13\x01\x00"
            hs = b"\x02" + len(body).to_bytes(3, "big") + body
            return b"\x16\x03\x03" + len(hs).to_bytes(2, "big") + hs
        sni = f"api{i % 97}.example.com".encode()
        ext = (b"\x00\x00" + (len(sni) + 5).to_bytes(2, "big")
               + (len(sni) + 3).to_bytes(2, "big") + b"\x00"
               + len(sni).to_bytes(2, "big") + sni)
        body = (b"\x03\x03" + bytes(32) + b"\x00\x00\x02\x13\x01\x01\x00"
                + len(ext).to_bytes(2, "big") + ext)
        hs = b"\x01" + len(body).to_bytes(3, "big") + body
        return b"\x16\x03\x01" + len(hs).to_bytes(2, "big") + hs
    if port == 3306:
        if resp:
            body = b"\x00\x00\x00\x02\x00\x00\x00" if i % 9 else \
                b"\xff\x15\x04#28000denied"
            return len(body).to_bytes(3, "little") + b"\x01" + body
        q = f"\x03SELECT id, name FROM t{i % 13} WHERE id = {i}".encode()
        return len(q).to_bytes(3, "little") + b"\x00" + q
    if port == 6379:
        if resp:
            return b"$5\r\nvalue\r\n" if i % 11 else b"-ERR wrong type\r\n"
        key = f"session:{i % 100003}".encode()
        return (b"*2\r\n$3\r\nGET\r\n$" + str(len(key)).encode() + b"\r\n"
                + key + b"\r\n")
    if port == 9092:
        corr = (21 + i % 30000).to_bytes(4, "big")
        if resp:
            return (10).to_bytes(4, "big") + corr + bytes(6)
        client = f"producer-{i % 5}".encode()
        body = ((i % 4).to_bytes(2, "big") + (7).to_bytes(2, "big") + corr
                + len(client).to_bytes(2, "big") + client + bytes(8))
        return len(body).to_bytes(4, "big") + body
    # 5432: a simple query; RowDescription, or an ErrorResponse
    if resp:
        return (b"T\x00\x00\x00\x06\x00\x00" if i % 7 else
                b"E\x00\x00\x00\x0cSERROR\x00\x00\x00")
    q = f"SELECT a, b FROM t{i % 17} WHERE x = {i} AND y = 'v'\x00".encode()
    return b"Q" + (len(q) + 4).to_bytes(4, "big") + q


def udp_frame(src, dst, sport, dport, payload):
    ip = (b"\x45\x00" + (28 + len(payload)).to_bytes(2, "big")
          + b"\x00\x00\x00\x00\x40\x11\x00\x00" + src.to_bytes(4, "big")
          + dst.to_bytes(4, "big"))
    return (b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00" + ip
            + sport.to_bytes(2, "big") + dport.to_bytes(2, "big")
            + (8 + len(payload)).to_bytes(2, "big") + b"\x00\x00" + payload)


def dns_packets(rng, flows, t, n):
    """n DNS queries over UDP in the second starting at t (ns), from the
    generator's clients to AP_DNS_SERVERS resolvers, 9/10 answered 1-5 ms
    later: (stamps, frames)."""
    cli = flows.cip[rng.integers(0, AG_FLOWS, n)].tolist()
    cport = rng.integers(1024, 1 << 16, n).tolist()
    srv = (0xAC1F0000 + 1 + rng.integers(0, AP_DNS_SERVERS, n)).tolist()
    ts = t + rng.integers(0, 990 * MS, n)
    rtt = rng.integers(1 * MS, 5 * MS, n)
    answered = (rng.random(n) < 0.9).tolist()
    stamps, frames = [], []
    for j in range(n):
        name = b"".join(bytes([len(p)]) + p for p in (
            f"svc{j % 251}".encode(), b"prod", b"example", b"com")) + b"\x00"
        q = name + b"\x00\x01\x00\x01"
        head = j.to_bytes(2, "big")
        frames.append(udp_frame(cli[j], srv[j], cport[j], 53, head
                                + b"\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00"
                                + q))
        stamps.append(int(ts[j]))
        if answered[j]:
            rcode = 3 if j % 13 == 0 else 0
            frames.append(udp_frame(
                srv[j], cli[j], 53, cport[j], head
                + bytes([0x81, 0x80 | rcode]) + b"\x00\x01\x00\x01\x00\x00"
                + b"\x00\x00" + q + b"\xc0\x0c\x00\x01\x00\x01\x00\x00\x00"
                b"\x3c\x00\x04" + bytes([10, 0, j >> 8 & 255, j & 255])))
            stamps.append(int(ts[j] + rtt[j]))
    return np.asarray(stamps, np.int64), frames


def agent_process_traffic(rng, t_data):
    """AG_TICKS one-second ticks of about AP_PACKETS // AG_TICKS packets
    each: phase 17's TCP generator with protocol payloads, and DNS over
    UDP; per tick (frames, stamps) in stamp order."""
    flows = AgentFlows(rng, l7=True)
    ticks = []
    for k in range(AG_TICKS):
        t = (t_data + k) * NS
        d_ts, d_frames = dns_packets(rng, flows, t, AP_DNS)
        cols = flows.tick(t, AP_PACKETS // AG_TICKS - len(d_frames))
        frames = agent_frames(cols, flows.payloads) + d_frames
        ts = np.concatenate([cols["ts"], d_ts])
        order = np.argsort(ts, kind="stable")
        ticks.append(([frames[i] for i in order.tolist()],
                      ts[order].astype(np.uint64)))
    return ticks


class LoopbackSink:
    """A TCP receiver on localhost for one agent's senders: every
    connection's bytes, by message type."""

    def __init__(self):
        import socket
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.conns = []
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            buf, eof = bytearray(), threading.Event()
            with self._lock:
                self.conns.append((buf, eof))
            threading.Thread(target=self._read, args=(c, buf, eof),
                             daemon=True).start()

    @staticmethod
    def _read(c, buf, eof):
        with c:
            while True:
                chunk = c.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
        eof.set()

    def drain(self, senders, timeout=120):
        """Close the senders, wait for their connections' end; returns
        {message type: the bytes of every frame of that type, in order}."""
        want = 0
        for x in senders.values():
            x.close()
            want += x.sent_frames > 0
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                conns = list(self.conns)
            if len(conns) >= want and all(e.is_set() for _, e in conns):
                break
            if time.monotonic() > deadline:
                raise AssertionError("phase 18: an agent's senders never "
                                     "closed")
            time.sleep(0.01)
        out = {}
        for buf, _ in conns:
            if buf:
                out.setdefault(buf[4], []).append(bytes(buf))
        return {k: b"".join(v) for k, v in out.items()}

    def close(self):
        self.srv.close()


def _timed(obj, name, acc, key):
    """Replace obj.name by a wrapper that adds its wall time to acc[key]."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] += time.perf_counter() - t
    setattr(obj, name, timed)


def run_agent_inline(torch, dev, ticks, t_data):
    """Phase 18 (a), one agent: Agent(device=dev) on the defaults
    (columnar wire, L7 on) with packet_sequence on, fed every tick's
    frames in AG_BATCH-frame batches, ticked by hand; its senders into a
    LoopbackSink. Returns the streams, counters, rates and the tick's
    wall split."""
    from deepflow_tpu_torch.agent import trident
    from deepflow_tpu_torch.wire import MessageType
    sink = LoopbackSink()
    agent = trident.Agent(trident.AgentConfig(
        ingester_addr=f"127.0.0.1:{sink.port}", packet_sequence=True),
        device=dev)
    split = dict.fromkeys(("tick_columns", "columnar_flow", "documents",
                           "metrics_records", "protocollog",
                           "packet_sequence"), 0.0)
    valid = {"packets": 0, "bytes": 0}
    dispatch = agent.dispatcher.dispatch

    def counted(frames, stamps):
        pkt = dispatch(frames, stamps)
        valid["packets"] += int(pkt["valid"].sum())
        valid["bytes"] += int(pkt["pkt_len"][pkt["valid"]].sum())
        return pkt
    agent.dispatcher.dispatch = counted
    _timed(agent.flow_map, "tick_columns", split, "tick_columns")
    _timed(agent.senders[MessageType.COLUMNAR_FLOW], "send_columns", split,
           "columnar_flow")
    _timed(agent.senders[MessageType.METRICS], "send", split,
           "metrics_records")
    _timed(agent.senders[MessageType.PROTOCOLLOG], "send", split,
           "protocollog")
    _timed(agent.senders[MessageType.PACKETSEQUENCE], "send_raw_batch",
           split, "packet_sequence")
    module = {n: getattr(trident, n) for n in ("flows_to_documents",
                                               "documents_to_records")}
    _timed(trident, "flows_to_documents", split, "documents")
    _timed(trident, "documents_to_records", split, "metrics_records")
    feed_s = tick_s = 0.0
    packets = 0
    try:
        for k, (frames, stamps) in enumerate(ticks):
            t = time.perf_counter()
            for i in range(0, len(frames), AG_BATCH):
                packets += agent.feed(frames[i:i + AG_BATCH],
                                      stamps[i:i + AG_BATCH])
            feed_s += time.perf_counter() - t
            t = time.perf_counter()
            agent.tick((t_data + k + 1) * NS, final=k == len(ticks) - 1)
            tick_s += time.perf_counter() - t
        streams = sink.drain(agent.senders)
        r = {"streams": streams, "counters": agent.counters(),
             "unpaired": agent.sessions.unpaired, "valid": valid,
             "packets_per_s": packets / feed_s, "feed_s": feed_s,
             "tick_s": tick_s, "tick_split_s": split,
             "stream_bytes": {MessageType(mt).name: len(b)
                              for mt, b in streams.items()}}
    finally:
        for n, fn in module.items():
            setattr(trident, n, fn)
        agent.close()
        sink.close()
    return r


class L4Tally:
    """An exporter that sums what the server's l4 decoder puts: rows,
    packets and bytes (phase 18 (b)'s conservation count)."""

    name = "phase18_l4_tally"

    def __init__(self):
        self.rows = self.packets = self.bytes = 0
        self._lock = threading.Lock()

    def start(self):
        pass

    def close(self):
        pass

    def is_export_data(self, stream, cols):
        return stream == "l4_flow_log"

    def put(self, stream, decoder_index, cols):
        with self._lock:
            self.rows += len(cols["packet_tx"])
            self.packets += int(np.asarray(cols["packet_tx"], np.int64).sum()
                                + np.asarray(cols["packet_rx"],
                                             np.int64).sum())
            self.bytes += int(np.asarray(cols["byte_tx"], np.int64).sum()
                              + np.asarray(cols["byte_rx"], np.int64).sum())


def _column_sum(table, *cols):
    rows = table.scan()
    return sum(int(np.asarray(rows[c], np.int64).sum()) for c in cols)


def start_agent_process(torch, dev, tmp):
    """Phase 18 (b), first half: phase 16's server.Server on `dev` in this
    process (its l4 throttle raised: conservation is the check), an
    L4Tally on its registry, then `python -m deepflow_tpu_torch.agent`
    (engine pcap, packet sequence and self-telemetry on) reading its
    capture from a FIFO: its start-up runs beside (a), and its replay
    begins when replay_agent_process writes the pcap. Returns the run's
    state; the caller closes it with stop_agent_process."""
    from deepflow_tpu_torch.server import Server
    os.makedirs(os.path.join(tmp, "server"))
    path = server_config(os.path.join(tmp, "server"))
    with open(path) as f:
        cfg = json.load(f)
    # the ingest throttle samples l4 rows past 50,000 a second; this
    # agent ships up to AG_FLOWS a tick, and conservation is the check
    cfg["ingester"]["throttle_per_s"] = 1 << 24
    with open(path, "w") as f:
        json.dump(cfg, f)
    fifo = os.path.join(tmp, "capture.pcap")
    os.mkfifo(fifo)
    boot = os.path.join(tmp, "agent.json")
    run = {"srv": Server(path, device=dev), "tally": L4Tally(),
           "fifo": fifo, "proc": None}
    run["srv"].ingester.exporters.register(run["tally"])
    run["srv"].start()
    with open(boot, "w") as f:
        json.dump({"ingester_addr": f"127.0.0.1:{run['srv'].ingester.port}",
                   "packet_sequence": True, "self_telemetry": True,
                   "host": "phase18-node",
                   "capture": {"engine": "pcap", "path": fifo}}, f)
    run["t_spawn"] = time.perf_counter()
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "deepflow_tpu_torch.agent", "-f", boot,
         "--device", torch.device(dev).type],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return run


def stop_agent_process(run):
    proc = run["proc"]
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    run["srv"].close()


def replay_agent_process(torch, dev, run, ticks, t_data, inline, card):
    """Phase 18 (b), second half: the packets written into the FIFO with
    the port's PcapWriter, restamped by whole seconds from now (the
    per-second L7 budget and the session merge see (a)'s stamps, and the
    agent's wall-clock ticks meet live flows); once every valid packet is
    in the server's l4 rows, SIGTERM; then the conservation checks."""
    from deepflow_tpu_torch.agent.pcap import PcapWriter
    srv, tally, proc = run["srv"], run["tally"], run["proc"]
    ing = srv.ingester
    want = inline["valid"]
    sent_l7 = inline["counters"]["sent_protocollog"]
    if proc.poll() is not None:
        raise AssertionError(f"phase 18 (b): the agent process exited "
                             f"{proc.returncode} before the replay: "
                             f"{proc.stderr.read()[-3000:]}")
    zero_launches()
    t_b = int(time.time()) + 1
    shift = np.uint64((t_b - t_data) * NS)
    errs = []

    def write():
        try:
            w = PcapWriter(run["fifo"])      # opens once the agent reads
            for frames, stamps in ticks:
                w.write(frames, (stamps + shift).tolist())
            w.close()
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errs.append(e)
    t0 = time.perf_counter()
    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    t_first = None
    deadline = time.monotonic() + AP_WAIT_S
    while tally.packets < want["packets"] and proc.poll() is None \
            and time.monotonic() < deadline:
        if t_first is None and tally.rows:
            t_first = time.perf_counter()
        time.sleep(0.01)
    t_all = time.perf_counter()
    writer.join(timeout=60)
    if errs:
        raise errs[0]
    log(f"  (b) the l4 tally {t_all - t0:.2f} s after the pcap's first "
        f"byte ({t0 - run['t_spawn']:.2f} s after the spawn): "
        f"{tally.packets} of {want['packets']} packets")
    proc.send_signal(15)
    out, err = proc.communicate(timeout=120)
    t_exit = time.perf_counter()
    if proc.returncode != 0:
        raise AssertionError(f"phase 18 (b): the agent process exited "
                             f"{proc.returncode}: {err[-3000:]}")
    # the final tick's frames in, every ingest queue empty, then each
    # exporter has taken what the decoders put
    queues = list(ing._own_queues().values())
    last, still = -1, 0
    while still < 20:
        rx = ing.receiver.counters()["rx_frames"]
        busy = rx != last or any(len(q) for q in queues)
        still = 0 if busy else still + 1
        last = rx
        time.sleep(0.05)

    def decoded(stream):
        return sum(d.counters()["records"] for d in ing.flow_log.decoders
                   if d.stream == stream)
    wait_for(lambda: ing.tpu_sketch.rows_in == tally.rows
             and ing.app_red.rows_in == decoded("l7_flow_log"),
             "phase 18 (b): the server's exporters", timeout=120)
    # the windows closed by hand, as phase 16 closes them: the partial
    # batches go through the kernels
    ing.tpu_sketch.flush_window(now=float(t_b + AG_TICKS + 1))
    ing.app_red.flush_window(now=float(t_b + AG_TICKS + 1))
    ing.flush()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t_drained = time.perf_counter()
    launches = read_launches("phase 18 (b)", wants=(
        "hist", "fused_lane_hists", "fused_news_hists"))
    store = ing.store
    l4 = store.table("flow_log", "l4_flow_log")
    got = {"packets": _column_sum(l4, "packet_tx", "packet_rx"),
           "bytes": _column_sum(l4, "byte_tx", "byte_rx")}
    docs = store.table("flow_metrics", "vtap_flow_port")
    got_docs = {"packets": _column_sum(docs, "packet_tx", "packet_rx"),
                "bytes": _column_sum(docs, "byte_tx", "byte_rx")}
    l4_rows = l4.row_count()
    rows_in = ing.tpu_sketch.rows_in
    l7_rows = store.table("flow_log", "l7_flow_log").row_count()
    pseq_rows = store.table("flow_log", "l4_packet").row_count()
    system = store.table("deepflow_system", "ext_samples").scan()
    names = ing.tag_dicts.get("metric_name")
    agent_metrics = {}
    for h, v in zip(system["metric"].tolist(), system["value"].tolist()):
        name = names.decode(h) or ""
        if name.startswith("agent."):
            agent_metrics[name] = max(v, agent_metrics.get(name, v))
    streams = {}
    for d in ing.flow_log.decoders:
        streams[d.stream] = streams.get(d.stream, 0) + d.counters()["records"]
    streams["flow_metrics"] = ing.flow_metrics.records
    rc = ing.receiver.counters()
    if got != want or got_docs != want or tally.packets != want["packets"] \
            or not (tally.rows == l4_rows == rows_in):
        raise AssertionError(
            f"phase 18 (b): the pcap's valid {want}, the l4 rows {got} "
            f"({l4_rows} rows, tally {tally.rows} rows / {tally.packets} "
            f"packets, sketch rows_in {rows_in}), the Documents {got_docs}")
    if l7_rows != sent_l7:
        # the wall-clock expiry of pending requests is the one input (a)
        # does not share: bounded by the requests in flight at a tick
        gap = l7_rows - sent_l7
        log(f"  (b) l7 rows {l7_rows} against (a)'s {sent_l7} sessions: "
            f"gap {gap}")
        if abs(gap) > sent_l7 // 100:
            raise AssertionError(f"phase 18 (b): l7 rows {l7_rows}, (a) "
                                 f"sent {sent_l7}")
    if not pseq_rows or not any(n.startswith("agent.flow_map")
                                for n in agent_metrics):
        raise AssertionError(f"phase 18 (b): {pseq_rows} l4_packet rows, "
                             f"agent metrics {sorted(agent_metrics)[:8]}")
    breaches = [v for n, v in agent_metrics.items()
                if n.startswith("agent.guard") and "breaches" in n]
    wall = t_all - t0
    r = {"packets": want["packets"], "bytes": want["bytes"],
         "seconds_to_all_packets": wall,
         "seconds_first_row_to_all": (t_all - t_first) if t_first else None,
         "spawn_to_replay_s": t0 - run["t_spawn"],
         "packets_per_s": want["packets"] / wall,
         "exit_s": t_exit - t_all, "drain_s": t_drained - t_exit,
         "l4_rows": l4_rows, "l7_rows": l7_rows,
         "l4_packet_rows": pseq_rows, "records_per_stream": streams,
         "rx_frames": rc["rx_frames"], "agent_metrics": len(agent_metrics),
         "guard_breaches": max(breaches) if breaches else None,
         "launches": launches}
    log(f"  (b) on {card}: python -m deepflow_tpu_torch.agent over a pcap of "
        f"{sum(len(f) for f, _ in ticks)} frames ({want['packets']} valid) "
        f"through a FIFO into server.Server: every valid packet in the l4 "
        f"rows {wall:.2f} s after the pcap's first byte "
        f"({want['packets'] / wall:.0f} packets/s through the process"
        + (f"; {t_all - t_first:.2f} s from the first l4 row"
           if t_first else "")
        + f"), SIGTERM to exit 0 in {t_exit - t_all:.2f} s, the server "
        f"drained and its windows closed {t_drained - t_exit:.2f} s later; "
        f"l4 rows {l4_rows} = sketch rows_in, packets and bytes {got} = "
        f"the pcap's valid = the Documents' {got_docs}; l7 rows {l7_rows} "
        f"((a) sent {sent_l7}); {pseq_rows} l4_packet rows; "
        f"{len(agent_metrics)} agent DFSTATS series; frames received "
        f"{rc['rx_frames']}, records per stream {streams}; the Guard's "
        f"breaches {r['guard_breaches']}; launches {launches}")
    return r


def check_agent_process(torch, dev, rng, card):
    """Phase 18: the agent process on the card. (b)'s server and agent
    process start first; (a) the same batches through
    Agent(device="cuda") and Agent(device="cpu"); (b) the packets as a
    pcap through the agent process into the server."""
    from deepflow_tpu_torch.agent import FlowMap, decode_packets
    t0 = time.perf_counter()
    t_data = int(time.time())
    ticks = agent_process_traffic(rng, t_data)
    gen_s = time.perf_counter() - t0
    first = ticks[0]
    # the reduction's first launches (lazy module loads), outside (a)
    FlowMap(capacity=AG_FLOWS, device=dev).inject(
        decode_packets(first[0][:AG_BATCH], first[1][:AG_BATCH]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_agentproc_") as tmp:
        run = start_agent_process(torch, dev, tmp)
        try:
            runs = {name: run_agent_inline(torch, d, ticks, t_data)
                    for name, d in (("card", dev), ("cpu", "cpu"))}
            a = check_agent_inline(runs, gen_s, card)
            proc = replay_agent_process(torch, dev, run, ticks, t_data, a,
                                        card)
        finally:
            stop_agent_process(run)
    return {"inline": {n: {k: v for k, v in r.items() if k != "streams"}
                       for n, r in runs.items()},
            "process": proc, "launches": proc["launches"],
            "generate_s": gen_s}


def check_agent_inline(runs, gen_s, card):
    """Phase 18 (a)'s checks: the card agent's streams and counters =
    the CPU agent's, sessions conserved. Returns the card run."""
    from deepflow_tpu_torch.wire import MessageType
    a, b = runs["card"], runs["cpu"]
    if sorted(a["streams"]) != sorted(b["streams"]):
        raise AssertionError(f"phase 18 (a): message types "
                             f"{sorted(a['streams'])} != "
                             f"{sorted(b['streams'])}")
    for mt in b["streams"]:
        if a["streams"][mt] != b["streams"][mt]:
            raise AssertionError(f"phase 18 (a): the {MessageType(mt).name} "
                                 "bytes differ, card against CPU")
    if a["counters"] != b["counters"] or a["valid"] != b["valid"]:
        raise AssertionError(f"phase 18 (a): counters {a['counters']} != "
                             f"{b['counters']}")
    c = a["counters"]
    # every response the aggregator takes yields a session: paired ones
    # are `sessions_merged`, a response with no request pending
    # (retransmitted, or its request before the capture) is unpaired
    sessions = c["sessions_merged"] + a["unpaired"]
    if sessions != c["sent_protocollog"] + c["l7_throttled"] \
            or not c["sessions_merged"] or not c["sent_packetsequence"]:
        raise AssertionError(f"phase 18 (a): sessions {c['sessions_merged']}"
                             f" merged + {a['unpaired']} unpaired, sent "
                             f"{c['sent_protocollog']}, throttled "
                             f"{c['l7_throttled']}: {c}")
    split = {k: round(v / AG_TICKS * 1e3, 1)
             for k, v in a["tick_split_s"].items()}
    log(f"  (a) on {card}: {a['valid']['packets']} valid packets over "
        f"{AG_TICKS} ticks (generated in {gen_s:.1f} s); card agent "
        f"{a['packets_per_s']:.0f} packets/s, CPU agent "
        f"{b['packets_per_s']:.0f} (feed: decode, FlowMap, L7 parse); every "
        f"stream byte-equal ({a['stream_bytes']} bytes) and the counters "
        f"equal; "
        f"sessions {c['sessions_merged']} merged + {a['unpaired']} unpaired "
        f"= {c['sent_protocollog']} sent + {c['l7_throttled']} throttled; "
        f"tick wall per tick {a['tick_s'] / AG_TICKS * 1e3:.1f} ms, split "
        f"(ms) {split}")
    return a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-records", type=int, default=1 << 20)
    ap.add_argument("--ramp-records", type=int, default=1 << 18)
    ap.add_argument("--one-generator", action="store_true",
                    help="draw phase 2's rows for phase 9's shapes from "
                    "the generator phases 2-8 share")
    ap.add_argument("--dcn-worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-worker", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dcn_worker:
        return dcn_worker(*args.dcn_worker)
    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from deepflow_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_s = {}
    t_run = t0 = time.perf_counter()

    def phase_done(n):
        nonlocal t0
        phase_s[n] = time.perf_counter() - t0
        log(f"phase {n}: {phase_s[n]:.1f} s")
        t0 = time.perf_counter()

    # the native decoder builds (g++) while nvcc builds the kernels
    from deepflow_tpu_torch.decode import native
    native_build = threading.Thread(target=native.available)
    native_build.start()
    _build.load_all(verbose=True)
    native_build.join()
    if not native.available():
        raise AssertionError("phase 1: the native TAGGEDFLOW decoder did not "
                             f"build: {native.build_error()}")
    log(f"  native TAGGEDFLOW decoder: {native.so_path} (g++)")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if "registers" in line or line.endswith(".cu:") \
                    or "spill" in line:
                log("  " + line.strip())

    phase_done(1)
    rng = np.random.default_rng(args.seed)
    rng9 = np.random.default_rng((args.seed, 9))
    rng10 = np.random.default_rng((args.seed, 10))
    rng11 = np.random.default_rng((args.seed, 11))
    log("phase 2: kernels against their plain versions (bit-exact)")
    kernels, extra = check_kernels(torch, rng, dev,
                                   rng if args.one_generator else rng9,
                                   rng11)
    gate = check_gate(torch, dev, card)
    phase_done(2)

    log("phase 3: the slice at the exporter defaults")
    paths, runners, windows = check_slice(torch, dev, rng, args, card)
    phase_done(3)

    log("phase 4: small stream on the card against the CPU")
    check_small_against_cpu(torch, dev, rng)
    phase_done(4)

    log("phase 5: half a window of each path under torch.profiler")
    # half of window 0 (cut from the whole window for time: the trace's
    # post-processing grows with its events)
    profiles = profile_paths(torch, runners, [
        {k: v[:len(v) // 2] for k, v in windows[0].items()}])
    update_kernels = profile_full_row_update(torch, dev, rng)
    phase_done(5)

    log("phase 6: the exporter as the ingester runs it, with its writers")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ingester = run_ingester_paths(torch, dev, windows, card, tmp,
                                      paths["lanes_exporter_k4"]["snaps"])
        ladder = walk_ladder(torch, dev, rng, tmp)
        ingester_profiles = profile_ingester_paths(torch, dev, windows, tmp,
                                                   card)
        attribution = {"dict_feed": traced_profile(
            torch, dev, windows, tmp, card,
            ("dict_feed_traced",) + INGESTER_RUNS[0][1:],
            ingester_profiles["dict_feed"])}
        phase_done(6)
        log("phase 7: the detection lanes")
        detection = check_detection(torch, dev, rng, args, card, tmp)
        phase_done(7)
        log("phase 8: the L7 RED lane")
        red = check_red(torch, dev, rng, card, tmp)
        phase_done(8)
    log("phase 9: the multi-device suites (4 shards on one card)")
    shard, mesh_ref = check_sharded(torch, dev, rng9, args, windows, card)
    phase_done(9)
    log("phase 10: the flow_metrics store lane and the rollup GROUP BY, "
        "and phase 15 (a): the querier's SQL over its store")
    flow_metrics, querier = check_flow_metrics(
        torch, dev, rng10, card, lambda root, db, cols, t0:
        check_querier_sql(torch, dev, root, db, cols, t0, card))
    log(f"phase 15 (a): {querier['seconds']:.1f} s (inside phase 10)")
    phase_done(10)
    log("phase 11: the pod fault domains and the cross-host pod")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as tmp:
        pod = check_pod(torch, dev, windows, card, tmp)
    phase_done(11)
    log("phase 12: the global mesh across processes")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh = check_global_mesh(torch, dev, windows, mesh_ref, tmp, card)
    del mesh_ref
    phase_done(12)
    log("phase 13: the ingester entry point over loopback TCP")
    ingest = check_ingester(torch, dev, np.random.default_rng((args.seed, 13)),
                            windows, card,
                            ingester["dict_feed"]["records_per_s"])
    phase_done(13)
    log("phase 14: the operations surface under injected faults")
    ops = check_ops(torch, dev, np.random.default_rng((args.seed, 14)),
                    windows, card)
    phase_done(14)
    log("phase 15: serving and the querier ((b): the HTTP API on a live "
        "ingester)")
    serving = check_serving(torch, dev, np.random.default_rng((args.seed, 15)),
                            windows, card)
    phase_done(15)
    log("phase 16: the whole ingest surface and the server (server.py, "
        "the card and a CPU twin)")
    server = check_server(torch, dev, np.random.default_rng((args.seed, 16)),
                          windows, card)
    phase_done(16)
    log("phase 17: an agent's l4 stream (FlowMap on the card and a CPU "
        "twin) into the ingester")
    agent = check_agent(torch, dev, np.random.default_rng((args.seed, 17)),
                        card)
    phase_done(17)
    log("phase 18: the agent process (Agent on the card and a CPU twin, "
        "then python -m deepflow_tpu_torch.agent into server.Server)")
    agent_proc = check_agent_process(
        torch, dev, np.random.default_rng((args.seed, 18)), card)
    phase_done(18)
    log(f"phases: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
        f", {time.perf_counter() - t_run:.1f} s in all")

    totals = {}
    for launches in [p["launches"] for p in paths.values()] \
            + [p["launches"] for p in ingester.values()] \
            + list(detection["launches"].values()) + [red["launches"]] \
            + shard["launches"] + pod["launches"] + [mesh["launches"]] \
            + [ingest["launches"], ops["launches"], serving["launches"],
               server["launches"], agent["launches"],
               agent_proc["launches"]]:
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    for entry in kernels:
        entry["launches"] = totals[entry["name"].split("[")[0]]
    log(json.dumps({"paths": {
        name: {"records_per_s": p["records_per_s"], "recall": p["recall"],
               "launches": p["launches"], "profile": profiles[name]}
        for name, p in paths.items()}, "ingester_paths": {
        name: {"records_per_s": p["records_per_s"], "recall": p["recall"],
               "launches": p["launches"], "counters": p["counters"],
               "profile": ingester_profiles[name]}
        for name, p in ingester.items()}, "ladder": ladder,
        "attribution": attribution, "detection": detection, "red": red,
        "sharded": shard,
        "flow_metrics": flow_metrics, "pod": pod, "global_mesh": mesh,
        "ingester": ingest, "operations": ops, "querier": querier,
        "serving": serving, "server": server, "agent": agent,
        "agent_process": agent_proc, "gate": gate,
        "phase_seconds": phase_s,
        "kernel_inputs": extra, "full_row_update_kernels": update_kernels,
        "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
