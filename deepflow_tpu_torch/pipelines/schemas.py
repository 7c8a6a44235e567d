"""Store table schemas of the flow_log and flow_metrics pipelines.

The enriched l4/l7 tables are the decode schemas (`batch/schema.py`)
plus the KnowledgeGraph tag columns stamped by
`enrich/platform_data.py`, as the reference's row structs carry a
KnowledgeGraph block (log_data/l4_flow_log.go:226-266). The metrics
tables are generated from the tag-Code bitmask model
(`pipelines/tag_code.py`): the code names the dimensions and
`make_metrics_table` expands them plus the shared FlowMeter. Agg kinds
drive the rollup manager: KEY columns form the rollup group identity,
SUM/MAX columns aggregate, LAST columns pass through.

A copy of the JAX package's pipelines/schemas.py (this package imports
none of it).
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.batch.schema import (L4_SCHEMA, L7_SCHEMA,
                                             METRIC_SCHEMA)
from deepflow_tpu_torch.enrich.platform_data import (KG_DERIVED_FIELDS,
                                                     KG_FIELDS)
from deepflow_tpu_torch.pipelines.tag_code import (VTAP_FLOW_EDGE_PORT,
                                                   VTAP_FLOW_PORT,
                                                   make_metrics_table)
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema

_U32 = np.dtype(np.uint32)
_I32 = np.dtype(np.int32)

# which decode columns form the rollup group-by identity
_L4_KEYS = {"ip_src", "ip_dst", "port_dst", "proto", "vtap_id",
            "l3_epc_id", "tap_side", "timestamp"}
_L4_AGG = {
    # core
    "byte_tx": AggKind.SUM, "byte_rx": AggKind.SUM,
    "packet_tx": AggKind.SUM, "packet_rx": AggKind.SUM,
    "rtt": AggKind.MAX, "retrans": AggKind.SUM,
    "duration_us": AggKind.MAX,
    # metrics family (l4_flow_log.go Metrics :466)
    "l3_byte_tx": AggKind.SUM, "l3_byte_rx": AggKind.SUM,
    "l4_byte_tx": AggKind.SUM, "l4_byte_rx": AggKind.SUM,
    "total_byte_tx": AggKind.SUM, "total_byte_rx": AggKind.SUM,
    "total_packet_tx": AggKind.SUM, "total_packet_rx": AggKind.SUM,
    "l7_request": AggKind.SUM, "l7_response": AggKind.SUM,
    "l7_parse_failed": AggKind.SUM,
    "l7_client_error": AggKind.SUM, "l7_server_error": AggKind.SUM,
    "l7_server_timeout": AggKind.SUM,
    "rtt_client": AggKind.MAX, "rtt_server": AggKind.MAX,
    "tls_rtt": AggKind.MAX,
    "srt_sum": AggKind.SUM, "srt_count": AggKind.SUM,
    "srt_max": AggKind.MAX,
    "art_sum": AggKind.SUM, "art_count": AggKind.SUM,
    "art_max": AggKind.MAX,
    "rrt_sum": AggKind.SUM, "rrt_count": AggKind.SUM,
    "rrt_max": AggKind.MAX,
    "cit_sum": AggKind.SUM, "cit_count": AggKind.SUM,
    "cit_max": AggKind.MAX,
    "retrans_tx": AggKind.SUM, "retrans_rx": AggKind.SUM,
    "zero_win_tx": AggKind.SUM, "zero_win_rx": AggKind.SUM,
    "syn_count": AggKind.SUM, "synack_count": AggKind.SUM,
}


def _lift(batch_schema, keys, aggs) -> tuple:
    cols = []
    for name, dt in batch_schema.columns:
        if name in keys:
            agg = AggKind.KEY
        else:
            agg = aggs.get(name, AggKind.LAST)
        cols.append(ColumnSpec(name, np.dtype(dt), agg))
    return tuple(cols)


def _kg_columns(skip=()) -> tuple:
    """Columns stamped by PlatformDataManager per side: KG_FIELDS from the
    interface table plus the derived epc/service/auto_* set."""
    cols = []
    for side in ("0", "1"):
        for f in KG_FIELDS + KG_DERIVED_FIELDS:
            name = f"{f}_{side}"
            if name in skip:
                continue
            dt = _I32 if f == "epc_id" else _U32
            cols.append(ColumnSpec(name, dt, AggKind.KEY))
    return tuple(cols)


L4_TABLE = TableSchema(
    name="l4_flow_log",
    columns=_lift(L4_SCHEMA, _L4_KEYS, _L4_AGG) + _kg_columns(),
    time_column="timestamp",
    ttl_seconds=3 * 24 * 3600,
)

_L7_KEYS = {"ip_src", "ip_dst", "port_dst", "protocol", "l7_protocol",
            "msg_type", "vtap_id", "endpoint_hash", "timestamp"}
_L7_AGG = {"rrt_us": AggKind.MAX, "req_len": AggKind.SUM,
           "resp_len": AggKind.SUM, "status": AggKind.MAX}

# pod_id_0/1 are decode columns on L7 (eBPF-sourced); the stamp merges
# into them rather than adding a second pair
_L7_DECODED_KG = {"pod_id_0", "pod_id_1"}

L7_TABLE = TableSchema(
    name="l7_flow_log",
    columns=_lift(L7_SCHEMA, _L7_KEYS, _L7_AGG)
    + _kg_columns(skip=_L7_DECODED_KG),
    time_column="timestamp",
    ttl_seconds=3 * 24 * 3600,
)

# packet-sequence rows (reference: flow_log/log_data/l4_packet.go
# L4PacketColumns — time/start_time/end_time/flow_id/vtap_id/
# packet_count/packet_batch). The opaque packet_batch string column
# becomes (batch_off, batch_len) into an append-only sidecar blob file
# beside the table (this store is numeric-columnar by design); the
# batch content format is documented in agent/packet_sequence.py.
L4_PACKET_TABLE = TableSchema(
    name="l4_packet",
    columns=(
        ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("start_time_us", np.dtype(np.uint64)),
        ColumnSpec("end_time_us", np.dtype(np.uint64)),
        ColumnSpec("flow_id", np.dtype(np.uint64), AggKind.KEY),
        ColumnSpec("vtap_id", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("packet_count", np.dtype(np.uint32), AggKind.SUM),
        ColumnSpec("batch_off", np.dtype(np.uint64)),
        ColumnSpec("batch_len", np.dtype(np.uint32)),
    ),
    time_column="timestamp",
    ttl_seconds=3 * 24 * 3600,
)

# reference table name: flow_metrics."vtap_flow_port.1s"
# version 2: + tag_code (zerodoc Code bitmask as grouping identity)
METRICS_TABLE = make_metrics_table("vtap_flow_port", VTAP_FLOW_PORT,
                                   version=2)

# dtype lockstep with the decode side: the wire schema (METRIC_SCHEMA)
# and the generated store table must agree per column, or Table.append's
# astype would silently truncate a widened counter on write. Checked at
# import, with a real raise (python -O strips asserts).
for _c in METRICS_TABLE.columns:
    _wire_dt = dict(METRIC_SCHEMA.columns).get(_c.name)
    if _wire_dt is not None and np.dtype(_wire_dt) != _c.dtype:
        raise AssertionError(
            f"vtap_flow_port.{_c.name}: store dtype {_c.dtype} != wire "
            f"dtype {np.dtype(_wire_dt)} (METRIC_SCHEMA)")

# the edge-tag (client->server path) table schema: one line, as the
# tag-code model promises; nothing routes edge-coded Documents to it yet
EDGE_METRICS_TABLE = make_metrics_table("vtap_flow_edge_port",
                                        VTAP_FLOW_EDGE_PORT)


def register_standard_migrations(issu) -> None:
    """Schema-evolution history for stores created by older builds
    (reference ckissu role): every schema change lands here with its
    version bump, and the pipeline replays them at startup so an older
    data root picks up new columns instead of keeping the old manifest."""
    from deepflow_tpu_torch.store.migrate import AddColumn

    issu.register(2, AddColumn(
        "vtap_flow_port",
        ColumnSpec("tag_code", np.dtype(np.uint64), AggKind.KEY)))
