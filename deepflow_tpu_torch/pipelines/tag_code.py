"""zerodoc tag-Code model: the bitmask that GENERATES metric schemas.

Reference: server/libs/zerodoc/tag.go:36-104 — `Code` is a u64 bitmask
naming which tag dimensions a metrics table carries: single-ended
fields in bits 0..19, their edge (client->server path) variants at
<<20, global fields at <<40. The reference generates its whole
flow_metrics table family from these codes (MiniTag marshalling,
GetDBMeterID); hand-listed column sets would make every new meter
table a schema-editing exercise.

Here the same model generates TableSchemas: `make_metrics_table(name,
code)` expands the bitmask into the tag ColumnSpecs (bit order —
deterministic and append-stable) plus the shared FlowMeter column set,
so adding e.g. an edge-tag table is ONE line:

    EDGE_TABLE = make_metrics_table("vtap_flow_edge_port",
                                    VTAP_FLOW_EDGE_PORT)

Bit positions mirror tag.go exactly for the modeled subset; the two
extension bits (APP_SERVICE/ENDPOINT, the vtap_app dimension pair this
build folds into the same model) live in the reference's unused 56+
range and are documented as extensions.

A copy of the JAX package's pipelines/tag_code.py (this package imports
none of it): the tables it generates must equal the JAX package's
`to_json()` for `to_json()`, since both packages read one store.
"""

from __future__ import annotations

import enum
from typing import Dict, Tuple

import numpy as np

from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema

_U32 = np.dtype(np.uint32)
_I32 = np.dtype(np.int32)
_U64 = np.dtype(np.uint64)


class Code(enum.IntFlag):
    """tag.go:36-95 bit layout (modeled subset)."""

    # single-ended (bits 0..19)
    IP = 1 << 0
    L3_EPC_ID = 1 << 1
    SUBNET_ID = 1 << 3
    REGION_ID = 1 << 4
    POD_NODE_ID = 1 << 5
    HOST_ID = 1 << 6
    AZ_ID = 1 << 7
    POD_GROUP_ID = 1 << 8
    POD_NS_ID = 1 << 9
    POD_ID = 1 << 10
    POD_CLUSTER_ID = 1 << 12
    SERVICE_ID = 1 << 13
    GPID = 1 << 15
    # edge variants (<<20 of the single-ended bit, tag.go IPPath...)
    IP_PATH = 1 << 20
    L3_EPC_ID_PATH = 1 << 21
    SUBNET_ID_PATH = 1 << 23
    REGION_ID_PATH = 1 << 24
    POD_NODE_ID_PATH = 1 << 25
    HOST_ID_PATH = 1 << 26
    AZ_ID_PATH = 1 << 27
    POD_GROUP_ID_PATH = 1 << 28
    POD_NS_ID_PATH = 1 << 29
    POD_ID_PATH = 1 << 30
    POD_CLUSTER_ID_PATH = 1 << 32
    SERVICE_ID_PATH = 1 << 33
    GPID_PATH = 1 << 35
    # globals (1<<40 block, tag.go Direction...)
    DIRECTION = 1 << 40
    ACL_GID = 1 << 41
    PROTOCOL = 1 << 42
    SERVER_PORT = 1 << 43
    TAP_TYPE = 1 << 45
    VTAP_ID = 1 << 47
    TAP_SIDE = 1 << 48
    TAP_PORT = 1 << 49
    L7_PROTOCOL = 1 << 51
    SIGNAL_SOURCE = 1 << 52
    # extensions (reference-unused range): vtap_app dimensions
    APP_SERVICE = 1 << 56
    ENDPOINT = 1 << 57


EDGE_MASK = 0xFFFFF00000           # tag.go HasEdgeTagField


def has_edge_tag(code: Code) -> bool:
    return bool(int(code) & EDGE_MASK)


# bit -> the column(s) it expands to. Edge bits expand to the _0/_1
# pair the way MiniTag marshals IPPath as ip_0/ip_1.
_SINGLE: Dict[Code, Tuple[Tuple[str, np.dtype], ...]] = {
    Code.IP: (("ip", _U32),),
    Code.L3_EPC_ID: (("l3_epc_id", _I32),),
    Code.SUBNET_ID: (("subnet_id", _U32),),
    Code.REGION_ID: (("region_id", _U32),),
    Code.POD_NODE_ID: (("pod_node_id", _U32),),
    Code.HOST_ID: (("host_id", _U32),),
    Code.AZ_ID: (("az_id", _U32),),
    Code.POD_GROUP_ID: (("pod_group_id", _U32),),
    Code.POD_NS_ID: (("pod_ns_id", _U32),),
    Code.POD_ID: (("pod_id", _U32),),
    Code.POD_CLUSTER_ID: (("pod_cluster_id", _U32),),
    Code.SERVICE_ID: (("service_id", _U32),),
    Code.GPID: (("gprocess_id", _U32),),
    Code.DIRECTION: (("direction", _U32),),
    Code.ACL_GID: (("acl_gid", _U32),),
    Code.PROTOCOL: (("protocol", _U32),),
    Code.SERVER_PORT: (("server_port", _U32),),
    Code.TAP_TYPE: (("tap_type", _U32),),
    Code.VTAP_ID: (("vtap_id", _U32),),
    Code.TAP_SIDE: (("tap_side", _U32),),
    Code.TAP_PORT: (("tap_port", _U32),),
    Code.L7_PROTOCOL: (("l7_protocol", _U32),),
    Code.SIGNAL_SOURCE: (("signal_source", _U32),),
    Code.APP_SERVICE: (("app_service_hash", _U32),),
    Code.ENDPOINT: (("endpoint_hash", _U32),),
}


def _expand(bit: Code) -> Tuple[Tuple[str, np.dtype], ...]:
    if bit in _SINGLE:
        return _SINGLE[bit]
    base = Code(int(bit) >> 20)        # edge bit -> its single twin
    if base in _SINGLE:
        return tuple((f"{name}_{side}", dt)
                     for name, dt in _SINGLE[base] for side in ("0", "1"))
    raise ValueError(f"unmodeled tag code bit {bit!r}")


def tag_columns(code: Code) -> Tuple[ColumnSpec, ...]:
    """The KEY columns a Code expands to, in bit order (deterministic;
    new bits append without reshuffling existing tables)."""
    cols = []
    for i in range(64):
        bit = int(code) & (1 << i)
        if bit:
            for name, dt in _expand(Code(bit)):
                cols.append(ColumnSpec(name, dt, AggKind.KEY))
    return tuple(cols)


# the shared FlowMeter (zerodoc basic_meter.go Traffic+Latency+
# Performance+Anomaly): every counter sums across rollup windows except
# the *_max latency quantiles (ConcurrentMerge: sums + maxes)
FLOW_METER: Tuple[str, ...] = (
    "packet_tx", "packet_rx", "byte_tx", "byte_rx",
    "l3_byte_tx", "l3_byte_rx", "l4_byte_tx", "l4_byte_rx",
    "new_flow", "closed_flow", "l7_request", "l7_response",
    "syn", "synack",
    "rtt_sum", "rtt_count", "rtt_max",
    "rtt_client_sum", "rtt_client_count",
    "rtt_server_sum", "rtt_server_count",
    "srt_sum", "srt_count", "srt_max",
    "art_sum", "art_count", "art_max",
    "rrt_sum", "rrt_count", "rrt_max",
    "cit_sum", "cit_count", "cit_max",
    "retrans_tx", "retrans_rx", "zero_win_tx", "zero_win_rx",
    "retrans_syn", "retrans_synack",
    "client_rst_flow", "server_rst_flow",
    "client_syn_repeat", "server_synack_repeat",
    "client_half_close_flow", "server_half_close_flow",
    "tcp_timeout", "l7_client_error", "l7_server_error", "l7_timeout",
)


def meter_columns(meter: Tuple[str, ...] = FLOW_METER
                  ) -> Tuple[ColumnSpec, ...]:
    return tuple(ColumnSpec(
        name, _U32, AggKind.MAX if name.endswith("_max") else AggKind.SUM)
        for name in meter)


def make_metrics_table(name: str, code: Code,
                       meter: Tuple[str, ...] = FLOW_METER,
                       ttl_seconds: int = 3 * 24 * 3600,
                       version: int = 1):
    """Code bitmask -> a complete metrics TableSchema: timestamp +
    tag_code (grouping identity: Documents tagged over different
    dimension sets never merge) + the generated tag columns + the
    meter. This is the reference's code->table generation
    (GetDBMeterID/MiniTag) in one call."""
    cols = ((ColumnSpec("timestamp", _U32, AggKind.KEY),
             ColumnSpec("tag_code", _U64, AggKind.KEY))
            + tag_columns(code) + meter_columns(meter))
    return TableSchema(name=name, columns=cols, time_column="timestamp",
                       ttl_seconds=ttl_seconds, version=version)


# the shipped tables (reference flow_metrics table family, subset):
# vtap_flow_port's code generates its 66 columns (17 keys, 49 meters)
VTAP_FLOW_PORT = (Code.IP | Code.L3_EPC_ID | Code.POD_ID | Code.GPID
                  | Code.DIRECTION | Code.PROTOCOL | Code.SERVER_PORT
                  | Code.TAP_TYPE | Code.VTAP_ID | Code.TAP_SIDE
                  | Code.TAP_PORT | Code.L7_PROTOCOL
                  | Code.SIGNAL_SOURCE | Code.APP_SERVICE
                  | Code.ENDPOINT)

# the edge table: one line
VTAP_FLOW_EDGE_PORT = (Code.IP_PATH | Code.L3_EPC_ID_PATH
                       | Code.POD_ID_PATH | Code.GPID_PATH
                       | Code.DIRECTION | Code.PROTOCOL
                       | Code.SERVER_PORT | Code.TAP_TYPE | Code.VTAP_ID
                       | Code.TAP_SIDE | Code.TAP_PORT
                       | Code.L7_PROTOCOL | Code.SIGNAL_SOURCE)
