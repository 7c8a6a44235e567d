"""Store table schemas of the flow_metrics pipeline.

The metrics tables are generated from the tag-Code bitmask model
(`pipelines/tag_code.py`): the code names the dimensions and
`make_metrics_table` expands them plus the shared FlowMeter. Agg kinds
drive the rollup manager: KEY columns form the rollup group identity,
SUM/MAX columns aggregate.

A copy of the metrics part of the JAX package's pipelines/schemas.py
(this package imports none of it); the flow_log tables wait for a
flow_log pipeline in this package.
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.batch.schema import METRIC_SCHEMA
from deepflow_tpu_torch.pipelines.tag_code import (VTAP_FLOW_EDGE_PORT,
                                                   VTAP_FLOW_PORT,
                                                   make_metrics_table)
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec

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
