"""The profile pipeline's table: continuous-profiling stacks in
`profile.in_process_profile`.

Folded stacks are SmartEncoded through the `profile_stack` TagDict, so
the table stays pure-integer columns and flame graphs reconstruct by
dictionary lookup at query time (`querier/profile.py`).

For now this module holds only the schema, a copy of the JAX package's
`pipelines/profile.py` `PROFILE_DB` and `PROFILE_TABLE`, which the
querier's profile routes read. The pipeline that writes the table
(`ProfilePipeline`: firehose Profile records off the receiver into a
`StoreWriter`) is not ported yet; it comes with the other ingest
pipelines (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema

__all__ = ["PROFILE_DB", "PROFILE_TABLE"]

PROFILE_DB = "profile"

_U32 = np.dtype(np.uint32)

PROFILE_TABLE = TableSchema(
    name="in_process_profile",
    columns=(
        ColumnSpec("timestamp", _U32, AggKind.KEY),
        ColumnSpec("app_service", _U32, AggKind.KEY),   # dict hash
        ColumnSpec("event_type", _U32, AggKind.KEY),    # dict hash
        ColumnSpec("stack", _U32, AggKind.KEY),         # dict hash (folded)
        ColumnSpec("pid", _U32, AggKind.KEY),
        ColumnSpec("vtap_id", _U32, AggKind.KEY),
        ColumnSpec("pod_id", _U32, AggKind.KEY),
        ColumnSpec("value", _U32, AggKind.SUM),
    ),
)
