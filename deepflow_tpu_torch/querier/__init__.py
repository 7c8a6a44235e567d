"""Querier: the SQL and PromQL query surface over the port's columnar
store, its snapshot buses and its self-telemetry.

A copy of the JAX package's `querier/`: filters are vectorized numpy
masks, GROUP BY aggregation runs through `store/rollup.group_reduce` on
the engine's `device` (on the card when it is CUDA), and SmartEncoded
hash columns translate back to strings through the TagDict registry at
result time. The PromQL evaluator is numpy float64.
"""

from deepflow_tpu_torch.querier.engine import QueryEngine, QueryResult
from deepflow_tpu_torch.querier.sql import parse_sql

__all__ = ["QueryEngine", "QueryResult", "parse_sql"]
