"""Sketch-serving read path: the port's copy of the JAX package's
`serving/`.

A `SnapshotCache` subscribes to the sketch exporter's
`runtime.snapbus.SnapshotBus` and keeps recent window snapshots as host
numpy; `SketchTables` answers point queries (CMS point estimate, HLL
cardinality, top-K, entropy) from that cache with staleness-bounded
reads, and `AnomalyTables` serves the anomaly plane's alert snapshots.
Query traffic never syncs the device and never touches the feed path.
Both query engines (`querier/engine.py` SQL and `querier/promql.py`)
mount the tables as the `sketch` and `anomaly` datasources.
"""

from deepflow_tpu_torch.serving.cache import SnapshotCache
from deepflow_tpu_torch.serving.tables import SketchTables
from deepflow_tpu_torch.serving.anomaly import AnomalyTables

__all__ = ["SnapshotCache", "SketchTables", "AnomalyTables"]
