"""The anomaly plane: windowed entropy-DDoS, streaming-PCA and
matrix-profile detection as a durable, queryable lane beside the sketch
lane. `detectors` holds the device state, the per-batch active-flow
offer and the window step; `alerts` the AlertRecord shape and the
AnomalyPlane orchestrator."""

from deepflow_tpu_torch.anomaly.detectors import (DETECTORS, GOLDEN_FEATURES,
                                                  AnomalyConfig, AnomalyState)
from deepflow_tpu_torch.anomaly.alerts import (ANOMALY_STREAM, AlertRecord,
                                               AnomalyPlane)

__all__ = ["AnomalyConfig", "AnomalyState", "DETECTORS", "GOLDEN_FEATURES",
           "AlertRecord", "AnomalyPlane", "ANOMALY_STREAM"]
