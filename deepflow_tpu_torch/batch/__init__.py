from deepflow_tpu_torch.batch.schema import (L4_SCHEMA, L7_SCHEMA,
                                              METRIC_SCHEMA, SKETCH_L4_SCHEMA,
                                              Schema)
from deepflow_tpu_torch.batch.batcher import Batcher, TensorBatch

__all__ = ["L4_SCHEMA", "L7_SCHEMA", "METRIC_SCHEMA", "SKETCH_L4_SCHEMA",
           "Schema", "Batcher", "TensorBatch"]
