"""The multi-device layer: a mesh of torch devices driven by one
process, and the sharded suites over it. The reference's pod and
multihost layers are not ported yet (ROADMAP)."""

from deepflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepflow_tpu_torch.parallel.sharded import (ShardedAppSuite,
                                                 ShardedFlowSuite,
                                                 ShardedMetricsSuite)

__all__ = ["Mesh", "make_mesh", "ShardedFlowSuite", "ShardedMetricsSuite",
           "ShardedAppSuite"]
