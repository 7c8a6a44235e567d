"""The multi-device layer: a mesh of torch devices driven by one
process, the sharded suites over it, the pod fault domains (one shard
per worker, epoch-merged) and the cross-host pod over a simulated or a
torch.distributed DCN. The reference's multi-process global mesh is not
ported yet (ROADMAP)."""

from deepflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepflow_tpu_torch.parallel.multihost import (HostPodCoordinator,
                                                   SimulatedDcnTransport,
                                                   TorchDcnTransport,
                                                   init_distributed,
                                                   select_transport)
from deepflow_tpu_torch.parallel.pod import EpochResult, PodFlowSuite
from deepflow_tpu_torch.parallel.sharded import (ShardedAppSuite,
                                                 ShardedFlowSuite,
                                                 ShardedMetricsSuite)

__all__ = ["Mesh", "make_mesh", "ShardedFlowSuite", "ShardedMetricsSuite",
           "ShardedAppSuite", "init_distributed", "PodFlowSuite",
           "EpochResult", "HostPodCoordinator", "SimulatedDcnTransport",
           "TorchDcnTransport", "select_transport"]
