"""The multi-device layer: a mesh of torch devices, one process's or
every process's of a torch.distributed group (the global mesh), the
sharded suites over it, the pod fault domains (one shard per worker,
epoch-merged) and the cross-host pod over a simulated or a
torch.distributed DCN."""

from deepflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepflow_tpu_torch.parallel.multihost import (HostPodCoordinator,
                                                   SimulatedDcnTransport,
                                                   TorchDcnTransport,
                                                   init_distributed,
                                                   local_shard,
                                                   make_global_mesh,
                                                   process_local_batch,
                                                   select_transport)
from deepflow_tpu_torch.parallel.pod import EpochResult, PodFlowSuite
from deepflow_tpu_torch.parallel.sharded import (ShardedAppSuite,
                                                 ShardedFlowSuite,
                                                 ShardedMetricsSuite)

__all__ = ["Mesh", "make_mesh", "ShardedFlowSuite", "ShardedMetricsSuite",
           "ShardedAppSuite", "init_distributed", "make_global_mesh",
           "process_local_batch", "local_shard", "PodFlowSuite",
           "EpochResult", "HostPodCoordinator", "SimulatedDcnTransport",
           "TorchDcnTransport", "select_transport"]
