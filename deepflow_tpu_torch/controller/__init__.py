"""Controller: agent management, resource model, tag dictionaries.

Reference: server/controller/ — trisolaris (agent registration/config
push), genesis (agent-reported resources), recorder (cloud+genesis ->
MySQL resource model), tagrecorder (SmartEncoding dimension tables),
election (single master), monitor (agent liveness + ingester
rebalancing). The re-design keeps the same responsibilities with an
in-memory + JSON-persisted resource model, a file-lock election, and
HTTP (stdlib) in place of gRPC for the sync surface — the data-plane
wire stays the firehose.

The port's own copy of the JAX package's `controller/__init__.py` (host
code; the port imports nothing of that package, nor torch).
"""

from deepflow_tpu_torch.controller.cloud import (CloudManager, CloudTask,
                                                 FileReaderPlatform,
                                                 HttpPlatform,
                                                 KubernetesGatherPlatform)
from deepflow_tpu_torch.controller.model import ResourceModel
from deepflow_tpu_torch.controller.recorder import Recorder
from deepflow_tpu_torch.controller.registry import VTapRegistry
from deepflow_tpu_torch.controller.server import ControllerServer

__all__ = ["ResourceModel", "Recorder", "VTapRegistry",
           "ControllerServer", "CloudManager", "CloudTask",
           "FileReaderPlatform", "HttpPlatform",
           "KubernetesGatherPlatform"]
