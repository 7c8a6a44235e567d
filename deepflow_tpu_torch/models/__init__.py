from deepflow_tpu_torch.models.flow_suite import (
    FlowSuiteConfig,
    FlowSuiteState,
    FlowWindowOutput,
)
from deepflow_tpu_torch.models import flow_suite, metrics_suite

__all__ = [
    "FlowSuiteConfig",
    "FlowSuiteState",
    "FlowWindowOutput",
    "flow_suite",
    "metrics_suite",
]
