"""Ingester runtime: the host-side plumbing around the device compute
path: fixed-size overwrite queues with drop accounting, the TCP/UDP
firehose receiver, the reservoir-sampling throttler, the exporter plugin
surface and the Countable self-telemetry registry (reference:
server/libs/queue, server/libs/receiver, server/ingester/flow_log/
throttler and exporters, server/libs/stats).

The public names resolve on first use, so importing one runtime module
does not import the others: the host-only roles (the controller) import
`runtime.stats` without torch.
"""

from deepflow_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "OverwriteQueue": "queues",
    "MultiQueue": "queues",
    "Countable": "stats",
    "StatsRegistry": "stats",
    "default_registry": "stats",
    "ThrottlingQueue": "throttler",
    "Exporter": "exporters",
    "Exporters": "exporters",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
