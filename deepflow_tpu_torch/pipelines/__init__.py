"""Ingester pipelines of the port: the `Ingester` builder with its
flow_log, flow_metrics, ext_metrics, event, profile and droplet
pipelines, and the table schemas they write."""

from deepflow_tpu_torch.pipelines.ingester import Ingester, IngesterConfig

__all__ = ["Ingester", "IngesterConfig"]
