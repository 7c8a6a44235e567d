"""Ingester pipelines of the port: the flow_metrics pipeline's store lane
and the metrics table schemas it writes."""
