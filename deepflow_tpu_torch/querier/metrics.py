"""Derived-metric library: named metrics that expand to expressions.

Reference: server/querier/engine/clickhouse/metrics/ — a per-table
registry where e.g. `rtt` expands to AVGIf(rtt_sum/rtt_count, ...) in
generated ClickHouse SQL, so dashboards ask for semantic metric names
rather than raw column math. Here each derived metric is a DeepFlow-SQL
expression string parsed once through the normal grammar; the engine
substitutes it when a SELECT item names a derived metric (real columns
always win over library names), and SHOW METRICS lists the ones whose
underlying columns the table actually carries.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from deepflow_tpu_torch.querier import sql as Q

# name -> (expression, unit, description)
DERIVED_METRICS: Dict[str, Tuple[str, str, str]] = {
    "byte": ("Sum(byte_tx) + Sum(byte_rx)", "B", "total bytes both ways"),
    "packet": ("Sum(packet_tx) + Sum(packet_rx)", "",
               "total packets both ways"),
    "rtt_avg": ("Sum(rtt_sum) / Sum(rtt_count)", "us",
                "mean TCP handshake RTT"),
    "srt_avg": ("Sum(srt_sum) / Sum(srt_count)", "us",
                "mean system response time"),
    "art_avg": ("Sum(art_sum) / Sum(art_count)", "us",
                "mean application response time"),
    "rrt_avg": ("Sum(rrt_sum) / Sum(rrt_count)", "us",
                "mean L7 request-response time"),
    "cit_avg": ("Sum(cit_sum) / Sum(cit_count)", "us",
                "mean client idle time"),
    "retrans": ("Sum(retrans_tx) + Sum(retrans_rx)", "",
                "total retransmissions"),
    "retrans_ratio": (
        "(Sum(retrans_tx) + Sum(retrans_rx)) / "
        "(Sum(packet_tx) + Sum(packet_rx))", "",
        "retransmitted fraction of packets"),
    "l7_error": ("Sum(l7_client_error) + Sum(l7_server_error)", "",
                 "total L7 errors"),
    "l7_error_ratio": (
        "(Sum(l7_client_error) + Sum(l7_server_error)) / Sum(l7_response)",
        "", "errored fraction of L7 responses"),
    "new_flow": ("Sum(new_flow)", "", "new flows"),
    "closed_flow": ("Sum(closed_flow)", "", "closed flows"),
}

_parsed: Dict[str, Q.Expr] = {}


def expression(name: str) -> Optional[Q.Expr]:
    """Parsed expression for a derived metric name, or None."""
    spec = DERIVED_METRICS.get(name)
    if spec is None:
        return None
    expr = _parsed.get(name)
    if expr is None:
        stmt = Q.parse_sql(f"SELECT {spec[0]} FROM _")
        expr = stmt.items[0].expr
        _parsed[name] = expr
    return expr


def required_columns(name: str) -> Set[str]:
    expr = expression(name)
    return Q.expr_columns(expr) if expr is not None else set()


def available_for(column_names: Set[str]) -> Dict[str, Tuple[str, str, str]]:
    """Derived metrics whose every underlying column the table carries."""
    return {n: spec for n, spec in DERIVED_METRICS.items()
            if required_columns(n) <= column_names}

