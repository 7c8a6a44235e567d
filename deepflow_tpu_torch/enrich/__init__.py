"""Metadata enrichment: KnowledgeGraph tags and geo provinces stamped
onto decoded columns with vectorized sorted-key joins (reference:
server/libs/grpc/grpc_platformdata.go, server/libs/geo/)."""

from deepflow_tpu_torch.enrich.platform_data import (
    CidrInfo, InterfaceInfo, PlatformDataManager, PlatformInfoTable,
    ServiceEntry, ServiceTable,
)

__all__ = [
    "CidrInfo", "InterfaceInfo", "PlatformDataManager", "PlatformInfoTable",
    "ServiceEntry", "ServiceTable",
]
