"""Metadata enrichment: KnowledgeGraph tags and geo provinces stamped
onto decoded columns with vectorized sorted-key joins (reference:
server/libs/grpc/grpc_platformdata.go, server/libs/geo/)."""
