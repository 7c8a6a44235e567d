"""Decoders: protobuf record batches -> schema columns."""
