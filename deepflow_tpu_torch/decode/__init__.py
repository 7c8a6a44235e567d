"""Decoders: protobuf record batches -> schema columns."""

from deepflow_tpu_torch.decode.columnar import (
    decode_l4_records,
    decode_l7_records,
    decode_metric_records,
)

__all__ = ["decode_l4_records", "decode_l7_records", "decode_metric_records"]
