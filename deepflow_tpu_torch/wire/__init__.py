from deepflow_tpu_torch.wire.framing import (
    BaseHeader,
    FlowHeader,
    MessageType,
    FrameReader,
    encode_frame,
)
from deepflow_tpu_torch.wire.codec import iter_pb_records, pack_pb_records

__all__ = [
    "BaseHeader",
    "FlowHeader",
    "MessageType",
    "FrameReader",
    "encode_frame",
    "iter_pb_records",
    "pack_pb_records",
]
