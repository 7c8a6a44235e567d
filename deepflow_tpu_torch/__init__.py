"""deepflow_tpu_torch: the device half of deepflow_tpu (the sketch,
RED, metrics and detection lanes, their exporters and the ingester that
feeds them) in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(csrc/). Imports torch and numpy only; entry points run on the card
unless the caller passes device="cpu"."""
