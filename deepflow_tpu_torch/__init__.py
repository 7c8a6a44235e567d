"""deepflow_tpu_torch: the l4 sketch step of deepflow_tpu and its
exporter in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(csrc/). Imports torch and numpy only; entry points run on the card
unless the caller passes device="cpu"."""
