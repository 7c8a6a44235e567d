"""Kernels the traced slice launched (torch.profiler's CUDA kernels,
window closes included) per batch the RED exporter cut in it."""


def read(run):
    return run.launches_per_batch()
