"""Kernels the traced slice launched (torch.profiler's CUDA kernels,
window closes included) per batch the sketch exporter staged in it."""


def read(run):
    return run.launches_per_batch()
