"""Device mesh: an ordered grid of torch devices with named axes.

The scale-out axis is the record stream: batches split along `data`,
each shard keeps its own sketch state, and window merges reduce the
shards. JAX runs one controller over a mesh of devices; so does this
port, in one process: a `Mesh` holds `torch.device`s, and the sharded
suites (parallel/sharded.py) drive one state per shard.

There may be more shards than devices: shard d lives on
`devices[d % len(devices)]` of the requested type, so four shards share
one card, and eight share the CPU in tests (the JAX tests force eight
virtual CPU devices for the same reason).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models.flow_suite import check_device


class Mesh:
    """`devices` is an object array of `torch.device` shaped like the
    axes; `shape` maps each axis name to its size, as JAX's Mesh does."""

    def __init__(self, devices: np.ndarray, axes: Sequence[str]) -> None:
        if devices.ndim != len(axes):
            raise ValueError(f"{devices.ndim}-d devices for axes {axes}")
        self.devices = devices
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along `axis`, at index 0 of every other axis: the
        shards of a suite sharded over `axis`."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return tuple(self.devices[tuple(idx)].tolist())


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",), device="cuda") -> Mesh:
    """A 1-D (default) mesh of n_devices shards over the visible devices
    of `device`'s type (every visible card, or the CPU); multi-axis if
    requested. n_devices defaults to the number of visible devices."""
    device = check_device(device)
    if device.type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device("cpu")]
    n = n_devices or len(visible)
    if n < 1:
        raise ValueError(f"n_devices {n} < 1")
    devs = np.empty(n, dtype=object)
    devs[:] = [visible[d % len(visible)] for d in range(n)]
    if len(axes) == 1:
        return Mesh(devs, axes)
    # factor n across the axes: the smallest prime factor for each leading
    # axis, the remainder (largest factor) on the last
    shape = []
    rem = n
    for _ in range(len(axes) - 1):
        f = next((p for p in range(2, rem + 1) if rem % p == 0), 1)
        shape.append(f)
        rem //= f
    shape.append(rem)
    return Mesh(devs.reshape(shape), axes)
