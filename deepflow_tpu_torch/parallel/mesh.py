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

A mesh may span processes (`multihost.make_global_mesh`): every entry
carries the index of the process that holds it (`process_index`), and
the calling process (`process`) addresses only its own entries
(`local_indices`), in global order. A process's entries are contiguous
along the mesh's flattened order, processes in rank order. Another
process's entries are labels (the device as that process names it),
never touched here. A single-process mesh has every entry local.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models.flow_suite import check_device


class Mesh:
    """`devices` is an object array of `torch.device` shaped like the
    axes; `shape` maps each axis name to its size, as JAX's Mesh does.
    `process_index` (int array of the same shape, zeros by default) names
    the process holding each entry; `process` is the calling process."""

    def __init__(self, devices: np.ndarray, axes: Sequence[str],
                 process_index: Optional[np.ndarray] = None,
                 process: int = 0) -> None:
        if devices.ndim != len(axes):
            raise ValueError(f"{devices.ndim}-d devices for axes {axes}")
        self.devices = devices
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.process_index = (np.zeros(devices.shape, np.int64)
                              if process_index is None
                              else np.asarray(process_index, np.int64))
        if self.process_index.shape != devices.shape:
            raise ValueError("process_index is not shaped like devices")
        self.process = int(process)
        self.process_count = int(self.process_index.max()) + 1

    def _along(self, arr: np.ndarray, axis: str) -> list:
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return arr[tuple(idx)].tolist()

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along `axis`, at index 0 of every other axis: the
        shards of a suite sharded over `axis`, of every process."""
        return tuple(self._along(self.devices, axis))

    def axis_processes(self, axis: str) -> Tuple[int, ...]:
        """The process of each entry along `axis` (as `axis_devices`)."""
        return tuple(int(p) for p in self._along(self.process_index, axis))

    def local_indices(self, axis: str) -> Tuple[int, ...]:
        """Positions along `axis` that the calling process holds."""
        return tuple(i for i, p in enumerate(self.axis_processes(axis))
                     if p == self.process)

    def local_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The calling process's devices along `axis`, in global order."""
        devs = self.axis_devices(axis)
        return tuple(devs[i] for i in self.local_indices(axis))


def _visible(device: torch.device) -> list:
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",), device="cuda", *,
              process_shards: Optional[Sequence[Tuple[int, int]]] = None,
              process: int = 0) -> Mesh:
    """A 1-D (default) mesh of n_devices shards over the visible devices
    of `device`'s type (every visible card, or the CPU); multi-axis if
    requested. n_devices defaults to the number of visible devices.

    `process_shards` spans processes: one (shards, visible devices) pair
    per process in rank order, this process being `process`; the mesh
    holds every process's shards in rank order (n_devices is their sum),
    shard d of process p on that process's device d % visible."""
    device = check_device(device)
    visible = _visible(device)
    spans = process_shards is not None
    if not spans:
        process_shards = [(n_devices or len(visible), len(visible))]
    devs, procs = [], []
    for p, (count, vis) in enumerate(process_shards):
        if p == process and vis != len(visible):
            raise ValueError(f"process {p} sees {len(visible)} devices, "
                             f"not {vis}")
        for d in range(int(count)):
            devs.append(visible[d % vis] if p == process
                        else torch.device(device.type, d % vis)
                        if device.type == "cuda" else device)
            procs.append(p)
    n = len(devs)
    if n < 1 or (spans and n_devices is not None and n != n_devices):
        raise ValueError(f"n_devices {n_devices}: the processes hold {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    procs = np.asarray(procs, np.int64)
    if len(axes) == 1:
        return Mesh(arr, axes, procs, process)
    # factor n across the axes: the smallest prime factor for each leading
    # axis, the remainder (largest factor) on the last
    shape = []
    rem = n
    for _ in range(len(axes) - 1):
        f = next((p for p in range(2, rem + 1) if rem % p == 0), 1)
        shape.append(f)
        rem //= f
    shape.append(rem)
    return Mesh(arr.reshape(shape), axes, procs.reshape(shape), process)
