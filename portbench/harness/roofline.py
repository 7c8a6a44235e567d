"""Launch records for the kernels' rooflines, and the share itself.

In a traced run the harness wraps the port's launch function of every
kernel whose `<kernel>_roofline` metric the cell reports (the module
`rooflines/<kernel>.py` names it in `TARGET`). While the traced slice
is open each launch's inputs are held, by reference: no copy and no
extra device work. When the slice closes they are copied to the host and
the device blocks let go, so that the rest of the run's memory peak is
the program's alone. The kernel's
share of its roofline is the least time its launches could take (the
larger of bytes over the peak bandwidth and operations over the peak
rate) over the device time that the trace gives its kernels.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

from harness.spec import BENCH_DIR

SUFFIX = "_roofline"
# what the held inputs of a traced slice may take: the allocator's pools
# for blocks up to 1 MB and above it
RESERVE_BYTES = 1 << 29
RESERVE_PIECES = (1 << 19, 1 << 21)


def kernel_module(kernel: str):
    return importlib.import_module(f"rooflines.{kernel}")


def peaks(device_name: str) -> Optional[dict]:
    with open(Path(BENCH_DIR) / "rooflines" / "peaks.json") as f:
        return json.load(f).get(device_name)


class Recorder:
    """Wraps the launch functions of the given kernels. Holding the
    launches' inputs keeps the allocator from handing their memory out
    again, so `reserve` first fills its cache on each stream the program
    allocates on: the held inputs then take cached blocks, and the
    traced slice shows no cudaMalloc the untraced run would not make."""

    def __init__(self, kernels: List[str]) -> None:
        self.records: Dict[str, list] = {k: [] for k in kernels}
        self.active = False
        self._undo = []
        for k in kernels:
            mod = kernel_module(k)
            target = importlib.import_module(mod.TARGET[0])
            orig = getattr(target, mod.TARGET[1])
            self._wrap(k, mod, target, orig)

    def _wrap(self, kernel, mod, target, orig) -> None:
        records = self.records[kernel]

        def wrapper(*args, **kwargs):
            if self.active:
                records.append(mod.capture(args, kwargs))
            return orig(*args, **kwargs)

        # the launch functions count their launches on themselves
        wrapper.launches = getattr(orig, "launches", 0)
        setattr(target, mod.TARGET[1], wrapper)
        self._undo.append((target, mod.TARGET[1], orig, wrapper))

    @staticmethod
    def reserve(streams, nbytes: int = RESERVE_BYTES) -> None:
        import torch
        for stream in streams:
            with torch.cuda.stream(stream):
                for piece in RESERVE_PIECES:
                    held = [torch.empty(piece, dtype=torch.uint8,
                                        device=stream.device)
                            for _ in range(nbytes // piece)]
                    del held

    def to_host(self) -> None:
        """Replace every held device tensor by its host copy."""
        import torch

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.cpu()
            if isinstance(x, tuple):
                return tuple(host(y) for y in x)
            return x
        for recs in self.records.values():
            recs[:] = [host(r) for r in recs]

    def close(self) -> None:
        for target, name, orig, wrapper in reversed(self._undo):
            if hasattr(orig, "launches"):
                orig.launches = wrapper.launches
            setattr(target, name, orig)
        self._undo.clear()


def share(kernel: str, records: list, trace, config: dict,
          device_name: str) -> Optional[float]:
    """Percent of the roofline over the slice's launches, or None when
    the trace and the records do not both hold them."""
    pk = peaks(device_name)
    if trace is None or not records or pk is None:
        return None
    mod = kernel_module(kernel)
    ks = trace.kernels(mod.KERNEL)
    if len(ks) != len(records):
        return None
    device_s = sum(dur for _, _, dur in ks) / 1e6
    if device_s <= 0:
        return None
    nbytes = ops = 0
    for rec in records:
        b, o = mod.cost(rec, config)
        nbytes += b
        ops += o
    bound_s = max(nbytes / pk["hbm_bytes_per_s"],
                  ops / pk["int32_ops_per_s"])
    return 100.0 * bound_s / device_s
