"""A device-side gate for timing a program's execution apart from its
launching: the CUDA kernel `csrc/gate.cu` and its host handle.

Not a port of a TPU kernel and without a plain version: an instrument.
In eager PyTorch the card runs a program's kernels while the host is
still launching them, so events around the launches time the host. The
flight recorder therefore holds the compute stream with a gate before an
attributed program, records its start event after the gate, launches the
program, records the end event and opens the gate: the two events then
bracket the program's kernels running back to back, which is the card's
execution time (`kernel.device`, `tpu_device_busy_fraction`).

`DeviceGate(device, timeout_s)`:
- `hold()` enqueues a gate on the current stream and returns its ticket;
- `release(ticket)` opens it (one store into pinned, mapped host memory);
- `verdict(ticket)`, once an event recorded after the gate has completed:
  True if the host opened it, False if the timeout did (the host blocked
  while it held: a full launch queue, a sync inside the program), None if
  the slot no longer holds that ticket.

A sample released by the timeout does not time the program and must be
discarded. Every launch counts one in `gate_launch.launches`. The buffer
is allocated on the first `hold()`, never at import.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from deepflow_tpu_torch.ops import _build

_SIGNATURES = {
    "df_gate_alloc": [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_void_p)],
    "df_gate_free": [ctypes.c_void_p],
    "df_gate": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}

SLOTS = 256                       # result ring: tickets in flight at most
_I32 = ctypes.sizeof(ctypes.c_int32)


def gate_launch(word_dev: int, ticket: int, timeout_ns: int,
                results_dev: int, slots: int, stream: int) -> None:
    """Launch one gate kernel; counts one in `gate_launch.launches`."""
    fn = _build.function("gate", "df_gate", _SIGNATURES)
    _build.check(fn(word_dev, ticket, timeout_ns, results_dev, slots,
                    stream), "df_gate")
    gate_launch.launches += 1


gate_launch.launches = 0


class DeviceGate:
    """One gate word and its result ring for one device."""

    def __init__(self, device, timeout_s: float = 0.25) -> None:
        import torch
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceGate needs a CUDA device, got "
                             f"{self.device}")
        self.timeout_ns = int(timeout_s * 1e9)
        self._lock = threading.Lock()
        self._host = None           # host address of word + results
        self._dev = None
        self._ticket = 0
        self.timed_out = 0

    def _alloc(self) -> None:
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        fn = _build.function("gate", "df_gate_alloc", _SIGNATURES)
        err = fn(1 + SLOTS, ctypes.byref(host), ctypes.byref(dev))
        if err != 0:
            raise _build.KernelError(f"df_gate_alloc: CUDA error {err}")
        self._host, self._dev = host.value, dev.value
        self._word = ctypes.c_int32.from_address(self._host)
        self._results = (ctypes.c_int32 * SLOTS).from_address(
            self._host + _I32)

    def hold(self, stream: Optional[int] = None) -> int:
        """Enqueue a gate on `stream` (default: the current stream)."""
        with self._lock:
            if self._host is None:
                self._alloc()
            self._ticket += 1
            ticket = self._ticket
        if stream is None:
            stream = _build.stream_handle(self.device)
        gate_launch(self._dev, ticket, self.timeout_ns, self._dev + _I32,
                    SLOTS, stream)
        return ticket

    def release(self, ticket: int) -> None:
        """Open every gate up to `ticket`."""
        if self._word.value < ticket:
            self._word.value = ticket

    def verdict(self, ticket: int) -> Optional[bool]:
        """Read once the gate has run: True = opened by the host, False =
        released by the timeout (counted in `timed_out`)."""
        got = self._results[ticket % SLOTS]
        if got == ticket:
            return True
        if got == -ticket:
            self.timed_out += 1
            return False
        return None

    def close(self) -> None:
        if self._host is not None:
            fn = _build.function("gate", "df_gate_free", _SIGNATURES)
            fn(self._host)
            self._host = None
