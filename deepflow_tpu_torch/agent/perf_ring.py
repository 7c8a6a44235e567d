"""Kernel->user record stream + probe attachment over perf_event_open.

Reference roles covered (agent/src/ebpf/user/):
- `tracer.c:1` — program attach: kprobe/kretprobe and uprobe/uretprobe
  events created through the perf PMU interface
  (/sys/bus/event_source/devices/{k,u}probe), the BPF program bound
  with PERF_EVENT_IOC_SET_BPF;
- `perf_profiler.c` / the socket reader — per-CPU
  PERF_COUNT_SW_BPF_OUTPUT events mmap'd and drained: every
  bpf_perf_event_output(...BPF_F_CURRENT_CPU...) from the
  socket_trace / uprobe suites lands in these rings as a
  PERF_RECORD_SAMPLE whose raw body is one SOCK_DATA record.

Everything is the raw syscall surface (no libbpf), matching the
repo-wide in-tree discipline (agent/bpf.py loads, agent/profiler.py
samples). Containers usually mask the PMUs — callers gate on
{socket_trace,uprobe_trace}.attach_available() and degrade to replay;
a host with the PMUs visible runs the full kernel->ring->EbpfTracer
path live (its live-attach tests do).

The port's own copy of the JAX package's `agent/perf_ring.py` (host code;
the port imports nothing of that package)."""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from typing import Callable, Iterable, List, Optional

from deepflow_tpu_torch.agent.bpf import Program
from deepflow_tpu_torch.agent.profiler import (_ATTR_SIZE, _HEAD_OFF,
                                               _NR_PERF_EVENT_OPEN, _TAIL_OFF,
                                               PERF_EVENT_IOC_DISABLE,
                                               PERF_EVENT_IOC_ENABLE,
                                               PERF_RECORD_SAMPLE)

_libc = ctypes.CDLL(None, use_errno=True)

PERF_SAMPLE_RAW = 0x400
PERF_COUNT_SW_BPF_OUTPUT = 10
PERF_RECORD_LOST = 2
PERF_TYPE_SOFTWARE = 1
# _IOW('$', 8, u32)
PERF_EVENT_IOC_SET_BPF = 0x40042408


def _perf_open(attr: bytearray, pid: int, cpu: int) -> int:
    if _NR_PERF_EVENT_OPEN is None:
        raise OSError(38, "perf_event_open syscall number unknown")
    buf = (ctypes.c_char * _ATTR_SIZE).from_buffer(attr)
    fd = _libc.syscall(_NR_PERF_EVENT_OPEN, ctypes.byref(buf),
                       pid, cpu, -1, 0)
    if fd < 0:
        err = ctypes.get_errno()
        raise OSError(err, f"perf_event_open: {os.strerror(err)}")
    return fd


def _pmu_type(pmu: str) -> int:
    with open(f"/sys/bus/event_source/devices/{pmu}/type") as f:
        return int(f.read())


def _pmu_retprobe_bit(pmu: str) -> int:
    """format/retprobe reads like 'config:0' — the bit in config that
    flips the probe to the return flavor."""
    try:
        with open("/sys/bus/event_source/devices/"
                  f"{pmu}/format/retprobe") as f:
            spec = f.read().strip()
        return 1 << int(spec.split(":", 1)[1])
    except (OSError, ValueError, IndexError):
        return 1                                   # the universal default


class ProbeEvent:
    """One attached probe: perf event + bound BPF program. Close
    detaches (closing the perf fd removes the transient probe)."""

    def __init__(self, fd: int, keepalive: object) -> None:
        self.fd = fd
        self._keepalive = keepalive    # the C string config1 points at

    def close(self) -> None:
        if self.fd >= 0:
            import fcntl
            try:
                fcntl.ioctl(self.fd, PERF_EVENT_IOC_DISABLE, 0)
            except OSError:
                pass
            os.close(self.fd)
            self.fd = -1


def _attach(pmu: str, prog: Program, target: bytes, offset: int,
            retprobe: bool) -> ProbeEvent:
    attr = bytearray(_ATTR_SIZE)
    cstr = ctypes.create_string_buffer(target)
    config = _pmu_retprobe_bit(pmu) if retprobe else 0
    struct.pack_into("<IIQQ", attr, 0, _pmu_type(pmu), _ATTR_SIZE,
                     config, 1)                    # sample_period=1
    struct.pack_into("<QQ", attr, 56, ctypes.addressof(cstr), offset)
    fd = _perf_open(attr, -1, 0)
    import fcntl
    try:
        fcntl.ioctl(fd, PERF_EVENT_IOC_SET_BPF, prog.fd)
        fcntl.ioctl(fd, PERF_EVENT_IOC_ENABLE, 0)
    except OSError:
        os.close(fd)
        raise
    return ProbeEvent(fd, cstr)


def attach_kprobe(prog: Program, symbol: str,
                  retprobe: bool = False) -> ProbeEvent:
    """kprobe/kretprobe on a kernel symbol via the kprobe PMU
    (tracer.c's program__attach_kprobe)."""
    return _attach("kprobe", prog, symbol.encode(), 0, retprobe)


def attach_uprobe(prog: Program, path: str, offset: int,
                  retprobe: bool = False) -> ProbeEvent:
    """uprobe/uretprobe at a FILE OFFSET in a binary image via the
    uprobe PMU (tracer.c's program__attach_uprobe; offsets come from
    uprobe_trace.plan_ssl/plan_go)."""
    return _attach("uprobe", prog, path.encode(), offset, retprobe)


class BpfOutputReader:
    """Per-CPU PERF_COUNT_SW_BPF_OUTPUT rings bound into a
    PERF_EVENT_ARRAY map: drains the records the in-kernel suites emit
    with bpf_perf_event_output(BPF_F_CURRENT_CPU)."""

    def __init__(self, events_map, ring_pages: int = 8,
                 cpus: Optional[List[int]] = None) -> None:
        # default to ALL online cpus, NOT this process's affinity
        # mask: the kernel program writes to the ring slot of whatever
        # cpu the TRACED process runs on — an affinity-pinned agent
        # (k8s cpuset) would otherwise silently drop every record from
        # cpus outside its own mask (perf_event_open on a foreign cpu
        # is allowed; running there is not required)
        self.cpus = cpus if cpus is not None else \
            list(range(os.cpu_count() or 1))
        self._fds: List[int] = []
        self._rings: List[mmap.mmap] = []
        self.data_size = ring_pages * mmap.PAGESIZE
        self.lost = 0
        try:
            for cpu in self.cpus:
                attr = bytearray(_ATTR_SIZE)
                struct.pack_into(
                    "<IIQQQ", attr, 0, PERF_TYPE_SOFTWARE, _ATTR_SIZE,
                    PERF_COUNT_SW_BPF_OUTPUT, 1, PERF_SAMPLE_RAW)
                struct.pack_into("<I", attr, 48, 1)   # wakeup_events
                fd = _perf_open(attr, -1, cpu)
                self._fds.append(fd)
                self._rings.append(mmap.mmap(
                    fd, (ring_pages + 1) * mmap.PAGESIZE))
                # the kernel program indexes the map by smp_processor_id
                events_map.update(cpu, fd)
                import fcntl
                fcntl.ioctl(fd, PERF_EVENT_IOC_ENABLE, 0)
        except OSError:
            self.close()
            raise

    def drain(self) -> Iterable[bytes]:
        """Yield every raw record currently in the rings (the
        perf_event_output payload: one SOCK_DATA image each)."""
        for ring in self._rings:
            head, = struct.unpack_from("<Q", ring, _HEAD_OFF)
            tail, = struct.unpack_from("<Q", ring, _TAIL_OFF)

            def at(off: int, n: int) -> bytes:
                off %= self.data_size
                base = mmap.PAGESIZE + off
                if off + n <= self.data_size:
                    return ring[base:base + n]
                first = self.data_size - off
                return ring[base:base + first] + \
                    ring[mmap.PAGESIZE:mmap.PAGESIZE + n - first]

            while tail < head:
                rtype, _misc, size = struct.unpack("<IHH", at(tail, 8))
                if size < 8:
                    break
                if rtype == PERF_RECORD_SAMPLE and size >= 16:
                    # body: u32 raw_size, then raw bytes
                    raw_size, = struct.unpack("<I", at(tail + 8, 4))
                    raw_size = min(raw_size, size - 12)
                    yield at(tail + 12, raw_size)
                elif rtype == PERF_RECORD_LOST and size >= 24:
                    # {id: u64, lost: u64} — the kernel coalesces an
                    # overflow burst into ONE record carrying the
                    # count; += 1 would understate loss by orders of
                    # magnitude exactly when the telemetry matters
                    self.lost += struct.unpack("<Q", at(tail + 16, 8))[0]
                else:
                    self.lost += 1
                tail += size
            struct.pack_into("<Q", ring, _TAIL_OFF, tail)

    def pump(self, feed: Callable[[bytes], object]) -> int:
        """Drain every ring into `feed` (e.g. EbpfTracer.feed_raw);
        returns the record count."""
        n = 0
        for raw in self.drain():
            feed(raw)
            n += 1
        return n

    def close(self) -> None:
        for ring in self._rings:
            ring.close()
        for fd in self._fds:
            os.close(fd)
        self._rings, self._fds = [], []
