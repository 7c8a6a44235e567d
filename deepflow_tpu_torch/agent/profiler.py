"""Continuous OnCPU profiler: perf sampling -> folded stacks -> wire.

Reference: agent/src/ebpf/kernel/perf_profiler.c (a perf-event-driven
stack sampler feeding a BPF stack map) +
agent/src/ebpf/user/profile/stringifier.c (stack-id -> folded "a;b;c"
frame strings) + profile/profile.c (the OnCPU profile stream).

Host re-design: the sampler uses perf_event_open(2) directly —
PERF_COUNT_SW_CPU_CLOCK at a fixed frequency with kernel-unwound user
callchains (PERF_SAMPLE_CALLCHAIN; the kernel walks frame pointers, the
same unwind source the reference's BPF program uses) read from the mmap
ring. Symbolization is /proc-based: /proc/<pid>/maps executable
regions + an in-tree ELF .symtab/.dynsym reader (no libelf/pyelftools).
Folded stacks then ride the EXISTING profile wire
(wire/protos/telemetry.proto Profile records -> MessageType.PROFILE
firehose -> pipelines/profile.py in_process_profile -> querier flame),
so the agent side PRODUCES what the server ingests.

No kprobes needed: software-clock sampling works where kprobe attach is
masked (many containers), which is exactly why it's the
profiler datapath of choice here.

The port's own copy of the JAX package's `agent/profiler.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import bisect
import ctypes
import mmap
import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

_libc = ctypes.CDLL(None, use_errno=True)
_NR_PERF_EVENT_OPEN = {"x86_64": 298, "aarch64": 241, "riscv64": 241,
                       "s390x": 331, "ppc64le": 319}.get(
                           __import__("platform").machine())

PERF_TYPE_SOFTWARE = 1
PERF_COUNT_SW_CPU_CLOCK = 0
PERF_SAMPLE_TID = 0x2
PERF_SAMPLE_CALLCHAIN = 0x20
PERF_RECORD_SAMPLE = 9
PERF_EVENT_IOC_ENABLE = 0x2400
PERF_EVENT_IOC_DISABLE = 0x2401
# callchain context markers (PERF_CONTEXT_*): huge sentinel "addresses"
# separating kernel/user sections of the chain, never real code
_CONTEXT_FLOOR = 0xFFFFFFFFFFFFF000

_ATTR_SIZE = 128
# flag bits in perf_event_attr (bit offsets within the u64 at +40)
_F_DISABLED = 1 << 0
_F_EXCLUDE_KERNEL = 1 << 5
_F_EXCLUDE_HV = 1 << 6
_F_FREQ = 1 << 10

# perf_event_mmap_page: data_head/data_tail byte offsets
_HEAD_OFF, _TAIL_OFF = 1024, 1032


def available() -> bool:
    return _NR_PERF_EVENT_OPEN is not None


def _perf_event_open(pid: int, freq_hz: int) -> int:
    attr = bytearray(_ATTR_SIZE)
    struct.pack_into("<IIQQQ", attr, 0, PERF_TYPE_SOFTWARE, _ATTR_SIZE,
                     PERF_COUNT_SW_CPU_CLOCK, freq_hz,
                     PERF_SAMPLE_TID | PERF_SAMPLE_CALLCHAIN)
    struct.pack_into("<Q", attr, 40,
                     _F_DISABLED | _F_EXCLUDE_KERNEL | _F_EXCLUDE_HV
                     | _F_FREQ)
    buf = (ctypes.c_char * _ATTR_SIZE).from_buffer(attr)
    fd = _libc.syscall(_NR_PERF_EVENT_OPEN, ctypes.byref(buf),
                       pid, -1, -1, 0)
    if fd < 0:
        err = ctypes.get_errno()
        raise OSError(err, f"perf_event_open: {os.strerror(err)}")
    return fd


# -- ELF symbol reader (64-bit LE, .symtab + .dynsym STT_FUNC) ------------
def elf_function_symbols(path: str) -> Tuple[List[int], List[str], bool]:
    """([addr...sorted], [name...], is_pie). Missing/odd files -> empty."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], [], False
    if len(data) < 64 or data[:4] != b"\x7fELF" or data[4] != 2 \
            or data[5] != 1:
        return [], [], False
    e_type = struct.unpack_from("<H", data, 16)[0]
    is_pie = e_type == 3                                   # ET_DYN
    e_shoff, = struct.unpack_from("<Q", data, 0x28)
    e_shentsize, e_shnum = struct.unpack_from("<HH", data, 0x3A)
    syms: Dict[int, str] = {}
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        if off + 64 > len(data):
            break
        sh_type, = struct.unpack_from("<I", data, off + 4)
        if sh_type not in (2, 11):                         # SYMTAB/DYNSYM
            continue
        sh_offset, sh_size = struct.unpack_from("<QQ", data, off + 24)
        sh_link, = struct.unpack_from("<I", data, off + 40)
        sh_entsize, = struct.unpack_from("<Q", data, off + 56)
        if sh_entsize != 24 or sh_link >= e_shnum:
            continue
        stroff, strsz = struct.unpack_from(
            "<QQ", data, e_shoff + sh_link * e_shentsize + 24)
        strtab = data[stroff:stroff + strsz]
        for s in range(sh_offset, min(sh_offset + sh_size, len(data)),
                       24):
            st_name, st_info = struct.unpack_from("<IB", data, s)
            if st_info & 0xF != 2:                         # STT_FUNC only
                continue
            st_value, = struct.unpack_from("<Q", data, s + 8)
            if st_value == 0 or st_name >= len(strtab):
                continue
            end = strtab.find(b"\0", st_name)
            if end < 0:              # unterminated final entry: keep all
                end = len(strtab)
            name = strtab[st_name:end].decode("utf-8", "replace")
            if name:
                syms.setdefault(st_value, name)
    addrs = sorted(syms)
    return addrs, [syms[a] for a in addrs], is_pie


@dataclass
class _Module:
    start: int
    end: int
    bias: int            # runtime addr = file vaddr + bias
    name: str
    addrs: List[int]
    names: List[str]


class Symbolizer:
    """ip -> function name for one process, from /proc/<pid>/maps +
    the modules' own symbol tables (the stringifier.c role)."""

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self._modules: List[_Module] = []
        self._load()

    def _load(self) -> None:
        try:
            with open(f"/proc/{self.pid}/maps") as f:
                lines = f.readlines()
        except OSError:
            return
        cache: Dict[str, Tuple[List[int], List[str], bool]] = {}
        for line in lines:
            parts = line.split()
            if len(parts) < 6 or "x" not in parts[1]:
                continue
            path = parts[5]
            if not path.startswith("/"):
                continue
            start, end = (int(x, 16) for x in parts[0].split("-"))
            offset = int(parts[2], 16)
            if path not in cache:
                cache[path] = elf_function_symbols(path)
            addrs, names, is_pie = cache[path]
            if not addrs:
                continue
            # ET_DYN (PIE/.so): runtime = vaddr + (start - offset); the
            # first LOAD's vaddr~=offset alignment makes this exact for
            # standard links. ET_EXEC: symbols are absolute already.
            bias = (start - offset) if is_pie else 0
            self._modules.append(_Module(start, end, bias,
                                         os.path.basename(path),
                                         addrs, names))
        self._modules.sort(key=lambda m: m.start)

    def resolve(self, ip: int) -> str:
        for m in self._modules:
            if m.start <= ip < m.end:
                v = ip - m.bias
                i = bisect.bisect_right(m.addrs, v) - 1
                if i >= 0:
                    return m.names[i]
                return f"{m.name}+0x{ip - m.start:x}"
        return "[unknown]"


class _TaskEvent:
    """One perf event + mmap ring bound to one task (thread)."""

    def __init__(self, tid: int, freq_hz: int, ring_pages: int) -> None:
        self.fd = _perf_event_open(tid, freq_hz)
        try:
            self.ring = mmap.mmap(self.fd,
                                  (ring_pages + 1) * mmap.PAGESIZE)
        except OSError:
            # e.g. perf_event_mlock_kb budget exhausted: the fd must
            # not outlive the failed construction — a retrying agent
            # loop would otherwise leak one per cycle
            os.close(self.fd)
            raise
        self.data_size = ring_pages * mmap.PAGESIZE

    def close(self) -> None:
        if self.fd >= 0:
            self.ring.close()
            os.close(self.fd)
            self.fd = -1


class OnCpuProfiler:
    """Sample one process's on-CPU user stacks; emit folded stacks.

    One perf event PER TASK: on this kernel class, inherit=1 refuses
    ring mmap (EINVAL), so a single process-wide event would silently
    sample only the main thread — worker-thread CPU (any thread pool)
    would be invisible. Tasks are snapshotted from /proc/<pid>/task at
    construction; threads spawned mid-window are picked up by the next
    profiling cycle. run(duration) -> {folded_stack: sample_count}."""

    def __init__(self, pid: int, freq_hz: int = 199,
                 ring_pages: int = 16, max_tasks: int = 64) -> None:
        if not available():
            raise OSError(38, "perf_event_open unsupported here")
        self.pid = pid
        self.freq_hz = freq_hz
        try:
            tids = sorted(int(t) for t in
                          os.listdir(f"/proc/{pid}/task"))[:max_tasks]
        except OSError:
            tids = [pid]
        self._events: List[_TaskEvent] = []
        last: Optional[OSError] = None
        for tid in tids:
            try:
                self._events.append(_TaskEvent(tid, freq_hz, ring_pages))
            except OSError as e:
                last = e          # tid exited, or perf/mlock refused
                continue
        if not self._events:
            raise last or OSError(3, f"no profilable tasks in pid {pid}")
        self.samples_seen = 0
        self.samples_other = 0       # non-SAMPLE ring records (lost, ...)

    def run(self, duration_s: float,
            symbolizer: Optional[Symbolizer] = None) -> Dict[str, int]:
        sym = symbolizer or Symbolizer(self.pid)
        import fcntl
        for ev in self._events:
            fcntl.ioctl(ev.fd, PERF_EVENT_IOC_ENABLE, 0)
        time.sleep(duration_s)
        for ev in self._events:
            fcntl.ioctl(ev.fd, PERF_EVENT_IOC_DISABLE, 0)
        folded: Dict[str, int] = {}
        for ev in self._events:
            for pid, tid, ips in self._drain(ev):
                frames = [sym.resolve(ip) for ip in ips
                          if ip < _CONTEXT_FLOOR]
                if not frames:
                    continue
                # kernel chains are leaf-first; folded is root-first
                folded_key = ";".join(reversed(frames))
                folded[folded_key] = folded.get(folded_key, 0) + 1
                self.samples_seen += 1
        return folded

    def _drain(self, ev: _TaskEvent
               ) -> Iterable[Tuple[int, int, List[int]]]:
        head, = struct.unpack_from("<Q", ev.ring, _HEAD_OFF)
        tail, = struct.unpack_from("<Q", ev.ring, _TAIL_OFF)

        def at(off: int, n: int) -> bytes:
            off %= ev.data_size
            base = mmap.PAGESIZE + off
            if off + n <= ev.data_size:
                return ev.ring[base:base + n]
            first = ev.data_size - off
            return ev.ring[base:base + first] + \
                ev.ring[mmap.PAGESIZE:mmap.PAGESIZE + n - first]

        while tail < head:
            rtype, _misc, size = struct.unpack("<IHH", at(tail, 8))
            if size < 8:
                break
            if rtype == PERF_RECORD_SAMPLE and size >= 24:
                body = at(tail + 8, size - 8)
                pid, tid = struct.unpack_from("<II", body, 0)
                nr, = struct.unpack_from("<Q", body, 8)
                nr = min(nr, (len(body) - 16) // 8)
                ips = list(struct.unpack_from(f"<{nr}Q", body, 16))
                yield pid, tid, ips
            else:
                self.samples_other += 1
            tail += size
        struct.pack_into("<Q", ev.ring, _TAIL_OFF, tail)

    @property
    def task_count(self) -> int:
        return len(self._events)

    def close(self) -> None:
        for ev in self._events:
            ev.close()
        self._events = []


def folded_to_profile_records(folded: Dict[str, int], app_service: str,
                              pid: int, vtap_id: int = 0,
                              ts_ns: Optional[int] = None) -> List[bytes]:
    """Folded stacks -> serialized telemetry.Profile records, the exact
    wire the ingester's profile pipeline consumes (event_type on-cpu,
    value = sample count)."""
    from deepflow_tpu_torch.wire.gen import telemetry_pb2

    ts = int(time.time() * 1e9) if ts_ns is None else ts_ns
    out = []
    for stack, count in sorted(folded.items()):
        p = telemetry_pb2.Profile(
            timestamp=ts, app_service=app_service, pid=pid,
            vtap_id=vtap_id, event_type="on-cpu", stack=stack,
            value=count)
        out.append(p.SerializeToString())
    return out
