"""AF_XDP capture source: zero-copy-class packet RX in pure Python.

Reference: `server/libs/xdppacket/` (a Go AF_XDP library the reference
keeps beside its AF_PACKET paths) and the recv_engine's DPDK ambitions
— kernel-bypass-class RX. AF_XDP is the Linux-native answer: an XDP
program redirects a queue's frames into an XSK socket's shared-memory
rings, skipping the skb/socket layers entirely. Everything here is raw
syscalls — no libbpf, no libxdp:

  UMEM:   one mmap'd frame arena registered with XDP_UMEM_REG
  rings:  fill + completion (UMEM) and RX (socket), each an mmap'd
          SPSC ring of {producer, consumer} u32 heads + descriptors,
          laid out per getsockopt(XDP_MMAP_OFFSETS)
  redir:  a 4-insn XDP program (agent/bpf.py assembler):
          bpf_redirect_map(xskmap, queue, XDP_PASS) — falls back to
          the stack when the map slot is empty
  attach: netlink RTM_SETLINK + IFLA_XDP nested attrs, generic
          (SKB-mode) XDP so veth/lo work in containers

`XdpSource` speaks the capture-source contract (`read_batch`/`close`/
`statistics`) so `CaptureLoop`, the agent bootstrap (engine: xdp) and
the benches drive it like the AF_PACKET ring. RX processing returns
frame COPIES (the pipeline's decode is columnar-batch anyway); the
UMEM frame goes straight back on the fill ring.

The port's own copy of the JAX package's `agent/xdp.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import socket
import struct
from typing import List, Optional, Tuple

from deepflow_tpu_torch.agent import bpf

AF_XDP = 44
SOL_XDP = 283
# setsockopt/getsockopt
XDP_MMAP_OFFSETS = 1
XDP_RX_RING = 2
XDP_UMEM_REG = 4
XDP_UMEM_FILL_RING = 5
XDP_UMEM_COMPLETION_RING = 6
XDP_STATISTICS = 7
# mmap page offsets (linux/if_xdp.h)
XDP_PGOFF_RX_RING = 0
XDP_UMEM_PGOFF_FILL_RING = 0x100000000
XDP_UMEM_PGOFF_COMPLETION_RING = 0x180000000
# bind flags
XDP_COPY = 1 << 1
# netlink
RTM_SETLINK = 19
NLM_F_REQUEST, NLM_F_ACK = 1, 4
IFLA_XDP = 43
IFLA_XDP_FD, IFLA_XDP_FLAGS = 1, 3
XDP_FLAGS_SKB_MODE = 1 << 1
NLMSG_ERROR = 2
# helpers / verdicts
FN_redirect_map = 51
XDP_PASS = 2


class _Ring:
    """One SPSC ring view: producer/consumer u32 heads + desc array."""

    def __init__(self, mem: mmap.mmap, off_prod: int, off_cons: int,
                 off_desc: int, n: int, desc_size: int) -> None:
        self._mem = mem
        self._po, self._co, self._do = off_prod, off_cons, off_desc
        self.n = n
        self.mask = n - 1
        self.desc_size = desc_size

    def _load(self, off: int) -> int:
        return struct.unpack_from("<I", self._mem, off)[0]

    def _store(self, off: int, v: int) -> None:
        struct.pack_into("<I", self._mem, off, v & 0xFFFFFFFF)

    @property
    def producer(self) -> int:
        return self._load(self._po)

    @property
    def consumer(self) -> int:
        return self._load(self._co)


class XdpSource:
    """AF_XDP capture off one (iface, queue). Requires CAP_NET_RAW +
    CAP_NET_ADMIN (the XDP attach); generic XDP mode for container
    interfaces."""

    FRAME_SIZE = 2048

    def __init__(self, iface: str, queue: int = 0,
                 frame_count: int = 1024, batch_size: int = 4096,
                 poll_ms: float = 50.0) -> None:
        self.iface = iface
        self.queue = queue
        self.batch_size = batch_size
        self.poll_ms = poll_ms
        self.frames_captured = 0
        self.errors = 0
        n = frame_count
        if n & (n - 1):
            raise ValueError("frame_count must be a power of two")
        self._closed = False
        self._attached = False
        self._ifindex = socket.if_nametoindex(iface)
        self._sock = socket.socket(AF_XDP, socket.SOCK_RAW, 0)
        try:
            self._setup(n)
        except BaseException:
            self.close()
            raise

    # -- construction ------------------------------------------------------
    def _setup(self, n: int) -> None:
        s = self._sock
        # UMEM arena
        self._umem = mmap.mmap(-1, n * self.FRAME_SIZE)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(self._umem))
        s.setsockopt(SOL_XDP, XDP_UMEM_REG,
                     struct.pack("<QQIIII", addr, n * self.FRAME_SIZE,
                                 self.FRAME_SIZE, 0, 0, 0))
        # ring sizes BEFORE mmap offsets (the kernel sizes the maps)
        s.setsockopt(SOL_XDP, XDP_UMEM_FILL_RING, struct.pack("<I", n))
        s.setsockopt(SOL_XDP, XDP_UMEM_COMPLETION_RING,
                     struct.pack("<I", n))
        s.setsockopt(SOL_XDP, XDP_RX_RING, struct.pack("<I", n))
        off = s.getsockopt(SOL_XDP, XDP_MMAP_OFFSETS, 128)
        # struct xdp_ring_offset {producer, consumer, desc, flags} x
        # {rx, tx, fr, cr}
        vals = struct.unpack_from("<16Q", off)
        rx, fr = vals[0:4], vals[8:12]
        # RX ring: desc = {addr u64, len u32, options u32} (16B)
        rx_len = rx[2] + n * 16
        self._rx_mem = mmap.mmap(s.fileno(), rx_len,
                                 offset=XDP_PGOFF_RX_RING)
        self._rx = _Ring(self._rx_mem, rx[0], rx[1], rx[2], n, 16)
        # fill ring: desc = u64 frame addr
        fr_len = fr[2] + n * 8
        self._fr_mem = mmap.mmap(s.fileno(), fr_len,
                                 offset=XDP_UMEM_PGOFF_FILL_RING)
        self._fr = _Ring(self._fr_mem, fr[0], fr[1], fr[2], n, 8)
        # bind to the queue (copy mode: works on generic XDP drivers).
        # CPython's socket.bind can't marshal sockaddr_xdp — raw libc.
        sa = ctypes.create_string_buffer(
            struct.pack("<HHIII", AF_XDP, XDP_COPY, self._ifindex,
                        self.queue, 0))
        libc = ctypes.CDLL(None, use_errno=True)
        import errno
        import time as _t
        for attempt in range(30):
            if libc.bind(s.fileno(), sa, 16) == 0:
                break
            err = ctypes.get_errno()
            # a just-closed XSK releases its (iface, queue) slot
            # asynchronously — EBUSY here is transient
            if err != errno.EBUSY or attempt == 29:
                raise OSError(err, f"AF_XDP bind: {os.strerror(err)}")
            _t.sleep(0.1)
        # give every frame to the kernel via the fill ring
        prod = self._fr.producer
        for i in range(n):
            struct.pack_into("<Q", self._fr_mem,
                             self._fr._do + ((prod + i) & self._fr.mask)
                             * 8, i * self.FRAME_SIZE)
        self._fr._store(self._fr._po, prod + n)
        # XSKMAP[queue] = socket; XDP program redirects, else PASS —
        # un-captured traffic keeps flowing through the stack
        self._xskmap_fd = bpf._bpf(
            bpf.BPF_MAP_CREATE, struct.pack("<IIII", 17, 4, 4,
                                            self.queue + 1))
        kb = ctypes.create_string_buffer(struct.pack("<I", self.queue), 4)
        vb = ctypes.create_string_buffer(struct.pack("<I", s.fileno()), 4)
        attr = struct.pack("<IIQQQ", self._xskmap_fd, 0,
                           ctypes.addressof(kb), ctypes.addressof(vb), 0)
        bpf._bpf(bpf.BPF_MAP_UPDATE_ELEM, attr)
        a = bpf.Asm()

        class _M:            # ld_map_fd wants a .fd carrier
            fd = self._xskmap_fd
        # key = ctx->rx_queue_index (xdp_md offset 16) — NOT the
        # configured constant: on a multi-queue NIC, packets from other
        # queues must look up an ABSENT map slot so redirect_map falls
        # back to XDP_PASS instead of blackholing them into an XSK
        # bound to a different queue
        a.ldx_mem(bpf.BPF_W, bpf.R2, bpf.R1, 16)
        a.ld_map_fd(bpf.R1, _M)
        a.mov_imm(bpf.R3, XDP_PASS)
        a.call(FN_redirect_map)
        a.exit()
        self._prog = bpf.load(a.assemble(),
                              prog_type=bpf.BPF_PROG_TYPE_XDP)
        self._netlink_attach(self._prog.fd)
        self._attached = True
        self._sock.settimeout(self.poll_ms / 1e3)

    def _netlink_attach(self, prog_fd: int) -> None:
        """RTM_SETLINK with nested IFLA_XDP {fd, flags=SKB_MODE} — and
        the kernel's NLMSG_ERROR answer checked, not assumed."""
        def attr(t: int, payload: bytes) -> bytes:
            ln = 4 + len(payload)
            return struct.pack("<HH", ln, t) + payload \
                + b"\x00" * ((4 - ln % 4) % 4)

        nested = attr(IFLA_XDP_FD, struct.pack("<i", prog_fd)) \
            + attr(IFLA_XDP_FLAGS, struct.pack("<I", XDP_FLAGS_SKB_MODE))
        ifla = attr(IFLA_XDP | 0x8000, nested)      # NLA_F_NESTED
        ifinfo = struct.pack("<BxHiII", 0, 0, self._ifindex, 0, 0)
        payload = ifinfo + ifla
        hdr = struct.pack("<IHHII", 16 + len(payload), RTM_SETLINK,
                          NLM_F_REQUEST | NLM_F_ACK, 1, 0)
        nl = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, 0)
        try:
            nl.bind((0, 0))
            nl.send(hdr + payload)
            resp = nl.recv(4096)
            _, msg_type = struct.unpack_from("<IH", resp)
            if msg_type == NLMSG_ERROR:
                err = struct.unpack_from("<i", resp, 16)[0]
                if err != 0:
                    raise OSError(-err, f"XDP attach: "
                                  f"{os.strerror(-err)}")
        finally:
            nl.close()

    def _netlink_detach(self) -> None:
        try:
            self._netlink_attach(-1)     # fd -1 = remove program
        except OSError:
            pass                         # interface may be gone

    # -- capture contract --------------------------------------------------
    def read_batch(self) -> Tuple[List[bytes], List[int]]:
        import select
        import time
        frames: List[bytes] = []
        stamps: List[int] = []
        deadline = time.monotonic() + self.poll_ms / 1e3
        rx, fr = self._rx, self._fr
        while len(frames) < self.batch_size:
            cons, prod = rx.consumer, rx.producer
            if cons == prod:
                left = deadline - time.monotonic()
                if left <= 0 or not select.select(
                        [self._sock], [], [], left)[0]:
                    break
                continue
            # u32 ring heads: the difference must be taken mod 2^32 or
            # a wrapped producer reads as negative and frames leak
            avail = (prod - cons) & 0xFFFFFFFF
            take = min(avail, self.batch_size - len(frames))
            now = time.time_ns()
            fp = fr.producer
            for i in range(take):
                off = rx._do + ((cons + i) & rx.mask) * 16
                addr, ln = struct.unpack_from("<QI", self._rx_mem, off)
                base = addr - addr % self.FRAME_SIZE
                frames.append(bytes(self._umem[addr:addr + ln]))
                stamps.append(now)
                # recycle the frame: back on the fill ring (producer
                # head published once per batch, below)
                struct.pack_into("<Q", self._fr_mem,
                                 fr._do + ((fp + i) & fr.mask) * 8, base)
            fr._store(fr._po, fp + take)
            rx._store(rx._co, cons + take)
        self.frames_captured += len(frames)
        return frames, stamps

    def statistics(self) -> Tuple[int, int]:
        """(rx_dropped, rx_ring_full) from XDP_STATISTICS.
        struct xdp_statistics: {rx_dropped, rx_invalid_descs,
        tx_invalid_descs, rx_ring_full, rx_fill_ring_empty_descs,
        tx_ring_empty_descs} — ring_full is field 3, not 2."""
        raw = self._sock.getsockopt(SOL_XDP, XDP_STATISTICS, 48)
        vals = struct.unpack_from("<6Q", raw.ljust(48, b"\x00"))
        return vals[0], vals[3]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._attached:
            self._netlink_detach()
        for name in ("_prog",):
            p = getattr(self, name, None)
            if p is not None:
                p.close()
        fd = getattr(self, "_xskmap_fd", None)
        if fd is not None:
            os.close(fd)
        for name in ("_rx_mem", "_fr_mem"):
            m = getattr(self, name, None)
            if m is not None:
                m.close()
        self._sock.close()
        umem = getattr(self, "_umem", None)
        if umem is not None:
            # mmap with live ctypes buffer export refuses close();
            # drop our references first
            try:
                umem.close()
            except BufferError:
                pass


def available(iface: str = "lo") -> bool:
    """Can this kernel/container run the full AF_XDP path here?"""
    try:
        src = XdpSource(iface, frame_count=64)
        src.close()
        return True
    except (OSError, ValueError):
        return False
