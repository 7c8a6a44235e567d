"""The port's AF_XDP capture source (`deepflow_tpu_torch/agent/xdp.py`)
against the JAX package's, on the CPU.

Both packages' `XdpSource._setup` run against the same recording kernel
stand-ins (the XSK socket's options and ring offsets, the mmaps, the
bind, the XSKMAP and the program load, the netlink attach): every
socket option, ring view (producer, consumer and descriptor offsets),
the fill ring's contents, the sockaddr, the map's attributes, the XDP
redirect program's instruction bytes and the RTM_SETLINK message must
be equal, and a second ring layout must move both alike. One live
roundtrip attaches the port's program to lo (generic mode) and reads
datagrams out of the XSK ring; while attached, the redirect consumes
lo's ingress, so it is the suite's only one besides the JAX package's
own and keeps its window short. The bootstrap's XDP validation is the
JAX package's test, run against the port.
"""

import ctypes
import mmap as _mmap
import socket
import struct
import time
import types

import pytest

import torch_ctl_pair as cp

from deepflow_tpu.agent import bpf as jbpf
from deepflow_tpu.agent import xdp as jxdp
from deepflow_tpu_torch.agent import bpf as tbpf
from deepflow_tpu_torch.agent import xdp as txdp


class _FakeXsk:
    def __init__(self, rec, offsets):
        self.rec, self.offsets = rec, offsets

    def setsockopt(self, level, opt, value):
        if opt == txdp.XDP_UMEM_REG:      # the arena's address varies
            value = b"\x00" * 8 + value[8:]
        self.rec.append(("setsockopt", level, opt, value))

    def getsockopt(self, level, opt, n):
        self.rec.append(("getsockopt", level, opt, n))
        return self.offsets

    def fileno(self):
        return 99

    def settimeout(self, t):
        self.rec.append(("settimeout", t))

    def close(self):
        pass


class _FakeNetlink:
    def __init__(self, rec):
        self.rec = rec

    def bind(self, addr):
        pass

    def send(self, msg):
        self.rec.append(("netlink", msg))

    def recv(self, n):            # NLMSG_ERROR with error 0: an ACK
        return struct.pack("<IHHII", 36, txdp.NLMSG_ERROR, 0, 1, 0) \
            + struct.pack("<i", 0) + bytes(16)

    def close(self):
        pass


def _setup_trace(xdp, bpf, offsets, n, monkeypatch):
    """XdpSource._setup(n) of one package on recording stand-ins; the
    trace of every call it made, and its ring views."""
    rec, maps = [], []
    src = xdp.XdpSource.__new__(xdp.XdpSource)
    src.iface, src.queue, src.poll_ms = "lo", 0, 50.0
    src._closed, src._attached, src._ifindex = False, False, 1
    src._sock = _FakeXsk(rec, offsets)

    def fake_mmap(fd, length, offset=0, **kw):
        rec.append(("mmap", fd, length, offset))
        m = _mmap.mmap(-1, max(length, 1))
        maps.append(m)
        return m

    def fake_bpf(cmd, attr):
        if cmd == bpf.BPF_MAP_CREATE:
            rec.append(("map_create", attr))
            return 77
        # key and value are pointers: keep the values they point at
        _, _, kp, vp, flags = struct.unpack("<IIQQQ", attr)
        rec.append(("map_update", ctypes.string_at(kp, 4),
                    ctypes.string_at(vp, 4), flags))
        return 0

    class Prog:
        fd = 88

        def close(self):
            pass

    def fake_load(insns, prog_type=None):
        rec.append(("load", insns, prog_type))
        return Prog()

    class Libc:
        def bind(self, fd, sa, n):
            rec.append(("bind", fd, sa.raw[:n]))
            return 0

    sock_ns = types.SimpleNamespace(**{k: getattr(socket, k)
                                       for k in dir(socket)
                                       if not k.startswith("__")})
    sock_ns.socket = lambda *a, **k: _FakeNetlink(rec)
    with monkeypatch.context() as mp:
        mp.setattr(xdp, "mmap", types.SimpleNamespace(
            mmap=fake_mmap, PAGESIZE=_mmap.PAGESIZE))
        mp.setattr(xdp, "socket", sock_ns)
        mp.setattr(bpf, "_bpf", fake_bpf)
        mp.setattr(bpf, "load", fake_load)
        mp.setattr(ctypes, "CDLL", lambda *a, **k: Libc())
        src._setup(n)
        src._netlink_attach(-1)          # the detach message
    rings = {name: (r._po, r._co, r._do, r.n, r.mask, r.desc_size)
             for name, r in (("rx", src._rx), ("fill", src._fr))}
    fill = bytes(src._fr_mem)
    for m in maps:
        m.close()
    return rec, rings, fill


@pytest.mark.parametrize("n", [64, 1024])
def test_setup_trace_equal(n, monkeypatch):
    # {producer, consumer, desc, flags} for rx, tx, fill, completion
    layouts = [struct.pack("<16Q", *([0, 64, 128, 192] * 4)),
               struct.pack("<16Q", *([256, 320, 384, 0] * 4))]
    runs = []
    for offsets in layouts:
        j = _setup_trace(jxdp, jbpf, offsets, n, monkeypatch)
        t = _setup_trace(txdp, tbpf, offsets, n, monkeypatch)
        assert t == j
        runs.append(j)
    rec, rings, fill = runs[0]
    kinds = [r[0] for r in rec]
    assert kinds.count("load") == 1 and kinds.count("netlink") == 2
    load = next(r for r in rec if r[0] == "load")
    # ldx, ld_imm64 (two slots), mov, call, exit
    assert load[2] == tbpf.BPF_PROG_TYPE_XDP and len(load[1]) == 6 * 8
    # the fill ring hands the kernel every frame, in order
    do = rings["fill"][2]
    assert struct.unpack_from(f"<{n}Q", fill, do) == tuple(
        i * txdp.XdpSource.FRAME_SIZE for i in range(n))
    assert runs[1][1] != rings          # the kernel's layout moves both


def test_xdp_roundtrip_on_lo():
    """The port's program on lo: 50 datagrams out of the XSK ring, then
    the program detached and lo's ingress flowing again."""
    try:
        src = txdp.XdpSource("lo", frame_count=256)
    except OSError as e:
        pytest.skip(f"AF_XDP refused here: {e}")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(50):
            tx.sendto(b"txdp-%d" % i, ("127.0.0.1", 55979))
        tx.close()
        deadline, hits = time.time() + 3, 0
        while time.time() < deadline and hits < 50:
            frames, stamps = src.read_batch()
            assert len(stamps) == len(frames)
            hits += sum(1 for f in frames if b"txdp-" in f)
        assert hits == 50
        assert src.statistics()[0] == 0
    finally:
        src.close()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.sendto(b"after", rx.getsockname())
    tx.close()
    assert rx.recv(16) == b"after"
    rx.close()


# -- the JAX package's bootstrap check for XDP, on the port (the file's
# live tests attach XDP to lo and stay with the JAX suite) --------------------
test_ref_xdp_bootstrap_validation = cp.reference_function(
    cp.TESTS / "test_xdp.py", "test_xdp_bootstrap_validation")
