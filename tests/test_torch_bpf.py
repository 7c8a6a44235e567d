"""The port's eBPF toolkit and capture filter (`deepflow_tpu_torch/agent/
bpf.py`) against the JAX package's, on the CPU.

Both packages' assemblers emit identical instruction bytes for the same
programs (every instruction form, jump labels forward and back, the
64-bit map load), and `build_capture_filter` emits identical programs
over a grid of `proto`/`port`/`sample_shift` (the kernel load replaced
by a recorder; the same refusals where a protocol has no ports). One
live check attaches each package's `BpfFilter` to a raw socket on lo and
sends a seeded number of datagrams to a port only this test uses: both
accept exactly twice (lo's egress and ingress) what was sent there. The
JAX package's bpf tests that load programs but send no traffic then run
against the port (`torch_ctl_pair.adopt_reference_tests`); its traffic
tests stay with the JAX suite.
"""

import socket
import time

import numpy as np
import pytest

import torch_ctl_pair as cp

from deepflow_tpu.agent import bpf as jbpf
from deepflow_tpu_torch.agent import bpf as tbpf


class _Map:                 # ld_map_fd reads .fd
    fd = 42


def _program(bpf):
    """Every instruction form, labels forward and back."""
    a = bpf.Asm()
    a.mov_reg(bpf.R6, bpf.R1).mov_imm(bpf.R0, -7).mov32_imm(bpf.R7,
                                                            0xFFFFFFFF)
    a.ld_abs(bpf.BPF_H, 12).ld_abs(bpf.BPF_B, 23).ld_abs(bpf.BPF_W, 26)
    a.label("top")
    a.alu_imm(bpf.BPF_ADD, bpf.R2, -4).alu_reg(bpf.BPF_ADD, bpf.R3, bpf.R2)
    a.alu_imm(bpf.BPF_AND, bpf.R8, 0xFF)
    a.ldx_mem(bpf.BPF_W, bpf.R2, bpf.R1, 16)
    a.stx_mem(bpf.BPF_DW, bpf.R10, bpf.R2, -8)
    a.st_imm(bpf.BPF_W, bpf.R10, -4, 3)
    a.atomic_add(bpf.BPF_DW, bpf.R0, bpf.R8, 0)
    a.atomic_fetch_add(bpf.BPF_DW, bpf.R0, bpf.R8, 8)
    a.ld_map_fd(bpf.R1, _Map)
    a.call(bpf.FN_map_lookup_elem)
    a.jmp_imm(bpf.BPF_JEQ, bpf.R0, 0, "out")
    a.jmp_reg(bpf.BPF_JNE, bpf.R2, bpf.R3, "top")
    a.jmp("out")
    a.label("out")
    a.exit_imm(0xFFFF)
    return a.assemble()


def test_assemblers_emit_equal_bytes():
    assert _program(tbpf) == _program(jbpf)
    assert len(_program(tbpf)) % 8 == 0
    assert tbpf.Asm().exit_imm(7).assemble() == \
        jbpf.Asm().exit_imm(7).assemble()
    for imm in (0, 1, -1, 0x7FFFFFFF, 0xFFFFFFFF, -(2 ** 31)):
        assert tbpf._insn(0xb7, 1, 2, -3, imm) == jbpf._insn(0xb7, 1, 2, -3,
                                                             imm)


def _filter(bpf, monkeypatch, **spec):
    with monkeypatch.context() as mp:
        mp.setattr(bpf, "load", lambda insns, *a, **k: insns)
        try:
            return bpf.build_capture_filter(_Map, **spec)
        except ValueError as e:
            return f"ValueError: {e}"


@pytest.mark.parametrize("proto", [None, 1, 6, 17, 132])
def test_capture_filter_programs_equal(proto, monkeypatch):
    for port in (None, 0, 53, 443, 65535):
        for shift in (0, 1, 5, 31):
            spec = dict(proto=proto, port=port, sample_shift=shift)
            j = _filter(jbpf, monkeypatch, **spec)
            t = _filter(tbpf, monkeypatch, **spec)
            assert t == j, spec
            if proto == 1 and port is not None:
                assert t.startswith("ValueError"), spec


def test_filter_verdicts_equal_on_lo():
    """Both packages' filters on raw sockets on lo at once: each accepts
    2n for n datagrams to its port, none of those to another."""
    from deepflow_tpu_torch.agent.afpacket import AfPacketSource
    if not tbpf.available():
        pytest.skip("bpf(2) socket filters refused here")
    rng = np.random.default_rng(0xB9)
    n = int(rng.integers(50, 150))
    ports = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(2)]
    for s in ports:
        s.bind(("127.0.0.1", 0))
    hit, miss = (s.getsockname()[1] for s in ports)
    filters = [mod.BpfFilter(proto=17, port=hit) for mod in (jbpf, tbpf)]
    srcs = []
    try:
        for f in filters:
            srcs.append(AfPacketSource("lo", batch_size=256, poll_ms=50,
                                       prepare=f.attach_socket))
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(n):
            tx.sendto(b"hit-%d" % i, ("127.0.0.1", hit))
            tx.sendto(b"miss-%d" % i, ("127.0.0.1", miss))
        tx.close()
        time.sleep(0.2)
        c = [f.counters() for f in filters]
    finally:
        for s in srcs + ports:
            s.close()
        for f in filters:
            f.close()
    assert c[1]["bpf_accepted"] == c[0]["bpf_accepted"] == 2 * n
    assert c[1]["bpf_seen"] >= 4 * n and c[0]["bpf_seen"] >= 4 * n


# -- the JAX package's bpf tests without traffic, on the port -----------------
cp.adopt_reference_tests(
    globals(), cp.TESTS / "test_bpf.py",
    only=("test_insn_encoding_golden",
          "test_verifier_rejects_bad_program_with_log", "test_map_roundtrip",
          "test_unconstrained_filter_loads_and_accepts",
          "test_imm_encoding_folds_unsigned",
          "test_portless_proto_with_port_rejected",
          "test_bootstrap_bpf_value_types", "test_bootstrap_bpf_validation"))
