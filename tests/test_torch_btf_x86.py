"""The port's x86-64 length decoder and BTF reader (`deepflow_tpu_torch/
agent/{x86_decode,btf}.py`) against the JAX package's, on the CPU.

`find_ret_offsets` and the `insn_len` walk give equal offsets (or the
same refusal) on every function of compiled binaries (a C file at -O0,
-O2 and -O3 -mavx2, and this interpreter's own image) and on seeded byte
strings. `Btf.member_offset` gives equal answers on synthetic BTF blobs
(structs, unions, forward declarations, bitfields, every kind the
reader skips over) and on this kernel's BTF where it is readable, and
`fsbase_offset` on both. The JAX package's `test_btf.py` and its
fs-based goid live test (`test_attach_live_fs_goid.py`) then run against
the port under their own marks.
"""

import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

import torch_ctl_pair as cp
import torch_ebpf_pair as ep

JM, TM = ep.both()
_cc = shutil.which("gcc") or shutil.which("cc")

C_SRC = r"""
#include <stdint.h>
#include <string.h>
double f1(double x, int n){ double s=0; for(int i=0;i<n;i++){ s += x*i;
  if (s>1e9) return s; } return s; }
int f2(const char*a, const char*b){ if(!a) return -1; int r = strcmp(a,b);
  return r ? r : (int)strlen(a); }
uint64_t f3(uint64_t x){ x ^= x>>33; x *= 0xff51afd7ed558ccdULL;
  x ^= x>>33; return x; }
void f4(float*d, const float*s, int n){ for(int i=0;i<n;i++)
  d[i] = s[i]*2.0f + 1.0f; }
int f5(int k){ switch(k){ case 0: return 7; case 1: return 9;
  case 2: return 11; case 3: return 13; default: return k*3; } }
int main(int c, char**v){ float d[8], s[8] = {0};
  f4(d, s, c); return f5(c) + (int)f1(1.5, c) + (int)f3(c); }
"""


def _outcome(m, code):
    """(boundaries, ret offsets) of one body, or the refusal."""
    x86 = m.x86_decode
    try:
        i, bounds = 0, []
        while i < len(code):
            bounds.append(i)
            i += x86.insn_len(code, i)
        return bounds, x86.find_ret_offsets(code)
    except x86.DecodeError as e:
        return "DecodeError", str(e)


def _bodies(path, limit=400):
    """Function bodies of an ELF image, by the port's readers."""
    up = TM.uprobe_trace
    data = open(path, "rb").read()
    out = {}
    for sym, (vaddr, size) in sorted(up.elf_func_table(path).items()):
        off = up.vaddr_to_offset(path, vaddr)
        if off is not None and size:
            out[sym] = data[off:off + size]
        if len(out) >= limit:
            break
    return out


@pytest.mark.skipif(_cc is None, reason="no C toolchain")
@pytest.mark.parametrize("flags", [("-O0",), ("-O2",), ("-O3", "-mavx2")])
def test_ret_offsets_equal_on_compiled_code(tmp_path, flags):
    src = tmp_path / "t.c"
    src.write_text(C_SRC)
    exe = tmp_path / "t"
    subprocess.run([_cc, *flags, str(src), "-o", str(exe)], check=True)
    bodies = _bodies(str(exe))
    assert {"f1", "f2", "f3", "f4", "f5", "main"} <= set(bodies)
    for sym, code in bodies.items():
        t = _outcome(TM, code)
        assert t == _outcome(JM, code), sym
        if sym.startswith("f"):
            assert t[0] != "DecodeError" and t[1], sym


def test_ret_offsets_equal_on_the_interpreter():
    bodies = _bodies(os.path.realpath(sys.executable))
    decoded = 0
    for sym, code in bodies.items():
        t = _outcome(TM, code)
        assert t == _outcome(JM, code), sym
        decoded += t[0] != "DecodeError"
    assert decoded or not bodies


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decoder_equal_on_seeded_bytes(seed):
    rng = np.random.default_rng((19, 70, seed))
    refused = 0
    for _ in range(300):
        code = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                  dtype=np.uint8))
        t = _outcome(TM, code)
        assert t == _outcome(JM, code), code.hex()
        refused += t[0] == "DecodeError"
    assert 0 < refused < 300


# -- BTF --------------------------------------------------------------------
def _btf_blob(rng):
    """A BTF blob: task_struct and thread_struct (with forward
    declarations first, a union, a bitfield struct with kind_flag) among
    types of every kind the reader steps over. Returns (blob, {(struct,
    member): byte offset or None}) for the lookups asked."""
    strings = [b""]

    def s(name):
        strings.append(name.encode())
        return sum(len(x) + 1 for x in strings[:-1])

    types, want = b"", {}

    def t(name_off, kind, vlen, size, body, kind_flag=0):
        return struct.pack("<III", name_off, (kind_flag << 31)
                           | (kind << 24) | vlen, size) + body
    types += t(s("int"), 1, 0, 4, struct.pack("<I", 32))
    types += t(0, 3, 0, 0, struct.pack("<III", 1, 1, 16))
    types += t(s("e"), 6, 2, 4, bytes(16))
    types += t(s("e64"), 19, 1, 8, bytes(12))
    types += t(0, 13, 2, 1, bytes(16))
    types += t(s("v"), 14, 0, 1, bytes(4))
    types += t(s(".data"), 15, 1, 8, bytes(12))
    types += t(s("tag"), 17, 0, 1, bytes(4))
    types += t(s("ptr"), 2, 0, 1, b"")
    for name in ("task_struct", "thread_struct"):
        types += t(s(name), 4, 0, 0, b"")          # forward declaration
    for name, members in (
            ("task_struct", ("state", "pid", "tgid", "thread")),
            ("thread_struct", ("sp", "es", "fsbase", "gsbase")),
            ("u", ("a", "b"))):
        offs = sorted(int(x) * 8 for x in rng.choice(
            512, len(members), replace=False))
        body = b"".join(struct.pack("<III", s(mb), 1, off)
                        for mb, off in zip(members, offs))
        types += t(s(name), 5 if name == "u" else 4, len(members), 4096,
                   body)
        for mb, off in zip(members, offs):
            want[(name, mb)] = off // 8
    # kind_flag: bitfield size in the top byte, offset below; one
    # member at a non-byte bit offset
    body = struct.pack("<III", s("flags"), 1, (3 << 24) | 64) \
        + struct.pack("<III", s("bit"), 1, (1 << 24) | 67)
    types += t(s("bits"), 4, 2, 16, body, kind_flag=1)
    want[("bits", "flags")] = 8
    want[("bits", "bit")] = None
    want[("task_struct", "nope")] = None
    want[("missing", "x")] = None
    strtab = b"\0".join(strings) + b"\0"
    hdr = struct.pack("<HBBIIIII", 0xEB9F, 1, 0, 24, 0, len(types),
                      len(types), len(strtab))
    return hdr + types + strtab, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_btf_member_offsets_equal(tmp_path, seed):
    blob, want = _btf_blob(np.random.default_rng((19, 71, seed)))
    jb, tb = JM.btf.Btf(blob), TM.btf.Btf(blob)
    for (name, member), off in want.items():
        assert tb.member_offset(name, member) == \
            jb.member_offset(name, member) == off, (name, member)
    p = tmp_path / "vmlinux"
    p.write_bytes(blob)
    got = TM.btf.fsbase_offset(str(p))
    assert got == JM.btf.fsbase_offset(str(p)) == \
        want[("task_struct", "thread")] + want[("thread_struct", "fsbase")]


def test_btf_live_kernel_equal():
    if not os.access(TM.btf.BTF_PATH, os.R_OK):
        pytest.skip("no readable kernel BTF")
    data = open(TM.btf.BTF_PATH, "rb").read()
    jb, tb = JM.btf.Btf(data), TM.btf.Btf(data)
    for name, member in (("task_struct", "thread"), ("task_struct", "pid"),
                         ("thread_struct", "fsbase"), ("sk_buff", "len"),
                         ("sock", "sk_type"), ("task_struct", "nope")):
        assert tb.member_offset(name, member) == \
            jb.member_offset(name, member)
    assert TM.btf.fsbase_offset() == JM.btf.fsbase_offset()


# -- the JAX package's BTF tests, the fs-based goid live one included -------
cp.adopt_reference_tests(globals(), cp.TESTS / "test_btf.py")
cp.adopt_reference_tests(globals(), cp.TESTS / "test_attach_live_fs_goid.py")
