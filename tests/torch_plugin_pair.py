"""Helpers for the tests that hold the port's agent plugins and kernel
capture modules (`deepflow_tpu_torch/agent/{plugin,wasm_*,k8s_watch,
profiler,integration,bpf,xdp}.py`) against the JAX package's: a fixture
that leaves both packages' L7 parser registries as it found them, one
that makes the port's `Agent` default to the CPU, and a seeded corpus of
memcached and foreign payloads. Not a test file."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from deepflow_tpu.agent import l7 as jl7
from deepflow_tpu_torch.agent import l7 as tl7
from deepflow_tpu_torch.agent import trident as ttrident

REPO = Path(__file__).resolve().parent.parent
JAX_NATIVE = REPO / "deepflow_tpu" / "agent" / "native_src"
PORT_NATIVE = REPO / "deepflow_tpu_torch" / "agent" / "native_src"
SO_FLAGS = ("-shared", "-fPIC", "-O2", "-std=c++17")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ unavailable")


@pytest.fixture(autouse=True)
def clean_registries():
    """Unload every parser a test registers into either package's global
    registry (`l7.PARSERS`): other tests share the process under
    `--dist loadfile`."""
    before = {id(p) for p in jl7.PARSERS}, {id(p) for p in tl7.PARSERS}
    yield
    for reg, ids in ((jl7.PARSERS, before[0]), (tl7.PARSERS, before[1])):
        for p in [p for p in reg if id(p) not in ids]:
            reg.remove(p)


@pytest.fixture
def agent_on_cpu(monkeypatch):
    """The port's `Agent` defaults to the card; the JAX test bodies build
    it without a device, so here it defaults to the CPU."""
    monkeypatch.setitem(ttrident.Agent.__init__.__kwdefaults__, "device",
                        "cpu")


def build_so(native_dir, out):
    """The memcached sample plugin from one package's copy of the C++
    source, built with the flags both packages' tests use."""
    subprocess.run(["g++", *SO_FLAGS, str(Path(native_dir)
                                          / "memcached_plugin.cc"),
                    "-o", str(out)], check=True, cwd=str(native_dir),
                   capture_output=True)
    return str(out)


_REQUESTS = ("get", "gets", "set", "add", "replace", "append", "prepend",
             "cas", "delete", "incr", "decr", "touch", "stats",
             "flush_all", "version", "quit")
_RESPONSES = ("VALUE", "END", "STORED", "NOT_STORED", "EXISTS",
              "NOT_FOUND", "DELETED", "TOUCHED", "OK", "ERROR",
              "CLIENT_ERROR", "SERVER_ERROR", "STAT", "VERSION")


def memcached_corpus(rng, n=400):
    """`n` payloads drawn from `rng`: memcached requests and responses
    (keys up to 200 bytes, so endpoints truncate), foreign protocols,
    near misses (upper case, no newline, under 3 bytes) and random
    bytes, some past the wasm plugin's 4 KB payload copy."""
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 8))
        key = "k" * int(rng.integers(0, 200)) + str(int(rng.integers(1e6)))
        if kind <= 2:
            cmd = _REQUESTS[int(rng.integers(len(_REQUESTS)))]
            tail = " 0 60 5\r\nhello" if cmd in ("set", "add") else ""
            out.append(f"{cmd} {key}{tail}\r\n".encode())
        elif kind <= 4:
            word = _RESPONSES[int(rng.integers(len(_RESPONSES)))]
            rest = f" {key} 0 3\r\nabc\r\nEND" if word == "VALUE" else \
                " out of memory" if word.endswith("_ERROR") else ""
            out.append(f"{word}{rest}\r\n".encode())
        elif kind == 5:
            near = (b"GET / HTTP/1.1\r\n\r\n", b"GET x\r\n",
                    b"get without newline", b"ge\n", b"\r\n", b"get",
                    b"STORED")
            out.append(near[int(rng.integers(len(near)))])
        elif kind == 6:
            out.append(rng.integers(0, 256, int(rng.integers(1, 64)),
                                    np.uint8).tobytes())
        else:
            out.append(b"get " + b"x" * int(rng.integers(4000, 5000))
                       + b"\r\n")
    return out


def record_tuple(rec):
    """An L7Record as a plain tuple (None stays None)."""
    if rec is None:
        return None
    return (rec.proto, rec.msg_type, rec.endpoint, rec.status, rec.req_len,
            rec.resp_len)
