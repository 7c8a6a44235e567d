"""ctypes binding for the C++ TAGGEDFLOW decoder (native_src/decoder.cc).

The port's own copy of the JAX package's native decoder: the same C ABI,
the same columns. `g++` builds the shared library on first use, never at
import, into `build/deepflow_tpu_torch/` beside the CUDA libraries
(`ops/_build.BUILD_DIR`), under a name keyed by the source, the flags and
the CPU that `-march=native` resolves to, so a library built on one host
is never loaded on another. The build writes a temporary name and
`os.replace`s it, so processes that build at once never load a
half-written file. `available()` is False when no compiler exists or the
build fails (`build_error()` says why, logged once at WARNING); the
l4 decoders then keep the Python decoder, which gives identical columns.

The ABI emits two plane blocks per batch: a [N32, capacity] u32 block for
every u32/i32 column of `batch/schema.L4_SCHEMA` and a [N64, capacity]
u64 block for the 64-bit tail (macs, flow_id, microsecond clocks), each
in schema order. The walker releases the interpreter lock (a ctypes
call), so decoders on several threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.batch.schema import L4_SCHEMA
from deepflow_tpu_torch.ops._build import BUILD_DIR

__all__ = ["available", "build_error", "decode_l4_into",
           "decode_l4_payload", "decode_l4_records", "PipelinedDecoder",
           "L4_COLS32", "L4_COLS64"]

_LOG = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "native_src" / "decoder.cc"
# -O3 -march=native -funroll-loops is load-bearing: the varint walk runs
# ~3x faster than at generic -O2
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17")

# schema columns partitioned by plane width (order preserved per plane)
L4_COLS32 = tuple((n, d) for n, d in L4_SCHEMA.columns
                  if np.dtype(d).itemsize == 4)
L4_COLS64 = tuple((n, d) for n, d in L4_SCHEMA.columns
                  if np.dtype(d).itemsize == 8)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
so_path: Optional[Path] = None       # the library loaded, once built


def _target_key(gxx: str) -> str:
    """The source, the flags and the target `-march=native` expands to
    on this host (the preprocessor's cc1 line), hashed."""
    proc = subprocess.run([gxx, "-march=native", "-E", "-v", "-"],
                          input="", capture_output=True, text=True,
                          timeout=60)
    target = "\n".join(line for line in proc.stderr.splitlines()
                       if "cc1" in line and "-march=" in line)
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(target.encode())
    return h.hexdigest()[:16]


def _build() -> Tuple[Optional[Path], Optional[str]]:
    """Compile unless this host's library is built; (path, None) or
    (None, error)."""
    gxx = "g++"
    try:
        out = BUILD_DIR / f"libnative_decoder-{_target_key(gxx)}.so"
        if out.exists():
            return out, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"native decoder build: {e}"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"native decoder build: {e}"
    if proc.returncode != 0:
        return None, proc.stderr[-2000:] or f"g++ exit {proc.returncode}"
    os.replace(tmp, out)
    return out, None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error, so_path
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path, err = _build()
        if err is None:
            lib = ctypes.CDLL(str(path))
            lib.df_decode_l4.restype = ctypes.c_long
            lib.df_decode_l4.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.df_decode_l4_mt.restype = ctypes.c_long
            lib.df_decode_l4_mt.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
                ctypes.c_int, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.df_n_l4_cols.restype = ctypes.c_int
            lib.df_n_l4_cols64.restype = ctypes.c_int
            n32, n64 = lib.df_n_l4_cols(), lib.df_n_l4_cols64()
            if n32 != len(L4_COLS32) or n64 != len(L4_COLS64):
                err = (f"column count mismatch: native {n32}+{n64} vs "
                       f"schema {len(L4_COLS32)}+{len(L4_COLS64)}")
        if err is not None:
            _build_error = err
            _LOG.warning("native TAGGEDFLOW decoder unavailable, the "
                         "Python decoder runs instead: %s", err)
            return None
        _lib, so_path = lib, path
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def decode_l4_into(payload: bytes, out32: np.ndarray, out64: np.ndarray,
                   n_threads: int = 1) -> Tuple[int, int, int]:
    """Zero-alloc decode into caller-owned [N32, capacity] uint32 and
    [N64, capacity] uint64 buffers. Returns (rows, bad_records,
    consumed_bytes); the buffers can be reused across calls."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    assert out32.ndim == 2 and out32.shape[0] == len(L4_COLS32) and \
        out32.dtype == np.uint32 and out32.flags.c_contiguous
    assert out64.ndim == 2 and out64.shape[0] == len(L4_COLS64) and \
        out64.dtype == np.uint64 and out64.flags.c_contiguous
    assert out32.shape[1] == out64.shape[1]
    capacity = out32.shape[1]
    bad = ctypes.c_long()
    consumed = ctypes.c_size_t()
    p32 = out32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    p64 = out64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    if n_threads == 1:
        rows = lib.df_decode_l4(payload, len(payload), p32, p64, capacity,
                                ctypes.byref(bad), ctypes.byref(consumed))
    else:
        rows = lib.df_decode_l4_mt(payload, len(payload), p32, p64,
                                   capacity, n_threads, ctypes.byref(bad),
                                   ctypes.byref(consumed))
    return rows, bad.value, consumed.value


def _mats_to_cols(mat32: np.ndarray,
                  mat64: np.ndarray) -> Dict[str, np.ndarray]:
    """Plane rows -> schema columns; int32 columns are views of their u32
    images, so every column has `columnar.decode_l4_records`' dtype."""
    cols: Dict[str, np.ndarray] = {}
    for i, (name, dt) in enumerate(L4_COLS32):
        col = mat32[i]
        cols[name] = col.view(np.int32) if dt == np.dtype(np.int32) \
            else col
    for i, (name, _) in enumerate(L4_COLS64):
        cols[name] = mat64[i]
    return cols


def decode_l4_payload(payload: bytes, capacity: int = 65536,
                      n_threads: int = 1
                      ) -> Tuple[Dict[str, np.ndarray], int]:
    """Decode one packed-record payload -> (L4 columns, bad_record_count).

    `capacity` bounds rows per call; the payload past it is decoded in
    further passes, so the result always covers the whole payload."""
    n32, n64 = len(L4_COLS32), len(L4_COLS64)
    chunks = []
    bad_total = 0
    view = payload
    while True:
        out32 = np.empty((n32, capacity), np.uint32)
        out64 = np.empty((n64, capacity), np.uint64)
        rows, bad, consumed = decode_l4_into(view, out32, out64,
                                             n_threads=n_threads)
        bad_total += bad
        if rows > 0:
            chunks.append((out32[:, :rows].copy(), out64[:, :rows].copy()))
        if consumed >= len(view) or rows == 0:
            break
        view = view[consumed:]
    if chunks:
        mat32 = np.concatenate([c[0] for c in chunks], axis=1)
        mat64 = np.concatenate([c[1] for c in chunks], axis=1)
    else:
        mat32 = np.empty((n32, 0), np.uint32)
        mat64 = np.empty((n64, 0), np.uint64)
    return _mats_to_cols(mat32, mat64), bad_total


def decode_l4_records(records: Iterable[bytes]) -> Dict[str, np.ndarray]:
    """Same contract as columnar.decode_l4_records, via the native path."""
    from deepflow_tpu_torch.wire.codec import pack_pb_records

    cols, _ = decode_l4_payload(pack_pb_records(records))
    return cols


class PipelinedDecoder:
    """Overlap protobuf decode with the consumer's device work.

    The walker releases the interpreter lock, so decoding on a feeder
    thread overlaps the consumer's copies and launches. Buffer
    discipline: a ring of `n_bufs` (>= 2) (buf32, buf64) pairs cycles
    free -> decoded -> consumed; fetching the next item returns the
    previous slot, so a decoded buffer is never overwritten while the
    consumer still reads it."""

    def __init__(self, capacity: int, n_bufs: int = 3,
                 n_threads: int = 1) -> None:
        if n_bufs < 2:
            raise ValueError("need >=2 buffers to overlap")
        n32, n64 = len(L4_COLS32), len(L4_COLS64)
        self._bufs = [(np.empty((n32, capacity), np.uint32),
                       np.empty((n64, capacity), np.uint64))
                      for _ in range(n_bufs)]
        self.n_threads = n_threads

    def stream(self, payloads):
        """Yield (rows, buf32, buf64) per payload, decode running ahead
        on the feeder thread. A yielded buffer is valid for exactly one
        iteration step. One stream at a time per decoder (the ring is
        shared); the queues are per call and an early break stops the
        feeder, so an aborted or failed stream never poisons the next."""
        free: "queue.Queue[int]" = queue.Queue()
        for i in range(len(self._bufs)):
            free.put(i)
        ready: queue.Queue = queue.Queue()
        stop = threading.Event()

        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()

        def feeder():
            try:
                for p in payloads:
                    while True:              # stoppable slot wait
                        if stop.is_set():
                            return
                        sup.beat()
                        try:
                            i = free.get(timeout=0.1)
                            break
                        except queue.Empty:
                            continue
                    b32, b64 = self._bufs[i]
                    rows, _bad, _ = decode_l4_into(
                        p, b32, b64, n_threads=self.n_threads)
                    ready.put((i, rows))
            except BaseException as e:      # surfaced on the consumer
                ready.put(e)
            finally:
                ready.put(None)

        # supervised (crash capture, deadman beat from the slot wait);
        # restart=False: a re-entered feeder would iterate `payloads`
        # twice, and its errors already reach the consumer via `ready`
        t = sup.spawn("pb-decode", feeder, restart=False)
        held = None
        try:
            while True:
                got = ready.get()
                if got is None:
                    break
                if isinstance(got, BaseException):
                    raise got
                i, rows = got
                if held is not None:
                    free.put(held)          # previous slot now reusable
                held = i
                b32, b64 = self._bufs[i]
                yield rows, b32, b64
        finally:
            stop.set()                      # unblock an early-break feeder
            t.stop()
            t.join(timeout=5)
