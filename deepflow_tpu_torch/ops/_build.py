"""Build the CUDA kernels of `deepflow_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C interface (pointers, ints and the
stream) and is compiled by `nvcc` for Hopper (`sm_90a`) into its own
shared library under `build/deepflow_tpu_torch/` at the root of the
checkout, then loaded with ctypes. All sources are compiled at once, one
`nvcc` process each, on the first call in a process; later calls reuse the
loaded libraries. Nothing here runs at import time: the CPU tests import
every module on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "deepflow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: set = set()           # libraries whose argtypes are set
_fns: Dict[Tuple[str, str], object] = {}    # held ctypes functions
build_log: List[str] = []      # nvcc's stderr per source (ptxas report)


class KernelError(Exception):
    """A hand kernel could not be built, loaded or launched. Not a
    `RuntimeError` on purpose: code that contains device errors (the
    exporter's rollback ladder catches `RuntimeError`) lets it through,
    so a broken kernel is never worked around."""


def nvcc_path() -> str:
    """The toolkit's nvcc: PATH first, then PyTorch's idea of CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build "
                       "the deepflow_tpu_torch kernels")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every csrc/*.cu in parallel (one nvcc each) into
    build/deepflow_tpu_torch/lib<name>.so; raise on any failure.
    `verbose` adds `-Xptxas -v` (registers, shared memory, spills per
    kernel) and keeps each nvcc's stderr in `build_log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for src in sources():
        out = BUILD_DIR / f"lib{src.stem}.so"
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs.append((src.stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    built: Dict[str, Path] = {}
    errors = []
    for name, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exit {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        build_log.append(f"{name}.cu:\n{stderr}")
        os.replace(tmp, out)
        built[name] = out
    if errors:
        raise KernelError("kernel build failed:\n" + "\n".join(errors))
    return built


def load_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Build (once per process) and load every kernel library."""
    with _lock:
        if not _libs:
            for stem, path in build_all(verbose).items():
                _libs[stem] = ctypes.CDLL(str(path))
        return dict(_libs)


def load_built() -> Dict[str, ctypes.CDLL]:
    """Load the libraries an earlier build in this checkout left under
    BUILD_DIR, without running nvcc (a child process of a run that built
    them: no two processes race to build); raise if one is missing."""
    with _lock:
        if not _libs:
            for src in sources():
                path = BUILD_DIR / f"lib{src.stem}.so"
                if not path.exists():
                    raise KernelError(f"{path} is not built")
                _libs[src.stem] = ctypes.CDLL(str(path))
        return dict(_libs)


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded lib<name>.so, building every kernel on the first call.
    `signatures` maps each C entry point to its argtypes (c_void_p for
    pointers and the stream, c_int for ints); every entry point returns
    the launch's cudaGetLastError() as an int."""
    lib = _libs.get(name)
    if lib is not None and name in _bound:
        return lib
    lib = load_all().get(name)
    if lib is None:
        raise KernelError(f"no kernel library {name!r} in {CSRC_DIR}")
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    _bound.add(name)
    return lib


def function(name: str, fn: str, signatures: Dict[str, Sequence]):
    """The ctypes function object `fn` of lib<name>.so (see `library`),
    held after the first call so a launch costs one dict lookup."""
    got = _fns.get((name, fn))
    if got is None:
        got = _fns[(name, fn)] = getattr(library(name, signatures), fn)
    return got


def check(err: int, what: str) -> None:
    """Raise KernelError when a C entry point reports a CUDA error."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.device(device).index or 0)
    return torch.cuda.current_stream(device).cuda_stream
