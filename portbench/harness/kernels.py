"""Build the port's kernels once per checkout.

`deepflow_tpu_torch.ops._build` compiles every `csrc/*.cu` with nvcc in
each process that calls `load_all()`. The benchmark keeps a record of
the sources' hashes and the compiler flags under `build/portbench/` in
the checkout (a fixed path, which `.gitignore` lists): when the record
matches and every library is there, a run loads the libraries an
earlier run built (`load_built()`), and builds them otherwise.
"""

from __future__ import annotations

import hashlib
import json
import os

from harness.spec import ROOT

CACHE_DIR = ROOT / "build" / "portbench"
RECORD = CACHE_DIR / "kernels.json"


def _fingerprint(build) -> dict:
    srcs = {}
    for src in build.sources():
        srcs[src.name] = hashlib.sha256(src.read_bytes()).hexdigest()
    return {"sources": srcs, "flags": list(build.NVCC_FLAGS)}


def cache_env() -> None:
    """Kernel caches of the libraries the port may use, at fixed paths
    inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))


def load() -> str:
    """Load the kernels, building them when the record does not match;
    returns 'reused' or 'built'."""
    from deepflow_tpu_torch.ops import _build
    want = _fingerprint(_build)
    have = None
    if RECORD.exists():
        try:
            have = json.loads(RECORD.read_text())
        except ValueError:
            have = None
    libs = [_build.BUILD_DIR / f"lib{s.stem}.so" for s in _build.sources()]
    if have == want and all(p.exists() for p in libs):
        _build.load_built()
        return "reused"
    _build.load_all()
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = RECORD.with_name(RECORD.name + ".tmp")
    tmp.write_text(json.dumps(want, indent=1))
    os.replace(tmp, RECORD)
    return "built"
