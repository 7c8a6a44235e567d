"""Build and run the native decoder's ThreadSanitizer harness.

`native_src/tsan_harness.cc` `#include`s this package's `decoder.cc`, so
`-fsanitize=thread` instruments the real decoder, and decodes one payload
single-threaded and at every thread count from 1 to 8: any data race
aborts with TSAN's report, any difference in rows, bad-record counts or
columns exits 1. `build_harness()` compiles it with
`g++ -O1 -g -fsanitize=thread -std=c++17 ... -lpthread` into
`build/deepflow_tpu_torch/` under a name keyed by both sources and the
flags; a failed compile raises (`HarnessBuildError`), never skips.

The multi-threaded decoder compacts rows past bad records with a memmove,
which only runs when worker regions are sparse: `make_payload` corrupts
every 97th record into garbage wire bytes and every 193rd from the 31st
into a well-formed record with no Flow field, and `run_harness`'s
`min_bad` makes the harness refuse a payload with fewer bad records.

    python -m deepflow_tpu_torch.decode.tsan [--records N] [--min-bad M]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

from deepflow_tpu_torch.ops._build import BUILD_DIR

__all__ = ["HARNESS", "TSAN_FLAGS", "HarnessBuildError", "build_harness",
           "corrupt_records", "make_payload", "run_harness"]

_SRC_DIR = Path(__file__).resolve().parent / "native_src"
HARNESS = _SRC_DIR / "tsan_harness.cc"
TSAN_FLAGS = ("-O1", "-g", "-fsanitize=thread", "-std=c++17")


class HarnessBuildError(RuntimeError):
    """g++ is missing or refused to compile or link the harness."""


def build_harness(gxx: str = "g++") -> Path:
    """The harness binary, compiled unless this source and flag set is
    built already."""
    if shutil.which(gxx) is None:
        raise HarnessBuildError(f"{gxx} not found")
    h = hashlib.sha256(HARNESS.read_bytes())
    h.update((_SRC_DIR / "decoder.cc").read_bytes())
    h.update(" ".join(TSAN_FLAGS).encode())
    out = BUILD_DIR / f"tsan_decoder-{h.hexdigest()[:16]}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *TSAN_FLAGS, str(HARNESS), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise HarnessBuildError(
            proc.stderr[-2000:] or f"{gxx} exit {proc.returncode}")
    os.replace(tmp, out)
    return out


def corrupt_records(records: Sequence[bytes]) -> List[bytes]:
    """Every 97th record garbage of its own length, every 193rd from the
    31st a record with no Flow field."""
    out = list(records)
    for i in range(0, len(out), 97):
        out[i] = b"\xff" * len(out[i])
    for i in range(31, len(out), 193):
        out[i] = b"\x08\x01"
    return out


def make_payload(n: int, seed: int = 0xA9E27) -> bytes:
    """`n` TaggedFlow records of a `SyntheticAgent(seed)`, corrupted as
    above, packed as one frame payload."""
    from deepflow_tpu_torch.replay.generator import SyntheticAgent
    from deepflow_tpu_torch.wire.codec import pack_pb_records
    _, records = SyntheticAgent(seed=seed).l4_batch(n)
    return pack_pb_records(corrupt_records(records))


def run_harness(payload: bytes, min_bad: int = 0, *,
                binary: Path | None = None,
                timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Run the harness on `payload`; the caller reads `returncode` (0:
    no race, every thread count identical) and `stdout`/`stderr`."""
    binary = binary or build_harness()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"tsan_payload.{os.getpid()}.bin"
    path.write_bytes(payload)
    try:
        return subprocess.run([str(binary), str(path), str(int(min_bad))],
                              capture_output=True, text=True,
                              timeout=timeout)
    finally:
        path.unlink(missing_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=50_000)
    ap.add_argument("--min-bad", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0xA9E27)
    args = ap.parse_args(argv)
    proc = run_harness(make_payload(args.records, args.seed), args.min_bad)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
