"""The native decoder's ThreadSanitizer harness (decode/tsan.py,
decode/native_src/tsan_harness.cc) on the CPU: g++ builds it with
-fsanitize=thread from the port's own decoder.cc, and it decodes a
port-generated payload of 8,192 TaggedFlow records, corrupted as the
JAX package's CI corrupts its own (every 97th record garbage, every
193rd from the 31st a record with no Flow field), at 1 to 8 threads: no
race, every thread count identical. A compile failure raises."""

import shutil

import pytest

from deepflow_tpu.replay.generator import SyntheticAgent as JAgent
from deepflow_tpu.wire.codec import pack_pb_records as jpack
from deepflow_tpu_torch.decode import tsan
from deepflow_tpu_torch.ops._build import BUILD_DIR

N = 8192


def test_payload_is_the_reference_recipe():
    """The port's corrupted payload equals the JAX package's generator
    and codec run through the same corruption."""
    _, records = JAgent().l4_batch(N)
    records = list(records)
    for i in range(0, len(records), 97):
        records[i] = b"\xff" * len(records[i])
    for i in range(31, len(records), 193):
        records[i] = b"\x08\x01"
    assert tsan.make_payload(N) == jpack(records)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not found")
def test_harness_builds_and_finds_no_race():
    binary = tsan.build_harness()
    assert binary.parent == BUILD_DIR and binary.is_file()
    bad = len(range(0, N, 97)) + len(range(31, N, 193))
    proc = tsan.run_harness(tsan.make_payload(N), min_bad=bad // 2,
                            binary=binary)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ThreadSanitizer" not in proc.stderr
    assert "TSAN harness OK" in proc.stdout
    for threads in range(1, 9):
        assert f"{threads} threads: identical" in proc.stdout
    # a payload with too few bad records is refused, not passed
    proc = tsan.run_harness(tsan.make_payload(N), min_bad=N, binary=binary)
    assert proc.returncode == 1 and "would go untested" in proc.stderr


def test_compile_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tsan, "BUILD_DIR", tmp_path)
    with pytest.raises(tsan.HarnessBuildError):
        tsan.build_harness(gxx="false")
    with pytest.raises(tsan.HarnessBuildError, match="not found"):
        tsan.build_harness(gxx="no-such-compiler-here")
