"""The benchmark's own tests: CPU tests of its generator, reference,
arithmetic and files, and tests marked `card` that need the card (they
skip without one; on the card: `python3 -m pytest portbench/tests -m
card`)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def small_mix():
    """A mix file's parameters with a small bank, for CPU runs."""
    def make(name: str, records: int = 1 << 16) -> dict:
        from traffic.generator import load_mix
        mix = load_mix(name)
        mix["bank_records"] = records
        return mix
    return make
