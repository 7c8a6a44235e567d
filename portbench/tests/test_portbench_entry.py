"""The command the driver runs: no result without a card or without the
port, and (marked `card`) a correct run on the card."""

import json
import shutil
import subprocess
import sys

import pytest

from harness import spec

CMD = [sys.executable, "portbench/run.py", "--workload", "l4_zipf_steady",
       "--seed", "2147483711", "--seconds", "5", "--trace", "0"]


def _run(cwd, timeout=600):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_result_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_result_without_the_port(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "deepflow_tpu_torch" in out.stderr


@pytest.mark.card
def test_a_run_on_the_card_is_correct(card):
    out = _run(spec.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["kind"] == card and res["device"]["count"] == 1
