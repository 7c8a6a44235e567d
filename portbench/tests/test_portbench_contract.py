"""BENCHMARK.json against the benchmark contract, and every name in it
resolving to the file that serves it."""

import importlib
import json
import re

import pytest

from harness import spec
from traffic.generator import load_mix

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = spec.NAME_RE
UNIT = spec.UNIT_RE
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expansion|per_tok")


def _line(text, cap=200):
    return isinstance(text, str) and 1 <= len(text) <= cap \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells at this length fits the driver's budget
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 <= 43200
    assert cells <= 24


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    metrics = [n for m, n in names if m]
    assert len(metrics) == len(set(metrics))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        cell = spec.find_cell(w["name"], BENCH)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_configs_resolve():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_driver_reference_and_mix_by_name(cell):
    c = spec.find_cell(cell, BENCH)
    drv = importlib.import_module(f"drivers.{c.config['driver']}")
    assert hasattr(drv, "Driver") and drv.STREAM and drv.REFERENCE
    ref = importlib.import_module(f"reference.{drv.REFERENCE}")
    assert callable(ref.judge)
    assert load_mix(c.traffic)["kind"] == c.config["kind"]
    # a limit for every number the comparison gives
    assert set(c.config["limits"]) >= {"rows_lost", "unwritten"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    path = spec.BENCH_DIR / "metrics" / f"{metric}.py"
    assert path.exists()
    if metric.endswith("_roofline"):
        mod = importlib.import_module(
            "rooflines." + metric[:-len("_roofline")])
        assert mod.TARGET and mod.KERNEL and callable(mod.cost)


def test_file_names_under_paths():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./\-]+", rel), rel
