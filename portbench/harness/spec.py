"""BENCHMARK.json: the cell a run asks for, its configuration and mix,
and the metrics it reports. Everything a cell needs is found by name."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent       # portbench/
ROOT = BENCH_DIR.parent                                  # the checkout
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict            # the configuration file
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]), config=config,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
