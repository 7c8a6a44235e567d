"""The control of a cell's comparison: the plain reference put in the
program's place, with its readouts computed one precision below what
the configuration states (bfloat16 for the float32 entropies,
cardinalities and quantiles). The same comparison that decides a run's
`correct` must find it wrong.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        --window-records <records a window holds at the cell's load> \
        --windows <closes a run makes>

It needs no card: the program does not run. Each seed's numbers are
printed beside the configuration's limits, one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import spec  # noqa: E402
from harness.run_cell import within  # noqa: E402
from reference import app_red, l4_sketch  # noqa: E402
from traffic.generator import load_mix, make_bank  # noqa: E402


def bfloat16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), held
    as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def l4_windows(bank, config, bounds):
    sz = l4_sketch.Sizes(config["flow_suite"])
    windows, wrows, live = [], [], []
    for lo, hi in bounds:
        ref = l4_sketch.window_state(bank.records(lo, hi), sz)
        keys = np.unique(ref["keys"])
        est = l4_sketch.cms_estimate(ref["cms"], keys, sz)
        ring = l4_sketch.stable_top(est, sz.ring)
        rk, rc = keys[ring], est[ring]
        top = l4_sketch.stable_top(rc, sz.top_k)
        out = {"topk_keys": rk[top], "topk_counts": rc[top],
               "entropies": bfloat16(l4_sketch.entropies(ref["ent"])),
               "service_cardinality": bfloat16(
                   l4_sketch.hll_estimates(ref["hll"], sz.p)),
               "rows": np.int64(hi - lo)}
        state = {"cms": ref["cms"], "hll": ref["hll"], "ent": ref["ent"],
                 "ring_keys": rk, "ring_counts": rc,
                 "rows_seen": np.int64(hi - lo)}
        windows.append(l4_sketch.Window(lo, hi, out, state))
        wrows.append(hi - lo)
        live.append(int((rc[top] > 0).sum()))
    store = {"window_signals": {"rows": np.array(wrows)},
             "topk_flows": {"count": np.ones(sum(live))}}
    return windows, store


def red_windows(bank, config, bounds):
    sz = app_red.Sizes(config["app_suite"])
    derived = app_red.Derived(bank, sz)
    g = (1.0 + sz.alpha) / (1.0 - sz.alpha)
    mids = sz.min_value * 2.0 * g ** np.arange(sz.buckets) / (g + 1.0)
    windows, reqs = [], []
    for lo, hi in bounds:
        ref = app_red.window_counts(derived.take(lo, hi), sz)
        total = ref["zeros"] + ref["hist"].sum(axis=1)
        cdf = ref["zeros"][:, None] + np.cumsum(ref["hist"], axis=1)
        qs = []
        for q in sz.quantiles:
            idx = np.minimum((cdf < q * total[:, None]).sum(axis=1),
                             sz.buckets - 1)
            qs.append(np.where(total > 0, mids[idx], 0.0))
        out = {"requests": ref["requests"].astype(np.float32),
               "errors": ref["errors"].astype(np.float32),
               "rrt_quantiles": bfloat16(np.stack(qs)),
               "rrt_hist": ref["hist"].astype(np.float32),
               "rrt_zeros": ref["zeros"].astype(np.float32)}
        windows.append(app_red.Window(lo, hi, out))
        reqs.append(ref["requests"][ref["requests"] > 0])
    store = {"app_red": {"requests": np.concatenate(reqs)}}
    return windows, store


def control(cell_name: str, seed: int, window_records: int, n_windows: int,
            mix=None) -> dict:
    cell = spec.find_cell(cell_name)
    config = cell.config
    bank = make_bank(cell.traffic, seed,
                     mix if mix is not None else load_mix(cell.traffic))
    bounds = [(i * window_records, (i + 1) * window_records)
              for i in range(n_windows)]
    make = l4_windows if config["kind"] == "l4" else red_windows
    windows, store = make(bank, config, bounds)
    ref_mod = l4_sketch if config["kind"] == "l4" else app_red
    numbers = ref_mod.judge(config, windows, bounds[-1][1], store, bank, seed)
    limits = config["limits"]
    return {"workload": cell_name, "seed": seed,
            "correct": all(within(v, limits.get(k))
                           for k, v in numbers.items()),
            "checks": {k: {"value": v, "limit": limits.get(k)}
                       for k, v in numbers.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window-records", type=int, required=True)
    ap.add_argument("--windows", type=int, required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.window_records,
                                 args.windows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
