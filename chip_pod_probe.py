#!/usr/bin/env python3
"""Dispatch probe of the pod on one CUDA card: who launches the shards'
work, and how fast.

    python3 chip_pod_probe.py [--seed S] [--window-records N] [--rounds R]

One window of `chip_smoke.py` phase 11a's data (Zipf(1.1) records over
2^17 5-tuples, packed into 2^15-row lane planes, FlowSuiteConfig()) goes
through each design in turn, R rounds in that order:

- `pod4`: `PodFlowSuite(n_shards=4)`, a worker thread and a stream per
  shard (the pod as the exporter runs it);
- `pod4_switch`: the same at a 0.2 ms thread switch interval (the
  interpreter's default is 5 ms);
- `pod1`: `PodFlowSuite(n_shards=1)` fed the same 2^13-row shard slices,
  one worker thread launching every shard batch (ingest still only
  enqueues);
- `sharded`: `ShardedFlowSuite` on 4 shards, its lanes form on the
  calling thread (the update the pod's shards share).

Each design's time runs from its first put to its drained queue and a
synchronized card. Every pod run must deliver every row (ledger closed,
nothing lost). Prints one line per run, then one JSON object with
records/s of every run and the card's name and power limit. Needs a
card; exits non-zero without one.
"""

import argparse
import json
import sys
import time

import numpy as np

from chip_smoke import (POD_BATCH, POD_SHARDS, card_line, conserve,
                        lane_planes, log, make_windows)

SWITCH_S = 2e-4


def run_pod(torch, dev, cfg, planes, n_shards, records, switch_s=None):
    """Seconds to put every plane through a PodFlowSuite of `n_shards`
    (one shard: the 4-shard pod's slices, one by one) and drain it."""
    from deepflow_tpu_torch.parallel import PodFlowSuite
    b = POD_BATCH // POD_SHARDS
    pod = PodFlowSuite(cfg, n_shards=n_shards, merge_deadline_s=60.0,
                       queue_batches=POD_SHARDS * len(planes), device=dev)
    switch = sys.getswitchinterval()
    try:
        torch.cuda.synchronize()
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        t0 = time.perf_counter()
        for plane, n in planes:
            if n_shards == POD_SHARDS:
                pod.put_lanes(plane, n)
                continue
            for off in range(0, POD_BATCH, b):
                pod.put_lanes(plane[:, off:off + b].copy(),
                              max(0, min(b, n - off)))
        if not pod.drain(300):
            raise AssertionError(f"pod of {n_shards}: did not drain")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pod.close_epoch()
    finally:
        sys.setswitchinterval(switch)
        pod.close()
    c = conserve(pod.counters(), f"pod of {n_shards}")
    if c["pod_rows_delivered"] != records:
        raise AssertionError(f"pod of {n_shards}: delivered "
                             f"{c['pod_rows_delivered']} of {records}")
    return dt


def run_sharded(torch, dev, cfg, planes):
    """Seconds for the sharded suite's lanes form over the same planes."""
    from deepflow_tpu_torch.parallel import ShardedFlowSuite, make_mesh
    suite = ShardedFlowSuite(cfg, make_mesh(POD_SHARDS, device=dev))
    st = suite.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for plane, n in planes:
        st = suite.update_lanes(st, suite.put_lanes(plane), n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    suite.flush(st)
    return dt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-records", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_pod_probe: no CUDA card", file=sys.stderr)
        return 1
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}")
    cfg = FlowSuiteConfig()
    window = make_windows(np.random.default_rng(args.seed), 1,
                          args.window_records)[0]
    planes = list(lane_planes(window, POD_BATCH))
    records = sum(n for _, n in planes)
    designs = {
        "pod4": lambda: run_pod(torch, dev, cfg, planes, POD_SHARDS,
                                records),
        "pod4_switch": lambda: run_pod(torch, dev, cfg, planes, POD_SHARDS,
                                       records, switch_s=SWITCH_S),
        "pod1": lambda: run_pod(torch, dev, cfg, planes, 1, records),
        "sharded": lambda: run_sharded(torch, dev, cfg, planes),
    }
    run_sharded(torch, dev, cfg, planes[:2])      # builds and warms hist
    rates = {name: [] for name in designs}
    for r in range(args.rounds):
        for name, fn in designs.items():
            rate = records / fn()
            rates[name].append(rate)
            log(f"  round {r} {name}: {rate:.0f} records/s")
    print(card)
    print(json.dumps({"records": records, "records_per_s": rates,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
