"""Minimum end-to-end slice on the PyTorch/CUDA port: wire bytes -> top-K
report.

Replays a synthetic agent firehose through the full stack (framing
decode, columnar decode, static-shape batching, sharded sketch updates
on the card) and prints the window's top-K heavy hitters scored against
an exact numpy GROUP BY.

Run:  python examples/torch/e2e_l4_topk.py [--records N] [--devices N]
          [--device cuda|cpu]

`--devices` is the number of shards of the mesh (default: one per
visible card); shards beyond the visible cards share them. The drive
runs on the card unless `--device cpu` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from deepflow_tpu_torch.batch import Batcher, SKETCH_L4_SCHEMA  # noqa: E402
from deepflow_tpu_torch.decode import decode_l4_records  # noqa: E402
from deepflow_tpu_torch.models import (FlowSuiteConfig,  # noqa: E402
                                       FlowWindowOutput, flow_suite)
from deepflow_tpu_torch.parallel import (ShardedFlowSuite,  # noqa: E402
                                         make_mesh)
from deepflow_tpu_torch.replay import SyntheticAgent  # noqa: E402
from deepflow_tpu_torch.wire import (FrameReader, MessageType,  # noqa: E402
                                     iter_pb_records)

FEATURES = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
            "packet_tx", "packet_rx")


@functools.lru_cache(maxsize=1)
def encode(records: int):
    """The synthetic agent side: (the records' columns, a wire-exact
    TAGGEDFLOW byte stream of them). The generator is seeded, so a
    second call at the same size returns the first call's stream."""
    agent = SyntheticAgent()
    cols_true = agent.l4_columns_pooled(records)
    recs = [agent.l4_record(cols_true, i) for i in range(records)]
    return cols_true, b"".join(agent.frames(recs, MessageType.TAGGEDFLOW))


def exact_counts(cols_true) -> dict:
    """{flow key: records} of an exact GROUP BY of the 5-tuples."""
    keys = flow_suite.flow_key({
        k: torch.from_numpy(cols_true[k].astype(np.int64))
        for k in FEATURES}).numpy().astype(np.uint32)
    uniq, counts = np.unique(keys, return_counts=True)
    return dict(zip(uniq.tolist(), counts.tolist()))


def run(records: int = 50_000, devices=None, batch: int = 8192,
        top_k: int = 20, device="cuda"):
    """The drive: (window output as host arrays of the device's dtypes,
    exact counts {flow key: records}, report)."""
    mesh = make_mesh(devices, device=device)
    n_dev = mesh.shape["data"]
    cfg = FlowSuiteConfig(top_k=top_k)
    suite = ShardedFlowSuite(cfg, mesh)
    state = suite.init()
    cols_true, wire_stream = encode(records)

    # -- ingester side: frames -> records -> columns -> batches ----------
    t0 = time.perf_counter()
    reader = FrameReader()
    batcher = Batcher(SKETCH_L4_SCHEMA, capacity=batch)
    n_batches = 0

    def run_batch(tb, state):
        cd, md = suite.put_batch({k: tb.columns[k] for k in FEATURES},
                                 tb.mask())
        return suite.update(state, cd, md)

    for frame in reader.feed(wire_stream):
        assert frame.msg_type == MessageType.TAGGEDFLOW
        cols = decode_l4_records(iter_pb_records(frame.payload))
        for tb in batcher.put(cols):
            state = run_batch(tb, state)
            n_batches += 1
    for tb in batcher.flush():
        state = run_batch(tb, state)
        n_batches += 1
    state, out = suite.flush(state)
    if any(d.type == "cuda" for d in suite.devices):
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = FlowWindowOutput(*(t.cpu().numpy() for t in out))

    # -- score against exact GROUP BY -------------------------------------
    truth = exact_counts(cols_true)
    uniq = np.fromiter(truth, np.int64, len(truth))
    counts = np.fromiter(truth.values(), np.int64, len(truth))
    order = np.argsort(counts)[::-1]
    exact_top = set(uniq[order[:top_k]].tolist())
    got_keys = out.topk_keys.view(np.uint32)
    card = out.service_cardinality
    report = {
        "records": records, "devices": n_dev, "batches": n_batches,
        "batch": batch, "wire_bytes": len(wire_stream), "seconds": dt,
        "records_per_s": records / dt, "rows": int(out.rows),
        "entropies": out.entropies.tolist(),
        "service_observations": float(card[card > 0].sum()),
        "service_groups": int((card > 0).sum()),
        "top": [(k, c, truth.get(k, 0)) for k, c in
                zip(got_keys.tolist(), out.topk_counts.tolist())],
        "recall": len(set(got_keys.tolist()) & exact_top) / top_k,
    }
    return out, truth, report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=50_000)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    out, truth, r = run(args.records, args.devices, args.batch, args.top_k,
                        args.device)
    print(f"torch {torch.__version__} on {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device == "cuda" else ""))
    print(f"encoded {r['records']} TaggedFlow records -> "
          f"{r['wire_bytes']/1e6:.1f} MB wire stream")
    print(f"pipeline: {r['batches']} batches x {r['batch']} on "
          f"{r['devices']} shard(s) in {r['seconds']:.2f}s "
          f"({r['records_per_s']/1e3:.0f}k rec/s end-to-end)")
    print(f"rows counted on device: {r['rows']}")
    print(f"entropies (src_ip dst_ip src_port dst_port): "
          f"{np.round(np.asarray(r['entropies']), 3)}")
    print(f"service cardinality: {r['service_observations']:.0f} total "
          f"distinct client-ip observations across {r['service_groups']} "
          f"service groups")
    print(f"\ntop-{args.top_k} heavy hitters (CMS estimate vs exact):")
    for kk, cc, ex in r["top"][:10]:
        print(f"  key={kk:>10}  est={cc:>7}  exact={ex:>7}")
    print(f"\nrecall vs exact GROUP BY: {r['recall']:.3f}  "
          f"(target: >= 0.99 per BASELINE.md)")


if __name__ == "__main__":
    main()
