#!/usr/bin/env python3
"""Drive the deepflow_tpu_torch l4 sketch step on one CUDA card.

    python3 chip_smoke.py [--seed S] [--window-records N]

Phases (any failure raises: the exit code is non-zero and no result line
is printed):

1. the card's name and power limit (nvidia-smi), then every kernel of
   deepflow_tpu_torch/csrc built with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, bit-exact, with padded batches and saturating
   weights, on uniform and on Zipf(1.1) inputs: hist_add at the
   Count-Min (mask only) and entropy (weights and mask) shapes and on
   one row of 2^19 bins (the wide path), the lane kernel at C=32768,
   the news kernel at C=8192; kernel, plain and library times per call
   from CUDA events after a warm-up (median of 5 runs of 20 calls),
   device times from torch.profiler; then, checked but not timed, hist on
   its widest block-private row (2^15 bins) and the lane kernel with
   entropy rows of 2^13 bins (its widest shared copy) and 2^16 bins (too
   wide for one, added straight into the state);
3. the slice at the exporter defaults (FlowSuiteConfig(), batch_rows
   32768): two windows of 2^20 records each, drawn by Zipf(1.1) from a
   pool of 2^17 distinct 5-tuples, through full-row `update`, the lean
   exporter on the lanes wire (coalesced K=4) and on the dict wire. The
   three paths must agree on CMS, HLL, entropy and rows before each
   flush, each path must launch its kernels (counts set to 0 just before
   the path runs), and top-K recall against an exact GROUP BY must be at
   least 0.99; the window outputs must be finite and of their shapes;
4. the same small input through both exporters on the card and on the
   CPU (plain versions), state and outputs compared;
5. one window of each path under torch.profiler: device time, its share
   of the wall time, and the largest device ops (reported, not checked);
   then one full-row batch's device kernels, which must hold exactly two
   hist launches and no float conversion.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# the kernels do 32-bit integer ALU work; the H100 table's nearest rate
# is fp32 outside the tensor cores
ALU_OPS_PER_S = 67e12
# per record of the fused kernels: 5 fold steps x ~11 ops, 8 bucket
# hashes x ~9 ops, unpack, weight and address arithmetic ~20
FUSED_OPS_PER_RECORD = 150
# per (row, lane) item of hist: clamp, weight, address, add
HIST_OPS_PER_ITEM = 4
WARMUP, ITERS, REPEATS = 3, 20, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Time per call of fn on the current stream, from CUDA events: the
    median over REPEATS runs of the mean of ITERS back-to-back calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(REPEATS):
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / ITERS)
    return float(np.median(means))


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit operations over ALU_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_events(torch, prof):
    """(name, self device microseconds) of the kernels and copies that
    ran on the card, from a profiler's key averages."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != cuda:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            out.append((evt.key, float(us)))
    return out


def _torch_ops(torch, prof):
    """[name, self device ms, calls] of the torch ops that launched the
    device work, largest first."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == cuda:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append([evt.key, float(us) / 1e3, int(evt.count)])
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, names):
    """Mean device time per call of fn, summed over the kernels whose
    names contain one of `names` (torch.profiler); None if the profiler
    saw none of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us = sum(t for k, t in _device_events(torch, prof)
             if any(n in k for n in names))
    return us / ITERS / 1e3 if us > 0 else None


# -- phase 2: kernels against their plain versions ---------------------------

C_LANE, C_NEWS = 1 << 15, 1 << 13      # the lane and news kernels' batches
HIST_C = 1 << 15                       # lanes per hist call (batch_rows)
# (label, log2 width, rows, weight planes or None for mask-only lanes)
HIST_SHAPES = (("cms", 17, 4, None), ("entropy", 12, 4, 2),
               ("wide", 19, 1, 2))


def zipf_ranks(rng, size, pool):
    """Zipf(1.1) ranks in [0, pool), as `make_windows` draws records."""
    return (rng.zipf(1.1, size) - 1).clip(max=pool - 1)


def hist_inputs(torch, rng, dev, lw, d, planes, skew, C=HIST_C, pad=777):
    """idx [d, C] (uniform, or Zipf(1.1) over a permuted bin order with
    out-of-range indices on both sides), a mask of the first C - pad lanes
    and, with `planes`, weights that saturate at 256**planes - 1."""
    width = 1 << lw
    if skew:
        idx = np.stack([rng.permutation(width)[zipf_ranks(rng, C, width)]
                        for _ in range(d)]).astype(np.int32)
    else:
        idx = rng.integers(-3, width + 3, (d, C)).astype(np.int32)
    mask = torch.arange(C, device=dev) < C - pad
    w = None if planes is None else torch.from_numpy(
        rng.integers(0, 1 << 24, C).astype(np.int32)).to(dev)
    return torch.from_numpy(idx).to(dev), w, mask


def check_hist(torch, rng, cuda_hist, idx, width, w, mask, planes, label):
    """hist_add_cuda against hist_add_plain on the same non-zero state;
    returns a fresh copy of that state for timing."""
    d = idx.shape[0]
    base = torch.from_numpy(rng.integers(0, 100, (d, width)).astype(
        np.int32)).to(idx.device)
    got, ref = base.clone(), base.clone()
    cuda_hist.hist_add_cuda(got, idx, width, w, mask, planes or 2)
    cuda_hist.hist_add_plain(ref, idx, width, w, mask, planes or 2)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"hist_add[{label}] differs from its plain "
                             "version")
    return base.clone()


def lane_plane(torch, rng, dev, C, skew):
    """(4, C) lane plane: uniform words, or the Zipf(1.1) records of
    `make_windows` packed as the lanes wire packs them."""
    from deepflow_tpu_torch.models import flow_suite
    if skew:
        cols = make_windows(rng, 1, C)[0]
        lanes = flow_suite.pack_lanes(cols)
        plane = np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])
    else:
        plane = rng.integers(0, 1 << 32, (4, C), dtype=np.uint64).astype(
            np.uint32)
        plane[3] = (rng.integers(0, 256, C).astype(np.uint32) << 24) \
            | rng.integers(0, 1 << 24, C).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(plane).view(np.int32)).to(dev)


def news_plane(torch, rng, dev, C, skew):
    """(6, C) dict-wire news plane, uniform or from Zipf(1.1) records."""
    plane = rng.integers(0, 1 << 32, (6, C), dtype=np.uint64).astype(np.uint32)
    plane[0] = np.arange(C)
    if skew:
        cols = make_windows(rng, 1, C)[0]
        plane[1], plane[2] = cols["ip_src"], cols["ip_dst"]
        plane[3] = (cols["port_src"] << 16) | cols["port_dst"]
        plane[4] = cols["proto"]
        plane[5] = np.minimum(cols["packet_tx"] + cols["packet_rx"], 0xFFFF)
    else:
        plane[4] = rng.integers(0, 256, C)
        plane[5] = rng.integers(0, 0x10000, C)
    return torch.from_numpy(plane.view(np.int32)).to(dev)


def sketch_state(torch, rng, dev, ent_lw=12):
    """Non-zero CMS [4, 2^17] and entropy [4, 2^ent_lw] (the exporter
    defaults unless ent_lw is given)."""
    return (torch.from_numpy(rng.integers(0, 100, (4, 1 << 17)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 100, (4, 1 << ent_lw)).astype(
                np.int32)).to(dev))


def check_fused(torch, rng, cuda_sketch, label, plane, n_d, seeds,
                ent_lw=12):
    """One fused kernel against its plain version on the same non-zero
    state; returns fresh copies of that state for timing."""
    n = int(n_d)
    base_c, base_e = sketch_state(torch, rng, plane.device, ent_lw)
    kc, ke, pc, pe = (base_c.clone(), base_e.clone(), base_c.clone(),
                      base_e.clone())
    getattr(cuda_sketch, label + "_cuda")(plane, n_d, kc, ke, *seeds)
    getattr(cuda_sketch, label + "_plain")(plane, n_d, pc, pe, *seeds)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(ke, pe)):
        raise AssertionError(f"{label} differs from its plain version")
    if int((kc - base_c).sum()) != 4 * n:
        raise AssertionError(f"{label}: CMS rows do not count n records")
    return base_c.clone(), base_e.clone()


def check_kernels(torch, rng, dev):
    from deepflow_tpu_torch.ops import cuda_hist, cuda_sketch, hashing

    results, extra = [], []

    def record(name, source, replaces, err, k_ms, p_ms, b, lib_ms, d_ms):
        b_ms, b_by = b
        log(f"  {name}: kernel {k_ms * 1e3:.2f} us per call ("
            + ("device time not measured" if d_ms is None
               else f"{d_ms * 1e3:.2f} us on the device")
            + f"), plain {p_ms * 1e3:.2f} us,"
            f" bound {b_ms * 1e3:.3f} us ({b_by})"
            + ("" if lib_ms is None else f", library {lib_ms * 1e3:.2f} us")
            + f", max_abs_err {err}")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "device_ms": d_ms})

    hist_names = ("hist_smem_kernel", "hist_global_kernel")
    for label, lw, d, planes in HIST_SHAPES:
        width = 1 << lw
        for skew in (False, True):
            idx, w, mask = hist_inputs(torch, rng, dev, lw, d, planes, skew)
            acc = check_hist(torch, rng, cuda_hist, idx, width, w, mask,
                             planes, label + ("/zipf" if skew else ""))
            args = (idx, width, w, mask, planes or 2)
            k_ms = time_ms(torch, lambda: cuda_hist.hist_add_cuda(acc, *args))
            d_ms = device_ms(torch, lambda: cuda_hist.hist_add_cuda(acc, *args),
                             hist_names)
            # the library call on the same in-place contract: index_add_
            # of the clamped, saturated and masked weights into the state
            flat = (idx.to(torch.int64).clamp(0, width - 1)
                    + torch.arange(d, device=dev)[:, None] * width).reshape(-1)
            wl = torch.ones_like(idx[0]) if w is None else \
                torch.clamp(w, max=256 ** planes - 1) & (256 ** planes - 1)
            wl = (wl * mask.to(torch.int32)).expand(d, -1).reshape(-1)
            lib = acc.view(-1)
            lib_ms = time_ms(torch, lambda: lib.index_add_(0, flat, wl))
            nbytes = (idx.numel() * 4 + mask.numel()
                      + (0 if w is None else w.numel() * 4) + 2 * d * width * 4)
            b = bound(nbytes, HIST_OPS_PER_ITEM * idx.numel())
            if label != "wide" and not skew:
                p_acc = acc.clone()
                record(f"hist[{label}]", "deepflow_tpu_torch/csrc/hist.cu",
                       "deepflow_tpu/ops/pallas_hist.py:90", 0.0, k_ms,
                       time_ms(torch, lambda: cuda_hist.hist_add_plain(
                           p_acc, *args)), b, lib_ms, d_ms)
            else:
                log(f"  hist_add[{label}{'/zipf' if skew else ''}]: kernel "
                    f"{k_ms * 1e3:.2f} us per call, "
                    + ("device not measured" if d_ms is None
                       else f"{d_ms * 1e3:.2f} us on the device")
                    + f", bound {b[0] * 1e3:.3f} us, library "
                    f"{lib_ms * 1e3:.2f} us, bit-equal")
                extra.append({"name": f"hist[{label}]", "zipf": skew,
                              "ms": k_ms, "device_ms": d_ms,
                              "bound_ms": b[0], "library_ms": lib_ms})

    seeds = (hashing.make_seeds(4, 0xDEC0DE, device=dev),
             hashing.make_seeds(4, 0xDEC0DE ^ 0xE27, device=dev))
    for label, make, C, n, line in (
            ("fused_lane_hists", lane_plane, C_LANE, C_LANE - 777, "253"),
            ("fused_news_hists", news_plane, C_NEWS, C_NEWS - 100, "277")):
        cuda_fn = getattr(cuda_sketch, label + "_cuda")
        plain_fn = getattr(cuda_sketch, label + "_plain")
        n_d = torch.tensor([n], dtype=torch.int32, device=dev)
        for skew in (False, True):
            plane = make(torch, rng, dev, C, skew)
            kc, ke = check_fused(torch, rng, cuda_sketch, label, plane, n_d,
                                 seeds)
            k_ms = time_ms(torch, lambda: cuda_fn(plane, n_d, kc, ke, *seeds))
            d_ms = device_ms(torch, lambda: cuda_fn(plane, n_d, kc, ke,
                                                    *seeds),
                             ("fused_hists_kernel",))
            state_bytes = (4 << 17) * 4 + (4 << 12) * 4
            b = bound(plane.numel() * 4 + 4 + 2 * state_bytes,
                      n * FUSED_OPS_PER_RECORD)
            if not skew:
                pc, pe = kc.clone(), ke.clone()
                record(label, "deepflow_tpu_torch/csrc/fused_sketch.cu",
                       "deepflow_tpu/ops/pallas_sketch.py:" + line, 0.0, k_ms,
                       time_ms(torch, lambda: plain_fn(plane, n_d, pc, pe,
                                                       *seeds)),
                       b, None, d_ms)
            else:
                log(f"  {label}/zipf: kernel {k_ms * 1e3:.2f} us per call, "
                    + ("device not measured" if d_ms is None
                       else f"{d_ms * 1e3:.2f} us on the device")
                    + ", bit-equal")
                extra.append({"name": label, "zipf": True, "ms": k_ms,
                              "device_ms": d_ms, "bound_ms": b[0],
                              "library_ms": None})

    # launch shapes the main path does not take, checked but not timed:
    # hist's widest block-private row, and the lane kernel's widest shared
    # copy of the entropy rows and rows too wide for one
    idx, w, mask = hist_inputs(torch, rng, dev, 15, 4, 2, True)
    check_hist(torch, rng, cuda_hist, idx, 1 << 15, w, mask, 2, "2^15")
    log("  hist_add[4 x 2^15/zipf]: bit-equal")
    n_d = torch.tensor([C_LANE - 777], dtype=torch.int32, device=dev)
    for ent_lw in (13, 16):
        for skew in (False, True):
            plane = lane_plane(torch, rng, dev, C_LANE, skew)
            check_fused(torch, rng, cuda_sketch, "fused_lane_hists", plane,
                        n_d, seeds, ent_lw)
        log(f"  fused_lane_hists, entropy rows of 2^{ent_lw} bins: "
            "bit-equal (uniform and Zipf)")
    return results, extra


# -- phase 3: the slice ------------------------------------------------------

def make_windows(rng, windows: int, records: int, pool: int = 1 << 17):
    """Column dicts of l4 records drawn by Zipf(1.1) from `pool` distinct
    in-range 5-tuples (rank past the pool clips to its last tuple)."""
    base = {
        "ip_src": (0x0A000000 + rng.permutation(pool)).astype(np.uint32),
        "ip_dst": (0xAC100000 + rng.integers(0, 1 << 16, pool)).astype(
            np.uint32),
        "port_src": rng.integers(1024, 1 << 16, pool).astype(np.uint32),
        "port_dst": rng.choice(np.array([80, 443, 3306, 6379, 8080, 9092,
                                         5432, 53], np.uint32), pool),
        "proto": np.where(rng.random(pool) < 0.9, 6, 17).astype(np.uint32),
    }
    out = []
    for _ in range(windows):
        pick = (rng.zipf(1.1, records) - 1).clip(max=pool - 1)
        cols = {k: v[pick] for k, v in base.items()}
        cols["packet_tx"] = rng.integers(1, 64, records).astype(np.uint32)
        cols["packet_rx"] = rng.integers(1, 64, records).astype(np.uint32)
        out.append(cols)
    return out


def exact_topk(cols, k: int) -> set:
    from deepflow_tpu_torch.utils.u32 import fold_columns_np
    keys = fold_columns_np([cols["ip_src"], cols["ip_dst"], cols["port_src"],
                            cols["port_dst"], cols["proto"]])
    uniq, counts = np.unique(keys, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return set(uniq[order[:k]].tolist())


def snapshot(state):
    return {"cms": state.sketch.counts.clone(),
            "hll": state.services.registers.clone(),
            "entropy": state.ent.hist.clone(),
            "rows": state.rows_seen.clone()}


def check_output(torch, out, cfg):
    shapes = {"topk_keys": (cfg.top_k,), "topk_counts": (cfg.top_k,),
              "service_cardinality": (cfg.hll_groups,), "entropies": (4,),
              "rows": ()}
    for name, shape in shapes.items():
        t = getattr(out, name)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name} has shape {tuple(t.shape)}")
    for name in ("service_cardinality", "entropies"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"{name} is not finite")
    e = out.entropies
    if not bool(((e >= 0) & (e <= 1)).all()):
        raise AssertionError("entropies outside [0, 1]")


def path_runners(torch, dev, cfg, batch_rows, chunk):
    """name -> (run(windows, snaps, outs), kernels the path must launch)."""
    from deepflow_tpu_torch.models import flow_suite
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    def full_row(windows, snaps, outs):
        state = flow_suite.init(cfg, dev)
        mask = torch.ones(batch_rows, dtype=torch.bool, device=dev)
        names = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
                 "packet_tx", "packet_rx")
        for cols in windows:
            total = len(cols["ip_src"])
            for s in range(0, total, batch_rows):
                e = min(total, s + batch_rows)
                m = mask if e - s == batch_rows else \
                    torch.arange(batch_rows, device=dev) < (e - s)
                part = {}
                for k in names:
                    buf = np.zeros(batch_rows, np.uint32)
                    buf[:e - s] = cols[k][s:e]
                    part[k] = torch.from_numpy(buf.view(np.int32)).to(dev)
                state = flow_suite.update(state, part, m, cfg)
            snaps.append(snapshot(state))
            state, out = flow_suite.flush(state, cfg)
            outs.append(out)

    def exporter(wire, coalesce):
        def run(windows, snaps, outs):
            exp = TpuSketchExporter(cfg=cfg, batch_rows=batch_rows,
                                    wire=wire, coalesce_batches=coalesce,
                                    device=dev)
            for cols in windows:
                total = len(cols["ip_src"])
                for s in range(0, total, chunk):
                    exp.process({k: v[s:s + chunk] for k, v in cols.items()})
                exp.drain()
                snaps.append(snapshot(exp.state))
                outs.append(exp.flush_window())
            records = sum(len(w["ip_src"]) for w in windows)
            if exp.rows_in != records:
                raise AssertionError(f"{wire}: rows_in {exp.rows_in}")
        return run

    return {"full_row_update": (full_row, ("hist",)),
            "lanes_exporter_k4": (exporter("lanes", 4), ("fused_lane_hists",)),
            "dict_exporter": (exporter("dict", 1),
                              ("fused_news_hists", "fused_lane_hists"))}


def run_paths(torch, runners, windows):
    """Each path over every window, its launch counts set to 0 just
    before and read just after; returns per path its snapshots, outputs,
    records/s and launches."""
    from deepflow_tpu_torch.ops import cuda_hist, cuda_sketch

    counters = {"hist": cuda_hist.hist_add_cuda,
                "fused_lane_hists": cuda_sketch.fused_lane_hists_cuda,
                "fused_news_hists": cuda_sketch.fused_news_hists_cuda}
    records = sum(len(w["ip_src"]) for w in windows)
    paths = {}
    for name, (fn, wants) in runners.items():
        snaps, outs = [], []
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        fn(windows, snaps, outs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        for k in wants:
            if launches[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        paths[name] = {"snaps": snaps, "outs": outs, "seconds": dt,
                       "records_per_s": records / dt, "launches": launches}
    return paths


def check_slice(torch, dev, rng, args, card):
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig

    cfg = FlowSuiteConfig()
    batch_rows = 1 << 15
    windows = make_windows(rng, 2, args.window_records)
    runners = path_runners(torch, dev, cfg, batch_rows, chunk=1 << 16)
    paths = run_paths(torch, runners, windows)
    # full-row update: one hist launch per histogram, Count-Min and entropy
    batches = sum(-(-len(w["ip_src"]) // batch_rows) for w in windows)
    hist_launches = paths["full_row_update"]["launches"]["hist"]
    if hist_launches != 2 * batches:
        raise AssertionError(f"full_row_update: {hist_launches} hist launches "
                             f"for {batches} batches, not 2 per batch")
    names = list(paths)
    ref = paths[names[0]]
    for name in names[1:]:
        for w, (a, b) in enumerate(zip(ref["snaps"], paths[name]["snaps"])):
            for leaf in a:
                if not torch.equal(a[leaf], b[leaf]):
                    raise AssertionError(
                        f"window {w}: {leaf} differs between {names[0]} "
                        f"and {name}")
    for name, p in paths.items():
        recalls = []
        for w, out in enumerate(p["outs"]):
            check_output(torch, out, cfg)
            if int(out.rows) != len(windows[w]["ip_src"]):
                raise AssertionError(f"{name}: window {w} rows {int(out.rows)}")
            got = set(out.topk_keys.cpu().numpy().view(np.uint32).tolist())
            truth = exact_topk(windows[w], cfg.top_k)
            recalls.append(len(got & truth) / cfg.top_k)
        if min(recalls) < 0.99:
            raise AssertionError(f"{name}: top-K recall {recalls} < 0.99")
        p["recall"] = recalls
        log(f"  {name}: {p['records_per_s']:.0f} records/s "
            f"({p['seconds']:.3f} s for {2 * args.window_records} records) "
            f"on {card}; recall {recalls}; launches {p['launches']}")
    return paths, runners, windows


def profile_paths(torch, runners, windows):
    """One window of each path under torch.profiler: wall time, the
    device time of every kernel and copy, its share of the wall time
    (the profiler's own overhead included), and the largest device ops."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (fn, _) in runners.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(windows, [], [])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = sorted(_device_events(torch, prof), key=lambda e: -e[1])
        dev_s = sum(t for _, t in events) / 1e6
        out[name] = {
            "wall_s": wall, "device_s": dev_s if events else None,
            "device_busy_share": dev_s / wall if events else None,
            "top_device_ops": [[k[:120], t / 1e3] for k, t in events[:6]],
            "top_torch_ops": _torch_ops(torch, prof)[:8]}
        log(f"  {name}: wall {wall:.3f} s, device "
            + ("not measured" if not events else
               f"{dev_s:.4f} s ({100 * dev_s / wall:.1f}% busy)"))
        for k, t in events[:6]:
            log(f"    {t / 1e3:9.3f} ms  {k[:120]}")
        for k, t, calls in out[name]["top_torch_ops"]:
            log(f"    {t:9.3f} ms device, {calls:6d} calls  {k}")
    return out


def profile_full_row_update(torch, dev, rng):
    """The device kernels of one full-row `update` batch at the exporter
    defaults (torch.profiler), by name and call count: the Count-Min and
    entropy histograms must be one hist launch each, with no float
    conversion and no fill of a d x width buffer."""
    from torch.profiler import ProfilerActivity, profile
    from deepflow_tpu_torch.models import flow_suite

    cfg = flow_suite.FlowSuiteConfig()
    C = 1 << 15
    state = flow_suite.init(cfg, dev)
    cols = make_windows(rng, 1, C)[0]
    part = {k: torch.from_numpy(v.view(np.int32)).to(dev)
            for k, v in cols.items()}
    mask = torch.arange(C, device=dev) < C - 777
    state = flow_suite.update(state, part, mask, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flow_suite.update(state, part, mask, cfg)
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            counts[evt.key[:100]] = counts.get(evt.key[:100], 0) + evt.count
    hist = sum(c for k, c in counts.items() if "hist_" in k)
    bad = [k for k in counts if "to_float" in k]
    fills = [f"{k} x{c}" for k, c in counts.items() if "fill" in k.lower()]
    log(f"  full-row update, one batch: {sum(counts.values())} device "
        f"kernels, {hist} hist launches; fills: {', '.join(fills) or 'none'}")
    if hist != 2 or bad:
        raise AssertionError(f"full-row update kernels: {counts}")
    return sorted(counts.items(), key=lambda kv: -kv[1])


def check_small_against_cpu(torch, dev, rng):
    """The dict exporter on the card and on the CPU (plain versions) over
    the same small stream: identical state, matching window outputs."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    cfg = FlowSuiteConfig(cms_log2_width=12, ring_size=256, hll_groups=64,
                          hll_precision=8, entropy_log2_buckets=10)
    windows = make_windows(rng, 2, 10000, pool=3000)
    exps = [TpuSketchExporter(cfg=cfg, batch_rows=4096, wire=wire,
                              device=d)
            for wire in ("dict", "lanes") for d in (dev, "cpu")]
    for cols in windows:
        for exp in exps:
            exp.process(cols)
            exp.drain()
        for gpu, cpu in (exps[0:2], exps[2:4]):
            for a, b in zip(convert.state_to_numpy(gpu.state),
                            convert.state_to_numpy(cpu.state)):
                np.testing.assert_array_equal(a, b)
            og, oc = gpu.flush_window(), cpu.flush_window()
            for name in ("topk_keys", "topk_counts", "rows"):
                np.testing.assert_array_equal(getattr(og, name).cpu().numpy(),
                                              getattr(oc, name).numpy())
            for name in ("service_cardinality", "entropies"):
                # float32 log/sqrt and sum order: CUDA vs CPU last-ulp
                np.testing.assert_allclose(getattr(og, name).cpu().numpy(),
                                           getattr(oc, name).numpy(),
                                           rtol=1e-5, atol=1e-6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-records", type=int, default=1 << 20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from deepflow_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_all(verbose=True)
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if "registers" in line or line.endswith(".cu:") \
                    or "spill" in line:
                log("  " + line.strip())

    rng = np.random.default_rng(args.seed)
    log("phase 2: kernels against their plain versions (bit-exact)")
    kernels, extra = check_kernels(torch, rng, dev)

    log("phase 3: the slice at the exporter defaults")
    paths, runners, windows = check_slice(torch, dev, rng, args, card)
    totals = {}
    for p in paths.values():
        for k, v in p["launches"].items():
            totals[k] = totals.get(k, 0) + v
    for entry in kernels:
        entry["launches"] = totals[entry["name"].split("[")[0]]

    log("phase 4: small stream on the card against the CPU")
    check_small_against_cpu(torch, dev, rng)
    log("phase 4: ok")

    log("phase 5: one window of each path under torch.profiler")
    profiles = profile_paths(torch, runners, windows[:1])
    update_kernels = profile_full_row_update(torch, dev, rng)

    log(json.dumps({"paths": {
        name: {"records_per_s": p["records_per_s"], "recall": p["recall"],
               "launches": p["launches"], "profile": profiles[name]}
        for name, p in paths.items()}, "kernel_inputs": extra,
        "full_row_update_kernels": update_kernels, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
