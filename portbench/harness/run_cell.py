"""One run of one cell: set-up, a warm window, the measured window, the
drain, the check against the plain reference, and the result line.

The producer thread stands in for the ingester's decoder threads: it
hands the bank's chunks to the port's `Exporters` registry (each
exporter behind its breaker, as the decoders call it) in a closed loop,
with at most `max_outstanding_chunks` chunks outstanding by
`Exporters.pending()`. The clock thread closes a window every
`window_seconds`, calling what the exporter's own window thread calls
(`flush_window()`); the exporter's thread is held off by a
`window_seconds` past the run's end.

Untraced (`--trace 0`) the whole measured window is timed. Traced
(`--trace 1`) the window starts with a profiled slice of `TRACE_SECONDS`
that ends in a drain and a close, so that the trace holds every kernel
the slice launched; the counters and the closes are read over the rest
of the window, which runs untraced.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from harness import host, kernels, spec
from harness.roofline import SUFFIX, Recorder
from traffic.generator import load_mix, make_bank

TRACE_SECONDS = 3.0
# how often the producer looks whether the worker has taken the queued
# chunks: short against the work that half the outstanding chunks hold
# (~22 ms of the RED cell, ~260 ms of the l4 cell), long enough that its
# wake-ups, each of which takes the interpreter lock, cost little
FULL_WAIT_S = 0.01
DRAIN_TIMEOUT_S = 120.0
FORBIDDEN = ("jax", "jaxlib", "flax", "deepflow_tpu")


class NoCard(RuntimeError):
    """The cell needs more cards than this machine shows."""


class Producer:
    """Closed-loop feed of the bank's chunks into the registry."""

    def __init__(self, bank, exporters, stream: str, max_out: int) -> None:
        self.bank = bank
        self.exporters = exporters
        self.stream = stream
        self.max_out = max_out
        self.next_chunk = 0
        self.rows = 0
        self.cpu_s = 0.0       # this thread's CPU time, over its loops

    def loop(self, stop: threading.Event) -> None:
        """Top the outstanding chunks up to `max_out`, then wait until
        half of them are done: the producer takes the interpreter lock
        in bursts, not once per chunk the worker finishes."""
        ex = self.exporters
        cpu0 = time.thread_time()
        while not stop.is_set():
            if ex.pending() >= self.max_out:
                while ex.pending() > self.max_out // 2 \
                        and not stop.is_set():
                    time.sleep(FULL_WAIT_S)
                continue
            cols = self.bank.chunk(self.next_chunk)
            ex.put(self.stream, 0, cols)
            self.next_chunk += 1
            self.rows += self.bank.chunk_rows
        self.cpu_s += time.thread_time() - cpu0


class Clock:
    """Closes a window every `period` seconds from `base`, while the
    tick is before `until`; each close timed from its tick."""

    def __init__(self, driver, period: float) -> None:
        self.driver = driver
        self.period = period
        self.closes_ms: List[float] = []
        self.cpu_s = 0.0

    def loop(self, base: float, until: float, stop: threading.Event) -> None:
        cpu0 = time.thread_time()
        k = 1
        while True:
            tick = base + k * self.period
            if tick >= until or stop.wait(
                    max(0.0, tick - time.perf_counter())):
                break
            self.driver.flush()
            self.closes_ms.append((time.perf_counter() - tick) * 1e3)
            k += 1
        self.cpu_s += time.thread_time() - cpu0


def _drain(exporter, exporters, timeout: float = DRAIN_TIMEOUT_S) -> bool:
    """Wait until the exporter's worker has processed every chunk the
    registry accepted. The worker counts a batch of up to 64 chunks when
    the whole batch is done, so a slow path shows no progress for
    seconds; a batch that raised is never counted, so once one has, the
    wait ends when the queue is empty and the worker has had time to
    finish the batch in hand. False: the drain did not complete."""
    deadline = time.perf_counter() + timeout
    errors = exporter.process_errors
    empty_since = None
    while time.perf_counter() < deadline:
        if exporter.processed >= exporters.put_count:
            return True
        if exporter.process_errors > errors and not len(exporter.queue):
            empty_since = empty_since or time.perf_counter()
            if time.perf_counter() - empty_since > 5.0:
                return False
        time.sleep(0.001)
    return False


def _segment(producer: Producer, clock: Clock, seconds: float) -> float:
    """Feed and close windows for `seconds`; returns the start."""
    stop = threading.Event()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer.loop, args=(stop,),
                                name="portbench-producer"),
               threading.Thread(target=clock.loop,
                                args=(t0, t0 + seconds, stop),
                                name="portbench-clock")]
    for t in threads:
        t.start()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join()
    return t0


def _load_reader(name: str):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class RunData:
    """What the per-layer metric readers read."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)

    def launches_per_batch(self):
        """Kernels the traced slice launched (window closes included)
        per batch the exporter staged or cut in it."""
        if self.trace is None:
            return None
        c0, c1 = self.slice_counters
        batches = c1["batches"] - c0["batches"]
        if batches <= 0:
            return None
        return len(self.trace.kernels()) / batches


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or the module `names` given) whose top-level name
    is JAX's or the JAX package's, compared whole: deepflow_tpu_torch is
    not deepflow_tpu."""
    tops = {m.split(".")[0] for m in list(sys.modules if names is None
                                          else names)}
    return sorted(tops.intersection(FORBIDDEN))


def within(value, limit) -> bool:
    """A limit is a number the value may reach, or {"below": x}, a number
    it must stay under; a number with no limit fails."""
    if isinstance(limit, dict):
        return value < limit["below"]
    return limit is not None and value <= limit


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        mix: Optional[dict] = None, log=sys.stderr) -> Optional[dict]:
    """Run the cell once; returns the result line's object, or None when
    the run may print no result (a forbidden module was loaded)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.find_cell(cell_name)
    config = cell.config
    mix = mix if mix is not None else load_mix(cell.traffic)
    if mix["kind"] != config["kind"]:
        raise ValueError(f"mix {cell.traffic} is {mix['kind']}, "
                         f"configuration {cell.config_name} {config['kind']}")
    import torch
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"cell {cell_name} needs {cell.chips} CUDA card(s); "
                     f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                     f"device_count()={torch.cuda.device_count()}")
    from deepflow_tpu_torch.runtime.breaker import BreakerConfig
    from deepflow_tpu_torch.runtime.exporters import Exporters

    phases: Dict[str, float] = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    bank = make_bank(cell.traffic, seed, mix)
    phases["bank_s"] = time.perf_counter() - t
    if cuda:
        t = time.perf_counter()
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        phases["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        kernels.cache_env()
        phases["kernels"] = kernels.load()
        phases["kernels_s"] = time.perf_counter() - t
    driver_mod = importlib.import_module(f"drivers.{config['driver']}")
    ref_mod = importlib.import_module(f"reference.{driver_mod.REFERENCE}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    recorder = None
    try:
        t = time.perf_counter()
        period = float(config["window_seconds"])
        driver = driver_mod.Driver(config, device, workdir,
                                   window_seconds=seconds + 3600.0)
        exporter = driver.exporter
        exporters = Exporters(breaker_cfg=BreakerConfig(**config["breaker"]))
        exporters.register(exporter)
        exporters.start()
        phases["exporter_s"] = time.perf_counter() - t
        roofs = [m["name"][:-len(SUFFIX)] for m in cell.per_layer
                 if m["name"].endswith(SUFFIX)]
        if trace and cuda and roofs:
            recorder = Recorder(roofs)
        producer = Producer(bank, exporters, driver_mod.STREAM,
                            int(config["max_outstanding_chunks"]))
        clock = Clock(driver, period)

        # warm-up: one window of the cell's own traffic, then its close
        t = time.perf_counter()
        _segment(producer, clock, period)
        _drain(exporter, exporters)
        driver.flush()
        if cuda:
            torch.cuda.synchronize()
        phases["warm_s"] = time.perf_counter() - t

        prof_trace = None
        slice_counters = None
        peak_before = 0
        window_start = time.perf_counter()
        rows_before = producer.rows
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            from harness.trace import MARK, Trace
            p_seconds = max(1.0, min(TRACE_SECONDS, seconds / 2))
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            if recorder is not None:
                # the reservation's own blocks are the harness's, not
                # the program's: the peak leaves them out
                peak_before = torch.cuda.max_memory_allocated()
                Recorder.reserve(driver.streams())
                torch.cuda.reset_peak_memory_stats()
            c_before = driver.counters()
            prof = profile(activities=acts)
            prof.start()
            if recorder is not None:
                recorder.active = True
            with record_function(MARK):
                _segment(producer, Clock(driver, period), p_seconds)
                _drain(exporter, exporters)
                driver.flush()
                if cuda:
                    torch.cuda.synchronize()
            prof.stop()
            if recorder is not None:
                # the held inputs go to the host, and the peak restarts:
                # the rest of the window reads the program's own peak
                recorder.active = False
                recorder.to_host()
                torch.cuda.reset_peak_memory_stats()
            slice_counters = (c_before, driver.counters())
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            prof_trace = Trace(path)
            os.remove(path)
            rest = max(1.0, seconds - p_seconds)
        else:
            rest = seconds
        c0 = driver.counters()
        h0 = host.thread_cpu_s()
        producer.cpu_s = clock.cpu_s = 0.0
        t0 = _segment(producer, clock, rest)
        drained = _drain(exporter, exporters)
        driver.flush()
        t_end = time.perf_counter()
        h1 = host.thread_cpu_s()
        c1 = driver.counters()
        timed_rows = producer.rows - rows_before
        memory_peak = max(peak_before, torch.cuda.max_memory_allocated()) \
            if cuda else 0
        exporters.close()
        if recorder is not None:
            recorder.close()
        # the producer and the clock have ended by now: they count
        # their own CPU time
        shares = host.cpu_shares(h0, h1, t_end - t0)
        shares["portbench-producer"] = producer.cpu_s / (t_end - t0)
        shares["portbench-clock"] = clock.cpu_s / (t_end - t0)
        host_seen = {"thread_cpu_share": shares,
                     "probe_ms": host.probe_ms()}
        bad = forbidden_modules()
        if bad:
            print(f"portbench: modules loaded that the port must not load: "
                  f"{', '.join(bad)}", file=log)
            return None

        # -- the check, after the window and the program's state --------
        t = time.perf_counter()
        attempted = producer.rows
        windows = driver.windows()
        counted = sum(w.hi - w.lo for w in windows)
        numbers = ref_mod.judge(config, windows, attempted,
                                driver.store_columns(), bank, seed)
        phases["check_s"] = time.perf_counter() - t
        limits = config["limits"]
        correct = drained
        checks = {}
        for name, value in numbers.items():
            limit = limits.get(name)
            checks[name] = {"value": value, "limit": limit}
            correct = correct and within(value, limit)

        name = torch.cuda.get_device_name(0) if cuda else "cpu"
        dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
               "count": cell.chips if cuda else 0,
               "memory_peak_bytes": int(memory_peak)}
        metrics = {}
        result = {"correct": bool(correct), "attempted": int(attempted),
                  "failed": int(max(0, attempted - counted))}
        units = {m["name"]: m["unit"] for m in
                 cell.end_to_end + cell.per_layer}
        if not trace:
            e2e = {
                "records_per_s": timed_rows / (t_end - t0),
                "window_close_ms": float(np.mean(clock.closes_ms))
                if clock.closes_ms else None,
                "setup_s": window_start - t_start,
            }
            for m in cell.end_to_end:
                v = e2e.get(m["name"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            data = RunData(
                trace=prof_trace, slice_counters=slice_counters,
                stretch_counters=(c0, c1), stretch_s=t_end - t0,
                stretch_closes_ms=list(clock.closes_ms),
                launches={} if recorder is None else recorder.records,
                config=config, device_name=name)
            for m in cell.per_layer:
                v = _load_reader(m["name"]).read(data)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": units[m["name"]]}
            if prof_trace is not None:
                dev["busy_s"] = prof_trace.busy_s()
                dev["window_s"] = prof_trace.window_s()
                result["breakdown"] = {
                    "device_ops": prof_trace.device_ops(),
                    "idle_gaps": prof_trace.idle_gaps()}
        result["metrics"] = metrics
        result["device"] = dev
        result["checks"] = checks
        counters = {k: v for k, v in c1.items()
                    if isinstance(v, (int, float))}
        print(json.dumps({"phases": phases, "windows": len(windows),
                          "window_rows": [w.hi - w.lo for w in windows],
                          "timed_rows": timed_rows,
                          "closes_ms": clock.closes_ms,
                          "counters": counters, "host": host_seen,
                          "breakers": exporters.breakers(),
                          "registry": exporters.counters()},
                         default=str), file=log)
        for cname, c in checks.items():
            lim = c["limit"]
            lim = f"< {lim['below']}" if isinstance(lim, dict) else lim
            print(f"check {cname}: {c['value']} (limit {lim})", file=log)
        return result
    finally:
        if recorder is not None:
            recorder.close()
        shutil.rmtree(workdir, ignore_errors=True)
