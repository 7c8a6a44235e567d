"""What the host did around the measured window, for standard error: the
CPU time of each thread of this process, and the speed of a fixed piece
of pure Python. The two tell whether the harness's threads or the host's
speed set a spread: a slow run whose threads took the same CPU shares
as a fast one got less done per CPU-second. It reads /proc/self only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

PROBE_ITERS = 2_000_000
PROBE_REPEATS = 5


def thread_cpu_s() -> Dict[str, float]:
    """CPU seconds of each live thread of this process, by thread name."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: Dict[str, float] = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                text = f.read()
        except OSError:
            continue
        comm, rest = text.split("(", 1)[1].rsplit(")", 1)
        fields = rest.split()
        name = names.get(int(tid), comm)
        out[name] = out.get(name, 0.0) + \
            (int(fields[11]) + int(fields[12])) / tick
    return out


def cpu_shares(before: Dict[str, float], after: Dict[str, float],
               wall_s: float) -> Dict[str, float]:
    """Each thread's CPU seconds between two readings over the wall time
    between them."""
    return {name: (after[name] - before.get(name, 0.0)) / wall_s
            for name in after if after[name] > before.get(name, 0.0)}


def probe_ms(repeats: int = PROBE_REPEATS) -> float:
    """Milliseconds this host takes for a fixed loop of pure Python: the
    median of `repeats` tries."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        s = 0
        for i in range(PROBE_ITERS):
            s += i & 7
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]
