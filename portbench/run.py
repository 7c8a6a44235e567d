"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are in BENCHMARK.json; everything one of them needs is
found by name under portbench/. The last line of standard output is the
result, one JSON object; the numbers compared with the plain reference
are the last lines of standard error. With no card (or fewer than the
cell asks for), or with the port missing, it prints no result and exits
non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import deepflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port (deepflow_tpu_torch) is not importable "
              f"from {BENCH_DIR.parent}: {e}", file=sys.stderr)
        return 3
    from harness import run_cell
    try:
        result = run_cell.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    except run_cell.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if result is None:
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # daemon threads of the port (the supervisor's monitor) hold no work:
    # leave without waiting for them
    os._exit(code)
