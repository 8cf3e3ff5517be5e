#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card.

    python3 perfbench/run.py --workload stair50k.ordered --seed 7 \
        --seconds 30 --trace 0

Prints the result as one JSON line, last on standard output, and the
numbers the correctness check compared, each beside its limit, last on
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 2. See perfbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    chips = harness.cell(harness.load_json(ROOT, "BENCHMARK.json"),
                         a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {a.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                       T_START)


if __name__ == "__main__":
    sys.exit(main())
