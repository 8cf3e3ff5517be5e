#!/usr/bin/env python3
"""Record the batch cell's trace that tests/test_perfbench_batch.py reads.

    python3 perfbench/tests/record_batch_trace.py OUT.json.gz

Runs stair50k.batch8 once with --trace 1 on the card (a short window)
and writes, gzipped: the profiled request's sizes, every request's wall
and raw counters, the unprofiled twin's wall, the per-layer values and
the device line that the run printed, the profiled request's host
spans, the device ops whose names `batch_pair_roofline` counts (a batch
launches some hundred thousand others), and every device op's launches
and microseconds summed by shortened name, so that the test can hold the
readers to what the run printed.
"""

import gzip
import io
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKLOAD = "stair50k.batch8"


def main(out_path: str) -> int:
    sys.path.insert(0, ROOT)
    from perfbench import harness
    from perfbench import trace as T

    kept = {}
    from_profiler = T.from_profiler

    def keep(prof):
        kept["trace"] = from_profiler(prof)
        return kept["trace"]

    measure = harness.measure

    def keep_measure(*args):
        got = measure(*args)
        kept["ctx"] = got[1]
        return got

    T.from_profiler = keep
    harness.measure = keep_measure
    buf = io.StringIO()
    rc = harness.run(WORKLOAD, 20261019, 4, True, T_START, out=buf)
    print(buf.getvalue(), end="")
    if rc != 0:
        return rc
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    tr, ctx = kept["trace"], kept["ctx"]
    names = harness.reader("batch_pair_roofline").KERNEL_NAMES
    lo, hi = T.span_window(tr, harness.SOLVE_SPAN)
    ops = {}
    for ts, dur, n in tr["device"]:
        if lo <= ts and ts + dur <= hi:
            k = T.short_name(n)
            a = ops.setdefault(k, [0, 0.0])
            a[0] += 1
            a[1] += dur
    doc = {
        "workload": WORKLOAD,
        "profiled_shape": list(ctx.profiled_shape),
        "twin_wall": ctx.twin_wall,
        "solves": ctx.solves,
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "device": line["device"],
        "device_ops": ops,
        "trace": {"device": [[ts, dur, T.short_name(n)]
                             for ts, dur, n in tr["device"]
                             if any(k in n for k in names)],
                  "spans": tr["spans"]},
    }
    with gzip.open(out_path, "wt") as f:
        json.dump(doc, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
