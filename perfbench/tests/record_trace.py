#!/usr/bin/env python3
"""Record the trace that tests/test_perfbench_readers.py reads.

    python3 perfbench/tests/record_trace.py OUT.json.gz

Runs stair50k.ordered once with --trace 1 on the card (a short window),
keeps the profiled request's trace with shortened kernel names, and
writes it gzipped beside the profiled request's sizes, its unprofiled
twin's wall, and the per-layer values and the device line that the run
printed, so that the test can hold the readers to them.
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
    rc = harness.run("stair50k.ordered", 20261017, 4, True, T_START,
                     out=buf)
    print(buf.getvalue(), end="")
    if rc != 0:
        return rc
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    tr = kept["trace"]
    doc = {
        "workload": "stair50k.ordered",
        "profiled_shape": list(kept["ctx"].profiled_shape),
        "twin_wall": kept["ctx"].twin_wall,
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "device": line["device"],
        "trace": {"device": [[ts, dur, T.short_name(n)]
                             for ts, dur, n in tr["device"]],
                  "spans": tr["spans"]},
    }
    with gzip.open(out_path, "wt") as f:
        json.dump(doc, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
