"""One run of one cell: set-up, the measured window, the check, the line.

Everything particular to a configuration, a traffic mix or a metric is
found by name from BENCHMARK.json:

  configs/<config>.json     the configuration as it is run; its `driver`
                            names drivers/<driver>.py
  drivers/<driver>.py       the client: sets up and warms the program,
                            makes requests, calls the program, gives a
                            request's sizes, and judges the answers into
                            named checks, each beside its limit
  traffic/<traffic>.json    the mix's parameters, read by the driver
  metrics/<metric>.py       a reader: read(ctx) -> number or None

The window is a closed loop with one client: it makes a request, calls
the program, waits for the answer and makes the next, until `seconds`
have passed (the call in flight then ends). With `trace` one more
request runs after the window twice: unprofiled, then under
torch.profiler (a process that has profiled the card launches more
slowly afterwards, so nothing is profiled before the window's requests).
The per-layer readers take the trace from the profiled solve and the
program's counters from the unprofiled ones; the twin's wall beside the
profiled one states the profiler's own cost. A run is correct when every
check is within its limit.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "cuopt_tpu")
SOLVE_SPAN = "perfbench.solve_lp"
MAKE_SPAN = "perfbench.make_lp"


@dataclass
class Context:
    """What the metric readers read."""

    setup_s: float
    solves: list = field(default_factory=list)  # wall, raw, profiled
    trace: dict | None = None
    window: tuple | None = None  # the profiled solve's span, microseconds
    profiled_shape: tuple | None = None  # the driver's shape() of it
    twin_wall: float | None = None  # the same request, unprofiled


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    """The cell `workload` with its configuration, traffic and metrics."""
    w = {c["name"]: c for c in manifest["workloads"]}.get(workload)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return {
        "name": workload,
        "chips": w["chips"],
        "config": load_json(ROOT, conf["file"]),
        "traffic": load_json(BENCH, "traffic", f"{w['traffic']}.json"),
        "end_to_end": mine(manifest["end_to_end"]),
        "per_layer": mine(manifest["per_layer"]),
    }


def reader(name: str):
    return importlib.import_module(f"perfbench.metrics.{name}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _span(name):
    import torch

    return torch.profiler.record_function(name)


class Card:
    """The device a run measures: the first CUDA card. The harness has
    no other path; the CPU tests put a stand-in with the same methods in
    `CARD`."""

    platform = "gpu"
    device = "cuda"

    def sync(self):
        import torch

        torch.cuda.synchronize()

    def kind(self) -> str:
        import torch

        return torch.cuda.get_device_name(0)

    def peak_bytes(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated()

    def free(self):
        import torch

        torch.cuda.empty_cache()

    def activities(self) -> list:
        import torch

        return [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]


CARD = Card()


def driver(c: dict):
    """The cell's client of the program, from drivers/<driver>.py."""
    mod = importlib.import_module(
        f"perfbench.drivers.{c['config']['driver']}")
    return mod.Driver(c["config"], c["traffic"], CARD.device)


def _timed(drv, req):
    t = time.perf_counter()
    with _span(SOLVE_SPAN):
        answer = drv.call(req)
    return answer, time.perf_counter() - t


def measure(c: dict, seed: int, seconds: float, traced: bool,
            t_start: float):
    """Set up the cell's driver, warm it up and run the window; with
    `traced`, solve one more request after it twice, unprofiled and then
    under the profiler. Returns (driver, context, requests, answers, peak
    bytes, window seconds, profiler)."""
    import torch

    drv = driver(c)
    drv.setup(seed)
    CARD.sync()
    gc.collect()
    ctx = Context(setup_s=time.perf_counter() - t_start)

    requests, answers = [], []

    def record(req, answer, wall, profiled):
        requests.append(req)
        answers.append(answer)
        ctx.solves.append({"wall": wall, "raw": answer["raw"],
                           "profiled": profiled})

    t0 = time.perf_counter()
    end = t0 + seconds
    while not requests or time.perf_counter() < end:
        with _span(MAKE_SPAN):
            req = drv.make(seed, len(requests))
        record(req, *_timed(drv, req), False)
    window_s = time.perf_counter() - t0

    prof = None
    if traced:
        # the same LP unprofiled, then profiled: the profiler's own cost
        # on the solve the traced metrics are read from
        i = len(requests)
        req = drv.make(seed, i)
        answer, ctx.twin_wall = _timed(drv, req)
        record(req, answer, ctx.twin_wall, False)
        prof = torch.profiler.profile(activities=CARD.activities())
        prof.start()
        with _span(MAKE_SPAN):
            req = drv.make(seed, i)
        answer, wall = _timed(drv, req)
        CARD.sync()
        prof.stop()
        ctx.profiled_shape = drv.shape(req)
        record(req, answer, wall, True)
    return (drv, ctx, requests, answers, CARD.peak_bytes(), window_s,
            prof)


def is_correct(checks: dict) -> bool:
    """Every number compared is there and within its limit."""
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in checks.values())


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, out=None, err=None) -> int:
    """One run; prints the result line last on `out` and returns the exit
    code."""
    from perfbench.trace import (breakdown, busy_us, from_profiler,
                                 span_window)

    out = out or sys.stdout
    err = err or sys.stderr

    c = cell(load_json(ROOT, "BENCHMARK.json"), workload)
    drv, ctx, requests, answers, peak, window_s, prof = measure(
        c, seed, seconds, traced, t_start)
    # the window is closed: nothing below is timed
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=err)
        return 3

    walls = [s["wall"] for s in ctx.solves]
    print(f"solves: count {len(walls)} median {statistics.median(walls):.4f}"
          f" s max {max(walls):.4f} s over a {window_s:.3f} s window; "
          f"walls {[round(w, 4) for w in walls]}, {drv.summary(answers)}",
          file=out)
    dev_info = {"platform": CARD.platform, "kind": CARD.kind(),
                "count": c["chips"], "memory_peak_bytes": int(peak)}
    result = {}
    if prof is not None:
        ctx.trace = from_profiler(prof)
        prof = None
        ctx.window = span_window(ctx.trace, SOLVE_SPAN)
        make = span_window(ctx.trace, MAKE_SPAN)
        if ctx.window is not None:
            lo, hi = ctx.window
            dev_info["busy_s"] = busy_us(ctx.trace, lo, hi) / 1e6
            dev_info["window_s"] = (hi - lo) / 1e6
            result["breakdown"] = breakdown(
                ctx.trace, make[0] if make else lo, hi)
            print(f"profiler cost: the profiled solve {ctx.solves[-1]['wall']:.4f}"
                  f" s, the same request unprofiled {ctx.twin_wall:.4f} s; "
                  f"device busy {dev_info['busy_s']:.4f} s", file=out)

    names = c["per_layer"] if traced else c["end_to_end"]
    metrics = {}
    for m in names:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    ctx.trace = None
    gc.collect()
    CARD.free()
    failed, checks = drv.judge(requests, answers)
    for name, v in checks.items():
        print(f"check {name}: {v['value']} limit {v['limit']}", file=err)
    line = {"correct": is_correct(checks), "attempted": len(requests),
            "failed": failed, "metrics": metrics, "device": dev_info,
            **result, "checks": checks}
    print(json.dumps(line), file=out, flush=True)
    return 0
