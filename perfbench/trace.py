"""A torch.profiler trace reduced to what the metric readers need.

A trace here is a dict of two lists, each of [start, duration, name]
with times in microseconds on the profiler's one clock:

  device  every kernel, copy and fill that ran on the card
  spans   every record_function span on the host (the program's
          `trace_scope` spans and the harness's own)

`from_profiler` builds it from a finished profiler through its Chrome
trace; the rest is interval arithmetic over it.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without "void ", its parameter list and anything
    past `width` characters: "row_pass_one_pass<true, 3>"."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width].strip()


def from_chrome(doc: dict) -> dict:
    """The trace of a Chrome-trace document as torch.profiler writes it."""
    device, spans = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        row = [float(e["ts"]), float(e["dur"]), str(e.get("name", ""))]
        if e.get("cat") in DEVICE_CATS:
            device.append(row)
        elif e.get("cat") == SPAN_CAT:
            spans.append(row)
    device.sort()
    spans.sort()
    return {"device": device, "spans": spans}


def from_profiler(prof) -> dict:
    """The trace of a stopped torch.profiler.profile. Its Chrome trace is
    written to a temporary file under TMPDIR, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return from_chrome(json.load(f))
    finally:
        os.unlink(path)


def span_window(trace: dict, name: str) -> tuple[float, float] | None:
    """(start, end) of the first host span called `name`, or None."""
    for ts, dur, n in trace["spans"]:
        if n == name:
            return ts, ts + dur
    return None


def union(trace: dict, lo: float, hi: float) -> list[list[float]]:
    """The device's busy intervals inside [lo, hi], merged."""
    out: list[list[float]] = []
    for ts, dur, _ in trace["device"]:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(trace: dict, lo: float, hi: float) -> float:
    """Microseconds inside [lo, hi] in which something ran on the card."""
    return sum(b - a for a, b in union(trace, lo, hi))


def idle_gaps(trace: dict, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals inside [lo, hi] in which nothing ran on the card."""
    gaps, t = [], lo
    for a, b in union(trace, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_span_at(trace: dict, t: float) -> str:
    """The innermost host span open at time t ("none" outside all)."""
    best, best_dur = "none", float("inf")
    for ts, dur, name in trace["spans"]:
        if ts > t:
            break
        if ts + dur >= t and dur < best_dur:
            best, best_dur = name, dur
    return best


def kernels(trace: dict, names, lo: float, hi: float) -> tuple[int, float]:
    """(launches, microseconds) of the device ops inside [lo, hi] whose
    name contains one of `names`."""
    n, us = 0, 0.0
    for ts, dur, name in trace["device"]:
        if ts >= lo and ts + dur <= hi and any(k in name for k in names):
            n += 1
            us += dur
    return n, us


def breakdown(trace: dict, lo: float, hi: float, top: int = 10) -> dict:
    """The device ops that took most time inside [lo, hi], summed by
    name, and the idle time inside it summed by the host span the host
    was in at each gap's middle, each as [[name, seconds], ...]."""
    ops: dict[str, float] = {}
    for ts, dur, name in trace["device"]:
        if ts >= lo and ts + dur <= hi:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + dur
    idle: dict[str, float] = {}
    for a, b in idle_gaps(trace, lo, hi):
        span = host_span_at(trace, (a + b) / 2)
        idle[span] = idle.get(span, 0.0) + (b - a)

    def ranked(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
