"""The program's own spans inside the profiled solve.

`cuopt_torch` opens a `trace_scope` span at each layer boundary of the
LP path (its `utils/tracing.py` lists them); under the profiler each is
a host span in the trace. Every program span in the trace belongs to
the profiled solve, since the twin before it runs unprofiled; these
helpers still keep only those inside the solve's window, the harness's
span around the call. A program without a span gives nothing, so a
reader returns None there.
"""

from __future__ import annotations


def inside(ctx, name: str) -> list[tuple[float, float]]:
    """(start, duration) in microseconds of each span called `name`
    inside the profiled solve's window; [] without a trace."""
    if ctx.trace is None or ctx.window is None:
        return []
    lo, hi = ctx.window
    return [(ts, dur) for ts, dur, n in ctx.trace["spans"]
            if n == name and ts >= lo and ts + dur <= hi]


def total_s(ctx, name: str) -> float | None:
    """Seconds summed over the spans called `name` inside the profiled
    solve's window, or None when there is none."""
    found = inside(ctx, name)
    return sum(dur for _, dur in found) / 1e6 if found else None
