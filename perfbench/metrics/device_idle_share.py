"""device_idle_share: the share of a solve's wall in which nothing ran
on the card, as the solve runs without the profiler.

The device time is the union of the card's kernel, copy and fill
intervals inside the profiled solve (the harness's span around the
call); the wall is that of the same request solved just before it
without the profiler. The profiler's own host cost lengthens the
profiled wall, by 9-79% on these cells, and would read as idle time."""

from perfbench import trace


def read(ctx):
    if ctx.trace is None or ctx.window is None or ctx.twin_wall is None:
        return None
    busy_s = trace.busy_us(ctx.trace, *ctx.window) / 1e6
    if busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / ctx.twin_wall)
