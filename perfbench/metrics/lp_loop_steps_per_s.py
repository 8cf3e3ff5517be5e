"""lp_loop_steps_per_s: PDHG steps after the first major over the
seconds they took (the program's `loop_steps` and `solve_loop_s`),
summed over the solves the profiler did not cover."""


def read(ctx):
    v = [s["raw"] for s in ctx.solves if not s["profiled"]]
    steps = sum(r.get("loop_steps", 0) for r in v)
    secs = sum(r.get("solve_loop_s", 0.0) for r in v)
    return steps / secs if steps and secs > 0 else None
