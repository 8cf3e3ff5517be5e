"""lp_first_major_s: the program's `compile_s` (device problem build,
reorder and scaling included, plus the first major), averaged over the
solves the profiler did not cover."""


def read(ctx):
    v = [s["raw"]["compile_s"] for s in ctx.solves
         if not s["profiled"] and "compile_s" in s["raw"]]
    return sum(v) / len(v) if v else None
