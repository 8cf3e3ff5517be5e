"""batch_build_s: the program's raw `batch_build_s` (the members' device
problems, their initial states and the stack), averaged over the
requests the profiler did not cover. A program without the counter
gives None."""


def read(ctx):
    v = [s["raw"]["batch_build_s"] for s in ctx.solves
         if not s["profiled"] and "batch_build_s" in s["raw"]]
    return sum(v) / len(v) if v else None
