"""batch_member_steps_per_s: the members' PDHG steps over the seconds of
the batch's major loop (the program's raw `iterations` of each member,
summed, over raw `batch_loop_s`), summed over the requests the profiler
did not cover. The builds are not in the loop's wall: `batch_build_s`
reads them. A program without the counter gives None."""


def read(ctx):
    v = [s["raw"] for s in ctx.solves
         if not s["profiled"] and s["raw"].get("batch_loop_s")]
    steps = sum(sum(r.get("iterations") or []) for r in v)
    secs = sum(r["batch_loop_s"] for r in v)
    return steps / secs if steps and secs > 0 else None
