"""batch_syncs_per_step: the host's waits on the card per step of the
batch's stacked loop: raw `batch_syncs` (a read each attempt pass, a
packed read each major) over raw `batch_steps`, summed over the
requests the profiler did not cover. The builds' and the answers'
copies are not counted. A program without the counters gives None."""


def read(ctx):
    v = [s["raw"] for s in ctx.solves
         if not s["profiled"] and s["raw"].get("batch_steps")]
    syncs = sum(r.get("batch_syncs", 0) for r in v)
    steps = sum(r["batch_steps"] for r in v)
    return syncs / steps if syncs and steps else None
