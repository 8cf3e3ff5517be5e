"""lp_syncs_per_step: the host's waits on the card per PDHG step in the
profiled solve: its attempts' flag reads (the program's
`pdlp_step_sync` spans) and its majors' packed readbacks
(`pdlp_major_readback`), over the solve's own step count (raw
`iterations`). The build's and the answer's copies are not counted."""

from perfbench import program_spans


def read(ctx):
    syncs = sum(len(program_spans.inside(ctx, name))
                for name in ("pdlp_step_sync", "pdlp_major_readback"))
    steps = [s["raw"].get("iterations") for s in ctx.solves
             if s["profiled"]]
    if not syncs or not steps or not steps[-1]:
        return None
    return syncs / steps[-1]
