"""f64_tail_s: the eager tail of all the profiled solve's majors: the
program's `pdlp_termination` and `pdlp_restart` spans (lp/pdlp.py
`major_tail`, once a major each), summed inside the solve's window. The
host's time in them, launches and Python, whatever the card does
meanwhile."""

from perfbench import program_spans


def read(ctx):
    parts = [program_spans.total_s(ctx, name)
             for name in ("pdlp_termination", "pdlp_restart")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
