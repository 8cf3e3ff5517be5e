"""lp_steps_per_solve: the program's PDHG step count per solve, averaged
over the window's solves."""


def read(ctx):
    v = [s["raw"]["iterations"] for s in ctx.solves
         if "iterations" in s["raw"]]
    return sum(v) / len(v) if v else None
