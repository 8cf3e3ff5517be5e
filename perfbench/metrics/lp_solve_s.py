"""lp_solve_s: the window's solves' walls summed, over their count."""


def read(ctx):
    walls = [s["wall"] for s in ctx.solves]
    return sum(walls) / len(walls) if walls else None
