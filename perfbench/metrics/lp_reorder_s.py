"""lp_reorder_s: the bandwidth-reducing reorder in the profiled solve's
build (the program's `sparse_reorder` span: the permutation and the
permuted CSR). It runs only when the unpermuted band fails, so an LP in
banded order has nothing to read."""

from perfbench import program_spans


def read(ctx):
    return program_spans.total_s(ctx, "sparse_reorder")
