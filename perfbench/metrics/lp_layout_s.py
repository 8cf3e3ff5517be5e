"""lp_layout_s: the host's slab layout in the profiled solve's build,
summed over its band tries (the program's `sparse_band_layout` spans:
both slab sets and the transpose, without their uploads). A shuffled LP
makes two tries: the failed unpermuted one and the permuted one."""

from perfbench import program_spans


def read(ctx):
    return program_spans.total_s(ctx, "sparse_band_layout")
