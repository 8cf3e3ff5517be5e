"""lp_build_s: the profiled solve's device problem build, from the host
CSR to the scaled problem on the card (the program's `pdlp_build` span:
the band layout, the reorder where it runs, the uploads and the
scaling). The first major, which `lp_first_major_s` adds to it, is not
in it."""

from perfbench import program_spans


def read(ctx):
    return program_spans.total_s(ctx, "pdlp_build")
