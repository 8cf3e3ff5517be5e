"""lp_upload_s: the host-to-device copies of the profiled solve's build,
summed (the program's `device_upload` spans: the slabs and spills, the
permutations, the vectors and the objective offset)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.total_s(ctx, "device_upload")
