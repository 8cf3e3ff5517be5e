"""row_pass_roofline: the least time the profiled solve's row passes
could take at the card's HBM bandwidth, as a share of the device time
the row-pass kernels took in the trace.

The least time counts the bytes that the LP's rows, columns and
nonzeros need per pass (`yardstick.row_pass_bytes`), times the passes
launched; it has no term for the layout's slabs, tiles or padding.
Nothing to read (no trace, or no row-pass launch) gives None."""

from perfbench import trace, yardstick

# the kernel bodies of cuopt_torch/csrc/row_pass.cu, in either mode
KERNEL_NAMES = ("row_pass_one_pass", "row_pass_column_split",
                "row_pass_two_read")


def read(ctx):
    if ctx.trace is None or ctx.window is None:
        return None
    launches, us = trace.kernels(ctx.trace, KERNEL_NAMES, *ctx.window)
    if launches == 0 or us <= 0:
        return None
    least_s = launches * yardstick.row_pass_bytes(
        *ctx.profiled_shape) / yardstick.HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
