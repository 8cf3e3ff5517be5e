"""f64_pair_roofline: the least time the profiled solve's float64
product pairs could take at the card's HBM bandwidth, as a share of the
device time of the kernels that carry them in the trace.

The least time is the solve's raw `attempts` (one pair an attempt) times
the bytes one float64 pair needs at the least
(`yardstick_f64.pair_bytes`), over `yardstick.HBM_BYTES_PER_S`; it has
no term for the slabs, their padding or their windows.

The kernels are named below: the one the unfused pair launches on the
card in float64 for its two `torch.bmm` over the slabs (cuBLAS's
`gemv2T_kernel_val<int, int, double, ...>` on a strided batch, two an
attempt and two for the initial state: 17,160 launches in a 50k solve of
8,579 attempts on an H100, and none for other work), and the row-pass
bodies of cuopt_torch/csrc/row_pass.cu, so that a float64 fused pass
reads the same work under this metric. Left out, because their names are
shared with work outside the pair in the same solve (their launches in
that solve, against the pair's 17,160): the window gathers
(`index_elementwise_kernel`, 25,813), the pad of x and y
(`CatArrayBatchedCopy`, 17,204), the zeros and the spill sums
(`FillFunctor<double>` 68,932, the spill's product 102,549,
`indexFuncLargeIndex` 8,581, the add 191,933). The pair of the initial
state is counted in the kernels' time but not in the least time.

Nothing to read (no trace, no attempts, no such kernel) gives None."""

from perfbench import trace, yardstick, yardstick_f64

# cuBLAS's double batched product (torch.bmm of (T, 128, W) slabs by
# (T, W, 1) windows), and the row-pass bodies
KERNEL_NAMES = ("gemv2T_kernel_val<int, int, double",
                "row_pass_one_pass", "row_pass_column_split",
                "row_pass_two_read")


def read(ctx):
    if ctx.trace is None or ctx.window is None or ctx.profiled_shape is None:
        return None
    attempts = [s["raw"].get("attempts") for s in ctx.solves if s["profiled"]]
    if not attempts or not attempts[-1]:
        return None
    launches, us = trace.kernels(ctx.trace, KERNEL_NAMES, *ctx.window)
    if launches == 0 or us <= 0:
        return None
    least_s = attempts[-1] * yardstick_f64.pair_bytes(
        *ctx.profiled_shape) / yardstick.HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
