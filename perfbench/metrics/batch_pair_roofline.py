"""batch_pair_roofline: the least time the profiled request's batched
float64 product pairs could take at the card's HBM bandwidth, as a
share of the device time of the kernels that carry them in the trace.

The least time is `yardstick_batch.batch_pair_bytes` of the request's
sizes and each member's raw `attempts`, over
`yardstick.HBM_BYTES_PER_S`: the shared matrix once a pass, each
member's vectors once an attempt; no term for the stacked slabs (each
member's copy of the matrix), their padding or their windows.

The kernels are those of `f64_pair_roofline` and one more. On an H100
the vmapped `torch.bmm` over the stacked (8, 391, 128, 384) float64
slabs launches cuBLAS's tensor-core double GEMM
(`sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_tilesize32x64x32_...`), two a
pass and nothing else under that name: 1,328 launches for the 664
passes of a 50k x 8 request; each member's initial state, solved alone
before the stack, launches the gemv of `f64_pair_roofline` (two a
member). The row-pass bodies stay in the list, so that a fused batched
pass would read the same work here. Left out, as there, because their
names are shared with work outside the pair in the same request (their
launches in it): the window gathers (`index_elementwise_kernel`,
2,600), the pads of x and y (`CatArrayBatchedCopy`, 2,411), the
fills and the spill sums (`FillFunctor<double>` 6,062,
`indexFuncLargeIndex` 5,328). The initial states' pairs are counted in
the kernels' time but not in the least time.

Nothing to read (no trace, no attempts, no such kernel) gives None."""

from perfbench import trace, yardstick, yardstick_batch
from perfbench.metrics import f64_pair_roofline

# the float64 pair's kernels and the GEMM the vmapped bmm launches
KERNEL_NAMES = f64_pair_roofline.KERNEL_NAMES + ("xmma_gemm_f64f64",)


def read(ctx):
    if ctx.trace is None or ctx.window is None or ctx.profiled_shape is None:
        return None
    attempts = [s["raw"].get("attempts") for s in ctx.solves if s["profiled"]]
    if not attempts or not attempts[-1] or not all(attempts[-1]):
        return None
    launches, us = trace.kernels(ctx.trace, KERNEL_NAMES, *ctx.window)
    if launches == 0 or us <= 0:
        return None
    rows, cols, nnz = ctx.profiled_shape[:3]
    least_s = yardstick_batch.batch_pair_bytes(
        rows, cols, nnz, attempts[-1]) / yardstick.HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
