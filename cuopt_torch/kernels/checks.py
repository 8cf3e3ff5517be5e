"""Kernel-against-plain checks of the fused row pass, on any CUDA card.

Used by chip_smoke.py at the main path's shapes and by
tests/test_torch_gpu.py at small ones. Inputs come from a numpy seed;
both the kernel and its plain PyTorch version (`row_pass_reference`) run
on the same CUDA tensors.

Tolerances: ax, y_new and A^T y within 1e-5 of 1 + max|plain| (float32
sums taken in another order; the atomic mode's order also changes from
run to run); the step-size dot products dy.(ax_new - ax_old) and dy.dy
within 1e-3 of 1 + |plain| (reductions of the above over all rows).
The partials mode must give the same bits twice, and its A^T y must have
exactly the bits of its own per-tile parts summed in the plan's order
(`reduce_partials_reference`).
"""

from __future__ import annotations

import numpy as np
import torch

from cuopt_torch.lp import pdhg_fused as pf

VEC_TOL = 1e-5
DOT_TOL = 1e-3


def row_pass_inputs(op, seed: int = 0):
    """(x, ax_old, ax_spill or None, y, lc0m, uc0m, sigma) for `op`: float32
    tensors on the operator's device, about 30% of each bound side
    infinite (masked to -/+1e30), sigma 0.37."""
    n, m = op.shape
    rng = np.random.default_rng(seed)
    lc = rng.normal(size=n)
    uc = lc + np.abs(rng.normal(size=n))
    arrays = [
        rng.normal(size=m),
        rng.normal(size=n),
        rng.normal(size=n) if op.spill_vals.numel() else None,
        rng.normal(size=n),
        np.where(rng.random(n) > 0.3, lc, -1e30),
        np.where(rng.random(n) > 0.3, uc, 1e30),
        np.float64(0.37),
    ]
    dev = op.row_slabs.device
    return tuple(None if a is None else torch.as_tensor(
        np.asarray(a, np.float32), device=dev) for a in arrays)


def _dots(y, ax_old, ax_new, y_new):
    dy = y_new - y
    return torch.dot(dy, ax_new - ax_old), torch.dot(dy, dy)


def fold_is_exact(op, inputs) -> bool:
    """Whether the partials pass's A^T y has the bits of its per-tile
    parts summed one after another in the plan's (tile-ascending) order,
    the order of `reduce_partials_reference`, which keeps that order on
    the CPU."""
    if inputs[0].is_cuda:
        parts = torch.empty(op.row_slabs.shape[0], op.w_row,
                            dtype=torch.float32, device=inputs[0].device)
        aty = pf.row_pass_kernel(op, *inputs, "partials", parts=parts)[2]
    else:
        parts = pf.row_pass_partials_reference(op, *inputs)[2]
        aty = pf.row_pass_reference(op, *inputs, "partials")[2]
    return torch.equal(aty.cpu(),
                       pf.reduce_partials_reference(op, parts.cpu()))


def check_row_pass(op, mode: str, inputs) -> dict:
    """Run the kernel of `mode` and the plain version on `inputs`.
    Returns the errors, whether they are within the tolerances (`ok`),
    and, for the partials mode, whether a second run gave the same bits
    (`deterministic`) and whether A^T y is its parts summed in the plan's
    order (`folded_exact`)."""
    x, ax_old, ax_spill, y, lc, uc, sigma = inputs
    got = pf.row_pass(op, x, ax_old, ax_spill, y, lc, uc, sigma, mode)
    ref = pf.row_pass_reference(op, x, ax_old, ax_spill, y, lc, uc, sigma,
                                mode)
    if x.is_cuda:
        torch.cuda.synchronize()  # a fault in the kernel shows up here
    out = {}
    for name, a, b in zip(("ax", "y", "aty"), got, ref):
        err = (a - b).abs().max().item()
        out[f"{name}_err"] = err
        out[f"{name}_ok"] = err <= VEC_TOL * (1 + b.abs().max().item())
    for name, a, b in zip(("interaction", "dy_dot"),
                          _dots(y, ax_old, got[0], got[1]),
                          _dots(y, ax_old, ref[0], ref[1])):
        a, b = a.item(), b.item()
        out[f"{name}_err"] = abs(a - b)
        out[f"{name}_ok"] = abs(a - b) <= DOT_TOL * (1 + abs(b))
    out["max_abs_err"] = max(out["ax_err"], out["y_err"], out["aty_err"])
    if mode == "partials":
        again = pf.row_pass(op, x, ax_old, ax_spill, y, lc, uc, sigma, mode)
        out["deterministic"] = all(torch.equal(a, b)
                                   for a, b in zip(got, again))
        out["folded_exact"] = fold_is_exact(op, inputs)
    out["ok"] = all(v for k, v in out.items()
                    if k.endswith("_ok")
                    or k in ("deterministic", "folded_exact"))
    return out
