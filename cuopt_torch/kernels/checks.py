"""Kernel-against-plain checks of the fused row pass and of the slot's
step kernels (`check_step_kernels`), on any CUDA card.

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
from cuopt_torch.lp import pdhg_step as ps

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


# ------------------------------------------------------ the step kernels
# float32 and float64: the tolerances of the slot's plain version against
# the torch slot (tests/test_torch_pdhg_step.py)
STEP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel_err(got, want) -> float:
    """max |got - want| over 1 + max |want| (NaN where either is)."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max().item() / (1 + want.abs().max().item())
            if want.numel() else 0.0)


def _slot_outputs(s):
    """A state to write a slot into, and its next attempt index."""
    out = s.replace(**{f: torch.empty_like(getattr(s, f))
                       for f in ps.COMMIT_FIELDS})
    return out, torch.empty_like(s.total_steps)


def check_step_kernels(dev, s, cfg, fused: bool) -> dict:
    """Each step kernel of lp/pdhg_step.py against its plain version on
    the same CUDA inputs (problem `dev`, state `s`, the fused row pass
    or not), then `kernel_slot` against `slot_reference` from `s`.

    The elementwise results must have the same bits (x_new, sigma, the
    sentinel bounds, y_new; the commit's vectors given the same partial
    sums); the partial sums and the slot's fields must agree within
    STEP_TOL x (1 + max|plain|); the commit, the next attempt index and
    the counters must be equal; the kernels run again on the same inputs
    must give the same bits."""
    tol = STEP_TOL[s.x.dtype]
    wk, wp = ps.step_work(dev, s, fused), ps.step_work(dev, s, fused)
    out = {}
    ps.primal(dev, s, wk)
    ps.primal_reference(dev, s, wp)
    out["x_new_same"] = torch.equal(wk.x_new, wp.x_new)
    out["sigma_same"] = torch.equal(wk.sigma, wp.sigma)
    if fused:
        out["sentinels_same"] = torch.equal(wk.lc0m, wp.lc0m) and \
            torch.equal(wk.uc0m, wp.uc0m)
        ax_new, y_new, aty_new = pf.spilled_row_pass(
            dev.op, wk.x_new, s.ax, s.y, wk.lc0m, wk.uc0m, wk.sigma)
        ps.row_sums(s, ax_new, y_new, wk)
        ps.row_sums_reference(s, ax_new, y_new, wp)
    else:
        ax_new = dev.op.matvec(wk.x_new)
        y_new = ps.dual(dev, s, ax_new, wk)
        ps.dual_reference(dev, s, ax_new, wp)
        out["y_new_same"] = torch.equal(wk.y_new, wp.y_new)
        aty_new = dev.op.rmatvec(y_new)
    for name, a, b in zip(("dxdx", "xx", "inter", "dydy", "yy"),
                          wk.sums(), wp.sums()):
        out[f"{name}_parts_err"] = _rel_err(a, b)
    # the commit from the kernels' partials on both sides
    wp.parts.copy_(wk.parts)
    pending = torch.zeros_like(s.total_steps)
    (ck, ck_p), (cp, cp_p) = _slot_outputs(s), _slot_outputs(s)
    ps.commit(s, pending, cfg, ck, ck_p, wk, ax_new, y_new, aty_new)
    ps.commit_reference(s, pending, cfg, cp, cp_p, wp, ax_new, y_new,
                        aty_new)
    out["commit_same"] = torch.equal(ck_p, cp_p) and all(
        torch.equal(getattr(ck, f), getattr(cp, f))
        for f in ps.COMMIT_FIELDS if f != "step_size")
    out["commit_step_size_err"] = _rel_err(ck.step_size, cp.step_size)
    # the kernels again on the same inputs: the same bits
    w2 = ps.step_work(dev, s, fused)
    ps.primal(dev, s, w2)
    if fused:
        ps.row_sums(s, ax_new, y_new, w2)
    else:
        y_new = ps.dual(dev, s, ax_new, w2)
    c2, c2_p = _slot_outputs(s)
    ps.commit(s, pending, cfg, c2, c2_p, w2, ax_new, y_new, aty_new)
    out["deterministic"] = torch.equal(w2.parts, wk.parts) and \
        torch.equal(w2.x_new, wk.x_new) and torch.equal(c2_p, ck_p) and \
        all(torch.equal(getattr(c2, f), getattr(ck, f))
            for f in ps.COMMIT_FIELDS)
    # the slot through the kernels and through the plain versions
    (gk, gk_p), (gp, gp_p) = _slot_outputs(s), _slot_outputs(s)
    ps.kernel_slot(dev, s, pending, cfg, gk, gk_p, wk)
    ps.slot_reference(dev, s, pending, cfg, gp, gp_p, wp)
    if s.x.is_cuda:
        torch.cuda.synchronize()  # a fault in a kernel shows up here
    for f in ps.COMMIT_FIELDS:
        a, b = getattr(gk, f), getattr(gp, f)
        if a.dtype.is_floating_point:
            out[f"slot_{f}_err"] = _rel_err(a, b)
        else:
            out[f"slot_{f}_same"] = torch.equal(a, b)
    out["slot_pending_same"] = torch.equal(gk_p, gp_p)
    out["ok"] = all(v <= tol for k, v in out.items() if k.endswith("_err")) \
        and all(v for k, v in out.items() if k.endswith("_same")
                or k == "deterministic")
    return out
