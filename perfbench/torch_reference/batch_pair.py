"""The plain reference of a batch's float64 product pairs: A_b x_b and
A_b^T y_b for every member b.

Each member's matrix is given by its own CSR arrays (`offsets`,
`indices`, `values`, as `perfbench.lpgen` makes them); members may share
them or not. Each product of the whole batch is one gather and one
`index_add_` in float64 over every member's nonzeros, placed at
b * n + row (or b * m + column), with no layout, no slabs, no stacking
and no kernel of the program. It runs on any torch device, so the
comparison with the program's stacked operator can be made at the
cell's size on the card. Matrix products may not run in TF32 here.

Only torch and NumPy: nothing of the program is imported or used.
"""

from __future__ import annotations

import numpy as np
import torch


def _plain_fp64():
    # no product of this module goes through a matmul, but a reference
    # never lets one round to TF32 unseen
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def csr(lps: list, device="cpu") -> tuple:
    """(rows, cols, vals) of every member's nonzeros on `device`, the
    rows offset by b * n and the columns by b * m for member b: int64,
    int64, float64."""
    n, m = len(lps[0]["lc"]), len(lps[0]["c"])
    rows, cols, vals = [], [], []
    for b, lp in enumerate(lps):
        offsets = np.asarray(lp["offsets"], np.int64)
        rows.append(b * n + np.repeat(np.arange(len(offsets) - 1),
                                      np.diff(offsets)))
        cols.append(b * m + np.asarray(lp["indices"], np.int64))
        vals.append(np.asarray(lp["values"], np.float64))
    return tuple(torch.as_tensor(np.concatenate(a), device=device)
                 for a in (rows, cols, vals))


def matvec(lps: list, x: torch.Tensor, nz=None) -> torch.Tensor:
    """(B, n): A_b x_b for x of shape (B, m), in float64 on x's device;
    `nz` is `csr(lps, x.device)` when the caller keeps it."""
    _plain_fp64()
    rows, cols, vals = nz if nz is not None else csr(lps, x.device)
    B, n = len(lps), len(lps[0]["lc"])
    out = torch.zeros(B * n, dtype=torch.float64, device=x.device)
    out.index_add_(0, rows, vals * x.to(torch.float64).reshape(-1)[cols])
    return out.reshape(B, n)


def rmatvec(lps: list, y: torch.Tensor, nz=None) -> torch.Tensor:
    """(B, m): A_b^T y_b for y of shape (B, n), in float64 on y's
    device."""
    _plain_fp64()
    rows, cols, vals = nz if nz is not None else csr(lps, y.device)
    B, m = len(lps), len(lps[0]["c"])
    out = torch.zeros(B * m, dtype=torch.float64, device=y.device)
    out.index_add_(0, cols, vals * y.to(torch.float64).reshape(-1)[rows])
    return out.reshape(B, m)
