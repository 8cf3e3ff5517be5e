"""The plain reference of the float64 product pair: A x and A^T y.

An LP's matrix is given by its own CSR arrays (`offsets`, `indices`,
`values`, as `perfbench.lpgen` makes them). Each product is one gather
and one `index_add_` in float64 over the nonzeros, with no layout, no
slabs and no kernel of the program. It runs on any torch device, so the
comparison with the program's band operator can be made at the cell's
size on the card. Matrix products may not run in TF32 here.

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


def csr(lp: dict, device="cpu") -> tuple:
    """(rows, cols, vals) of the LP's nonzeros on `device`: int64, int64,
    float64."""
    offsets = np.asarray(lp["offsets"], np.int64)
    rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(np.asarray(lp["indices"], np.int64),
                            device=device),
            torch.as_tensor(np.asarray(lp["values"], np.float64),
                            device=device))


def matvec(lp: dict, x: torch.Tensor, nz=None) -> torch.Tensor:
    """A x in float64 on x's device; `nz` is `csr(lp, x.device)` when
    the caller keeps it."""
    _plain_fp64()
    rows, cols, vals = nz if nz is not None else csr(lp, x.device)
    out = torch.zeros(len(lp["offsets"]) - 1, dtype=torch.float64,
                      device=x.device)
    return out.index_add_(0, rows, vals * x.to(torch.float64)[cols])


def rmatvec(lp: dict, y: torch.Tensor, nz=None) -> torch.Tensor:
    """A^T y in float64 on y's device."""
    _plain_fp64()
    rows, cols, vals = nz if nz is not None else csr(lp, y.device)
    out = torch.zeros(len(lp["c"]), dtype=torch.float64, device=y.device)
    return out.index_add_(0, cols, vals * y.to(torch.float64)[rows])
