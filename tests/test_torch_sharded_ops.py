"""Every sharded operator form (cuopt_torch/sparse/ops.py shard_operator)
against the operator it was split from, on 4 CPU shards: each shard's
rows of A x and columns of A^T y (all of A^T y when x is replicated)
equal the unsharded products. The cases reach every path: dense, ELL,
CSR (nonzeros padded to a multiple of 4), the block band with the fixed
halo, the block band with spill and a ragged last tile (all-gathered
windows), and the permuted band, each with x sharded (columns divisible
by 4) and replicated."""

import numpy as np
import pytest
import torch

from cuopt_torch.parallel import make_mesh, run_spmd
from cuopt_torch.parallel.sharding import make_layout
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.sparse import build_operator
from cuopt_torch.sparse.ops import shard_operator
from cuopt_torch.sparse.reorder import permute_csr

D = 4
CASES = {  # kind, rows, cols, band, shuffled
    "dense": ("dense", 96, 64, None, False),
    "ell": ("ell", 512, 512, None, False),
    "csr": ("csr", 500, 512, None, False),
    "blockband-halo": ("blockband", 2048, 2048, 128, False),
    "blockband-general": ("blockband", 5000, 5000, 256, False),
    "bandperm": ("bandperm", 2048, 2048, 128, True),
}


def _operator(kind, n_rows, n_cols, band, shuffled):
    p = generate_lp(n_rows, n_cols, 6, seed=5, band=band)
    offsets, indices, values = p.offsets, p.indices, p.values
    if shuffled:
        rng = np.random.default_rng(7)
        offsets, indices, values = permute_csr(
            offsets, indices, np.asarray(values, np.float64),
            rng.permutation(n_rows), rng.permutation(n_cols), n_rows,
            n_cols)
    return build_operator(offsets, indices, values, n_rows, n_cols,
                          dtype=torch.float64, kind=kind, device="cpu")


@pytest.mark.parametrize("x_sharded", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_products_match(case, x_sharded):
    kind, n_rows, n_cols, band, shuffled = CASES[case]
    n_cols += 0 if x_sharded else 1  # a column count 4 does not divide
    op = _operator(kind, n_rows, n_cols, band, shuffled)
    mesh = make_mesh(devices=["cpu"] * D)
    layout = make_layout(op, D)
    assert (layout.col_splits is not None) == x_sharded
    ops = shard_operator(op, layout, mesh)
    first = ops[0]
    if case == "blockband-halo":
        # the halo gates need whole, evenly split column tiles too
        halos = (first.row_halo, first.col_halo, first.halo_meta)
        assert all(h is not None for h in halos) == x_sharded
    if case == "blockband-general":
        assert first.row_halo is None and first.halo_meta is None
        assert sum(o.spill_vals.numel() + o.t_spill_vals.numel()
                   for o in ops) > 0
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=n_cols))
    y = torch.as_tensor(rng.normal(size=n_rows))
    ax, aty = op.matvec(x), op.rmatvec(y)

    def body(comm, sop):
        sop = sop.bind(comm)
        r0, r1 = layout.rows(comm.rank)
        c0, c1 = layout.cols(comm.rank)
        return sop.matvec(x[c0:c1]), sop.rmatvec(y[r0:r1])

    out = run_spmd(mesh, body, [(o,) for o in ops])
    got_ax = torch.cat([o[0] for o in out])
    if x_sharded:
        got_aty = torch.cat([o[1] for o in out])
    else:
        assert all(torch.equal(o[1], out[0][1]) for o in out)
        got_aty = out[0][1]
    torch.testing.assert_close(got_ax, ax, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_aty, aty, rtol=1e-12, atol=1e-12)
