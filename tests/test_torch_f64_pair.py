"""The port's float64 product pair against the plain reference.

`BlockBandOp.matvec` and `rmatvec` (and a `PermutedOp` around one), as
`build_operator(dtype=torch.float64, kind="auto")` builds them, against
`perfbench/torch_reference/band_pair.py`: A x and A^T y from the LP's
own CSR arrays, one `index_add_` in float64 each. The LPs are the benchmark's
staircases (`perfbench/lpgen.py`) in banded order, shuffled, with
entries outside the windows (spills), and with rows and columns that
are not whole tiles, so windows run past the last column.

The tolerance is 1e-12 * (1 + max|ref|): each output is a sum of at most
a tile's window of products, so float64 rounding leaves some 1e-15 of
the largest magnitudes; the bound leaves a thousandfold room for the
other order of the sums, and float32 (about 1e-7 relative) fails it
by some five orders of magnitude, as the float32 operator must.

Also the float32 control at the float64 cell's tolerance
(`perfbench/control_f32.py`): on a small staircase the float32 answer
the program calls Optimal misses the reference's limit, where the
float64 one meets it.

The test marked `gpu` makes the pair's comparison on the card, at 50k,
on the cell's own LP (`python -m pytest -m gpu tests/test_torch_f64_pair.py`).
"""

import copy

import numpy as np
import pytest
import torch

from cuopt_torch.sparse import build_operator
from cuopt_torch.sparse.ops import BlockBandOp, PermutedOp
from perfbench import control_f32, harness, lpgen
from perfbench.drivers import lp_solve
from perfbench.torch_reference import band_pair

torch.set_num_threads(1)


def _tol(ref):
    return 1e-12 * (1.0 + float(ref.abs().max()))


def _with_spills(lp, seed):
    """The LP with one nonzero of every 64th row moved to a column far
    outside its band, so each side of the layout spills."""
    lp = dict(lp, indices=lp["indices"].copy())
    n_cols = len(lp["c"])
    rng = np.random.default_rng(seed)
    for r in range(0, len(lp["lc"]), 64):
        k = lp["offsets"][r] + rng.integers(lp["offsets"][r + 1]
                                            - lp["offsets"][r])
        lp["indices"][k] = (lp["indices"][k] + n_cols // 2) % n_cols
    return lp


def _case(name):
    """(lp, the operator class build_operator must return)."""
    if name == "banded":
        return lpgen.staircase(4096, 4096, 8, 256, 71), BlockBandOp
    if name == "shuffled":
        lp = lpgen.staircase(4096, 4096, 8, 256, 72)
        return lpgen.shuffle(lp, np.random.default_rng(3)), PermutedOp
    if name == "spills":
        return _with_spills(lpgen.staircase(4096, 4096, 8, 256, 73),
                            5), BlockBandOp
    # rows and columns not whole tiles, and more columns than rows: the
    # last row tile's window runs past the last column
    return lpgen.staircase(2500, 3001, 8, 256, 74), BlockBandOp


def _build(lp, dtype, device="cpu"):
    return build_operator(lp["offsets"], lp["indices"], lp["values"],
                          len(lp["lc"]), len(lp["c"]), dtype=dtype,
                          kind="auto", device=device)


def _pair(op, lp, dtype, seed, device="cpu"):
    """(errors of A x and A^T y, their tolerances) of `op` against the
    reference on seeded vectors."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(len(lp["c"])), device=device)
    y = torch.as_tensor(rng.standard_normal(len(lp["lc"])), device=device)
    nz = band_pair.csr(lp, device)
    out = []
    for got, ref in ((op.matvec(x.to(dtype)), band_pair.matvec(lp, x, nz)),
                     (op.rmatvec(y.to(dtype)),
                      band_pair.rmatvec(lp, y, nz))):
        assert got.shape == ref.shape
        out.append((float((got.to(torch.float64) - ref).abs().max()),
                    _tol(ref)))
    return out


@pytest.mark.parametrize("case", ["banded", "shuffled", "spills",
                                  "padded"])
def test_float64_pair_equals_the_reference(case):
    lp, kind = _case(case)
    op = _build(lp, torch.float64)
    assert type(op) is kind
    inner = getattr(op, "inner", op)
    if case == "spills":
        assert inner.spill_vals.numel() and inner.t_spill_vals.numel()
    if case == "padded":
        assert int(inner.row_win.max()) >= len(lp["c"])
        assert inner.row_slabs.shape[0] * inner.tile > len(lp["lc"])
    for err, tol in _pair(op, lp, torch.float64, 11):
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("case", ["banded", "shuffled", "spills",
                                  "padded"])
def test_float32_pair_fails_the_tolerance(case):
    lp, kind = _case(case)
    op = _build(lp, torch.float32)
    assert type(op) is kind
    for err, tol in _pair(op, lp, torch.float32, 11):
        assert err > 100 * tol, (err, tol)


def test_reference_against_a_dense_product():
    lp = lpgen.staircase(300, 200, 5, 40, 9)
    a = np.zeros((300, 200))
    rows = np.repeat(np.arange(300), np.diff(lp["offsets"]))
    np.add.at(a, (rows, lp["indices"]), lp["values"])
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(200), rng.standard_normal(300)
    np.testing.assert_allclose(
        band_pair.matvec(lp, torch.as_tensor(x)).numpy(), a @ x,
        rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        band_pair.rmatvec(lp, torch.as_tensor(y)).numpy(), a.T @ y,
        rtol=0, atol=1e-13)


# --------------------------------------------- the float32 control, small
# float32's miss grows with the LP. At 256 rows it showed on 2 of 33 LPs
# and narrowly (1.02 and 1.38 of the tolerance); at 1,024 rows on 5 of 6,
# the same readings with one thread or two. The test takes the second LP
# of seed 8 at 1,024 rows: float32 1.70 in 3,640 steps, float64 0.87 in
# 2,840 (the program calls both Optimal).
CONTROL_N, CONTROL_SEED, CONTROL_REQUEST = 1024, 8, 1


def test_float32_control_misses_the_limit_float64_meets_it():
    c = harness.cell(harness.load_json(harness.ROOT, "BENCHMARK.json"),
                     "stair50k.f64")
    config = copy.deepcopy(c["config"])
    config["generator"].update(n_rows=CONTROL_N, n_cols=CONTROL_N)
    drv64 = lp_solve.Driver(config, c["traffic"], "cpu")
    drv32 = lp_solve.Driver(control_f32.float32_config(config),
                            c["traffic"], "cpu")
    assert drv32.settings.dtype == "float32"
    assert drv64.settings.dtype == "float64"
    limit = config["check"]["kkt_limit"]
    (row,) = control_f32.readings(drv64, drv32, CONTROL_SEED, 1,
                                  first=CONTROL_REQUEST)
    assert row["f64_status"] == "Optimal" and row["f64"] <= limit
    assert row["f32_status"] != "Optimal" or row["f32"] > limit


# --------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_float64_pair_on_the_card_at_the_cells_size(cuda):
    """The cell's first LP of a run with seed 2**31 + 23, its float64
    operator built on the card, against the reference on the card; the
    float32 operator of the same LP fails the tolerance."""
    c = harness.cell(harness.load_json(harness.ROOT, "BENCHMARK.json"),
                     "stair50k.f64")
    lp = lp_solve.Driver(c["config"], c["traffic"], cuda).lp(2**31 + 23, 0)
    op = _build(lp, torch.float64, cuda)
    assert type(op) is BlockBandOp and op.row_slabs.is_cuda
    for err, tol in _pair(op, lp, torch.float64, 5, cuda):
        assert err <= tol, (err, tol)
    op32 = _build(lp, torch.float32, cuda)
    for err, tol in _pair(op32, lp, torch.float32, 5, cuda):
        assert err > 100 * tol, (err, tol)
