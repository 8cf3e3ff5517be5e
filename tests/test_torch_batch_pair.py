"""The batch LP's stacked float64 product pair against the plain reference.

The members are built as `lp/batch.py _solve_stacked` builds them
(`build_device_problem(..., kind="blockband", dtype=float64)`, stacked
by `_stack`), and the products run under `torch.func.vmap` through the
`_join` of `_batched_fns`, over the stacked slabs. Against them:
`perfbench/torch_reference/batch_pair.py`, A_b x_b and A_b^T y_b from
each member's own CSR arrays, one `index_add_` in float64 for the batch.
The device problem's operator is the scaled R_b A_b C_b, so the
reference is given C_b x_b and R_b y_b and its products are scaled by
R_b and C_b, with the scales the build computed.

Three batches: members that share one matrix and differ in 1% of their
column bounds (the recipe of the `stair50k.batch8` cell,
`perfbench/drivers/lp_batch.py`); members of one pattern with values of
their own, which a batch that read the first member's slabs for every
member would fail; and members with entries outside their tiles'
windows (spills) on each side of the layout.

The tolerance is 1e-12 * (1 + max|ref|): each output is a sum of at most
a tile's window of products, so float64 rounding leaves some 1e-15 of
the largest magnitudes, and the scaling adds two roundings more (at
2,048 rows the error reads 6.7e-16 to 8.9e-16 against bounds of
2.6e-12 to 2.9e-12); float32 (about 1e-7 relative) fails the bound by
some five orders of magnitude, as the same stacked operator built in
float32 must.

The test marked `gpu` makes the comparison on the card, at 50k x 8, on
the cell's own members (`python -m pytest -m gpu
tests/test_torch_batch_pair.py`).
"""

import copy

import numpy as np
import pytest
import torch
from torch.func import vmap

import cuopt_torch.lp.batch as TB
from cuopt_torch.lp.pdlp import PdlpSolver, build_device_problem
from perfbench import harness, lpgen
from perfbench.drivers import lp_batch
from perfbench.torch_reference import batch_pair

torch.set_num_threads(1)

N = 2048
MEMBERS = 4


def _tol(ref):
    return 1e-12 * (1.0 + float(ref.abs().max()))


def _driver(n=N, members=MEMBERS, device="cpu"):
    """The cell's driver, at n rows and columns and `members` members."""
    c = harness.cell(harness.load_json(harness.ROOT, "BENCHMARK.json"),
                     "stair50k.batch8")
    config, traffic = copy.deepcopy(c["config"]), dict(c["traffic"])
    config["generator"].update(n_rows=n, n_cols=n)
    traffic["members"] = members
    return lp_batch.Driver(config, traffic, device)


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


def _own_values(lps, seed):
    """The members with values of their own on the shared pattern."""
    rng = np.random.default_rng(seed)
    return [dict(lp, values=lp["values"] * rng.uniform(
        0.5, 1.5, len(lp["values"]))) for lp in lps]


def _lps(case):
    lps = _driver().lps(2**31 + 41, 0)
    if case == "own_values":
        return _own_values(lps, 3)
    if case == "spills":
        base = _with_spills(lps[0], 5)
        return _own_values([dict(lp, indices=base["indices"])
                            for lp in lps], 4)
    return lps


def _stacked_pair(drv, lps, dtype, seed, device="cpu"):
    """(errors of the batched A x and A^T y, their tolerances): the
    members built and stacked as _solve_stacked does, the products
    vmapped over the stacked leaves, against the reference on seeded
    vectors."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    probs = [OptimizationProblem(
        offsets=lp["offsets"], indices=lp["indices"], values=lp["values"],
        objective_coefficients=lp["c"], constraint_lower_bounds=lp["lc"],
        constraint_upper_bounds=lp["uc"], variable_lower_bounds=lp["lv"],
        variable_upper_bounds=lp["uv"]) for lp in lps]
    assert TB._pick_batch_kind(probs) == "blockband"
    hp = PdlpSolver(probs[0], drv.settings, device).hp
    devs = [build_device_problem(p, hp, dtype, "blockband", device)
            for p in probs]
    dev_b = TB._stack(devs)
    assert dev_b["op.row_slabs"].shape[0] == len(lps)

    def mv(dev_l, v):
        return TB._join(devs[0], dev_l).op.matvec(v)

    def rmv(dev_l, v):
        return TB._join(devs[0], dev_l).op.rmatvec(v)

    B, n, m = len(lps), len(lps[0]["lc"]), len(lps[0]["c"])
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, m)), device=device)
    y = torch.as_tensor(rng.standard_normal((B, n)), device=device)
    rs = dev_b["row_scale"].to(torch.float64)
    cs = dev_b["col_scale"].to(torch.float64)
    nz = batch_pair.csr(lps, device)
    out = []
    for got, ref in (
            (vmap(mv)(dev_b, x.to(dtype)),
             rs * batch_pair.matvec(lps, cs * x, nz)),
            (vmap(rmv)(dev_b, y.to(dtype)),
             cs * batch_pair.rmatvec(lps, rs * y, nz))):
        assert got.shape == ref.shape
        out.append((float((got.to(torch.float64) - ref).abs().max()),
                    _tol(ref)))
    return devs, out


CASES = ["shared_matrix", "own_values", "spills"]


@pytest.mark.parametrize("case", CASES)
def test_stacked_float64_pair_equals_the_reference(case):
    lps = _lps(case)
    devs, errs = _stacked_pair(_driver(), lps, torch.float64, 11)
    op = devs[0].op
    if case == "spills":
        assert op.spill_vals.numel() and op.t_spill_vals.numel()
    if case == "shared_matrix":
        assert all(lp["values"] is lps[0]["values"] for lp in lps)
        assert not all(np.array_equal(lp["lv"], lps[0]["lv"]) for lp in lps)
    for err, tol in errs:
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("case", CASES)
def test_stacked_float32_pair_fails_the_tolerance(case):
    _, errs = _stacked_pair(_driver(), _lps(case), torch.float32, 11)
    for err, tol in errs:
        assert err > 100 * tol, (err, tol)


def test_reference_against_each_member_alone():
    """The batched reference equals each member's own dense product."""
    base = lpgen.staircase(300, 200, 5, 40, 9)
    lps = _own_values([base, base, base], 2)
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((3, 200)), rng.standard_normal((3, 300))
    ax = batch_pair.matvec(lps, torch.as_tensor(x)).numpy()
    aty = batch_pair.rmatvec(lps, torch.as_tensor(y)).numpy()
    rows = np.repeat(np.arange(300), np.diff(base["offsets"]))
    for b, lp in enumerate(lps):
        a = np.zeros((300, 200))
        np.add.at(a, (rows, lp["indices"]), lp["values"])
        np.testing.assert_allclose(ax[b], a @ x[b], rtol=0, atol=1e-13)
        np.testing.assert_allclose(aty[b], a.T @ y[b], rtol=0, atol=1e-13)


# --------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_stacked_pair_on_the_card_at_the_cells_size(cuda):
    """The cell's first request of a run with seed 2**31 + 29: 8 members
    of the 50k staircase, built and stacked on the card, against the
    reference on the card; the same batch built in float32 fails."""
    drv = _driver(n=50_000, members=8, device=cuda)
    lps = drv.lps(2**31 + 29, 0)
    devs, errs = _stacked_pair(drv, lps, torch.float64, 5, cuda)
    assert devs[0].op.row_slabs.is_cuda
    for err, tol in errs:
        assert err <= tol, (err, tol)
    del devs
    _, errs = _stacked_pair(drv, lps, torch.float32, 5, cuda)
    for err, tol in errs:
        assert err > 100 * tol, (err, tol)
