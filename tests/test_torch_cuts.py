"""cuopt_torch's root GMI cuts against cuopt_tpu's, on the CPU.

Both packages solve each cut round with the same native dual simplex
(built from the same source) and derive the cuts in numpy, so the cut
rows, the bound and the last cut-LP optimum are equal."""

import numpy as np
import pytest
import torch

from cuopt_torch.lp.settings import MIPSolverSettings as TSettings
from cuopt_torch.mip import cuts as T
from cuopt_torch.problem.data_model import OptimizationProblem as TProb
from cuopt_torch.problem.synthetic import generate_lp as t_generate
from cuopt_torch.utils.logger import get_logger
from cuopt_torch.utils.timer import Timer

pytest.importorskip("jax")
from cuopt_tpu.lp.settings import MIPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.mip import cuts as J  # noqa: E402
from cuopt_tpu.problem.data_model import OptimizationProblem as JProb  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402
from torch_mip_instances import staircase_mip, twelve_binaries  # noqa: E402

torch.set_num_threads(1)

INSTANCES = {
    "twelve-binaries": lambda: (twelve_binaries(TProb),
                                twelve_binaries(JProb)),
    "staircase-mip-120": lambda: (staircase_mip(t_generate, 120, 1),
                                  staircase_mip(j_generate, 120, 1)),
}


# Both instances have integral bounds on every integer column (binaries,
# and staircase_mip's [0, 1]): there the port's repaired cuts (integer
# coefficients only at an integral active bound, drops only when bounded
# and negligible) are cuopt_tpu's bit for bit. On fractional bounds the
# two differ by design: see test_cuts_keep_every_integer_point.
@pytest.mark.parametrize("name", list(INSTANCES))
def test_strengthen_root_matches(name):
    tp, jp = INSTANCES[name]()
    log = get_logger()
    a = T.strengthen_root(tp, TSettings(), Timer(30.0), log)
    b = J.strengthen_root(jp, JSettings(), JTimer(30.0), log)
    assert a[2] == b[2] and a[1] == b[1]  # cut count and bound
    assert a[2] > 0, "the instance should take at least one cut"
    for f in ("offsets", "indices", "values", "constraint_lower_bounds",
              "constraint_upper_bounds"):
        assert np.array_equal(getattr(a[0], f), getattr(b[0], f)), f
    assert np.array_equal(a[3], b[3])
    # the cuts cut off the plain root optimum but keep every integer
    # point that the rows admit (checked on the 12 binaries by brute force)
    if name == "twelve-binaries":
        A = a[0].to_dense()
        for mask in range(1 << 12):
            x = np.array([(mask >> k) & 1 for k in range(12)], float)
            if np.all(tp.to_dense() @ x <= tp.constraint_upper_bounds):
                assert np.all(A @ x >= a[0].constraint_lower_bounds - 1e-9)


def _fractional_bound_mip(seed):
    """A pure-integer MIP with 3-5 columns and 2-3 `<=` rows whose column
    bounds are, for about half the columns, fractional (k + 0.5 or
    k + 0.4): the case where cuopt_tpu's GMI cuts remove integer points."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(3, 6)), int(rng.integers(2, 4))
    A = rng.integers(1, 9, (m, n)).astype(float)
    lo = rng.integers(0, 2, n).astype(float)
    hi = lo + rng.integers(1, 4, n)
    frac = rng.random(n) < 0.5
    shift = np.where(rng.random(n) < 0.5, 0.5, 0.4)
    side = rng.random(n) < 0.5
    lo = np.where(frac & side, lo - 1 + shift, lo)
    hi = np.where(frac & ~side, hi + shift, hi)
    ub = A @ (lo + 0.45 * (hi - lo))
    p = TProb.from_dense(
        A, c=-rng.integers(1, 20, n).astype(float),
        constraint_lower=np.full(m, -np.inf), constraint_upper=ub,
        variable_lower=lo, variable_upper=hi,
        variable_types=np.array(["I"] * n))
    return p


def _integer_points(p):
    """Every integer point inside the column bounds that the rows admit."""
    import itertools

    A = p.to_dense()
    ranges = [range(int(np.ceil(lo)), int(np.floor(hi)) + 1) for lo, hi in
              zip(p.variable_lower_bounds, p.variable_upper_bounds)]
    pts = np.array(list(itertools.product(*ranges)), float)
    keep = np.all(pts @ A.T <= p.constraint_upper_bounds + 1e-9, axis=1)
    return pts[keep]


def test_cuts_keep_every_integer_point():
    """400 seeded MIPs with fractional integer bounds: strengthen_root's
    cuts remove no integer point that the rows admit (tolerance 1e-7 on
    a cut row). cuopt_tpu's cuts removed one in 106 of 393 instances that
    took cuts, because they gave an integer column at a fractional bound
    the integer coefficient."""
    log = get_logger()
    n_cut = 0
    bad = []
    for seed in range(400):
        p = _fractional_bound_mip(seed)
        cut, _, k, _ = T.strengthen_root(p, TSettings(), Timer(30.0), log)
        if not k:
            continue
        n_cut += 1
        pts = _integer_points(p)
        rows = cut.to_dense()[p.n_constraints:]
        rhs = cut.constraint_lower_bounds[p.n_constraints:]
        if len(pts) and np.any(pts @ rows.T < rhs - 1e-7):
            bad.append(seed)
    assert n_cut > 100, n_cut  # the test exercises the cuts
    assert bad == []
