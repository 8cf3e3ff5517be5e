"""The reference accepts the program's answer and rejects a perturbed or
lower-precision one."""

import numpy as np
import pytest
import torch

from perfbench import lpgen
from perfbench.reference import kkt

EPS = 1e-4
LIMIT = 1.01


def _bf16(v):
    return torch.as_tensor(v).to(torch.bfloat16).double().numpy()


def test_a_known_optimum_reads_zero():
    # min -x0 - x1  s.t.  x0 + x1 <= 1,  0 <= x <= 1: x = (0.5, 0.5) and
    # y = -1 are optimal (A^T y = (-1, -1) = c, so rc = 0)
    lp = {"offsets": np.array([0, 2]), "indices": np.array([0, 1]),
          "values": np.array([1.0, 1.0]), "c": np.array([-1.0, -1.0]),
          "lc": np.array([-np.inf]), "uc": np.array([1.0]),
          "lv": np.zeros(2), "uv": np.ones(2)}
    s = kkt.shares(lp, [0.5, 0.5], [-1.0], -1.0, EPS)
    assert s == {"primal": 0.0, "dual": 0.0, "gap": 0.0}
    # an objective that disagrees with x fails the gap
    assert kkt.shares(lp, [0.5, 0.5], [-1.0], -0.9, EPS)["gap"] > 100
    # y > 0 on a row with no lower bound is not dual feasible
    assert kkt.shares(lp, [0.5, 0.5], [1.0], -1.0, EPS)["dual"] > 100
    # x past its upper bound is not primal feasible
    assert kkt.shares(lp, [1.5, 0.0], [-1.0], -1.5, EPS)["primal"] > 100


def test_matvec_against_dense():
    lp = lpgen.staircase(300, 280, 8, 64, 3)
    dense = np.zeros((300, 280))
    rows = np.repeat(np.arange(300), 8)
    np.add.at(dense, (rows, lp["indices"]), lp["values"])
    x = np.random.default_rng(0).random(280)
    y = np.random.default_rng(1).random(300)
    assert np.allclose(kkt.matvec(lp, x), dense @ x, rtol=1e-12, atol=0)
    assert np.allclose(kkt.rmatvec(lp, y), dense.T @ y, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def solved():
    """A 4,096-row staircase solved by the program in float32."""
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.problem.data_model import OptimizationProblem

    lp = lpgen.staircase(4096, 4096, 8, 256, 77)
    s = PDLPSolverSettings()
    s.method, s.dtype, s.log_to_console = C.CUOPT_METHOD_PDLP, "float32", False
    s.set_optimality_tolerance(EPS)
    sol = solve_lp(OptimizationProblem(
        offsets=lp["offsets"], indices=lp["indices"], values=lp["values"],
        objective_coefficients=lp["c"], constraint_lower_bounds=lp["lc"],
        constraint_upper_bounds=lp["uc"], variable_lower_bounds=lp["lv"],
        variable_upper_bounds=lp["uv"]), s, device="cpu")
    assert sol.get_termination_reason() == "Optimal"
    return (lp, np.asarray(sol.get_primal_solution()),
            np.asarray(sol.get_dual_solution()), sol.get_primal_objective())


def test_accepts_the_programs_answer(solved):
    lp, x, y, obj = solved
    assert kkt.worst(kkt.shares(lp, x, y, obj, EPS)) <= 1.0


@pytest.mark.parametrize("fault", [
    "bf16", "x_noise", "x_reversed", "y_zero", "y_flipped", "objective",
    "x_short", "x_nan"])
def test_rejects_a_perturbed_or_lower_precision_answer(solved, fault):
    lp, x, y, obj = solved
    rng = np.random.default_rng(0)
    if fault == "bf16":
        x, y = _bf16(x), _bf16(y)
    elif fault == "x_noise":
        x = np.clip(x + 1e-3 * rng.standard_normal(x.shape), 0, 1)
    elif fault == "x_reversed":
        x = x[::-1]
    elif fault == "y_zero":
        y = np.zeros_like(y)
    elif fault == "y_flipped":
        y = -y
    elif fault == "objective":
        obj = obj * (1 + 1e-3) + 1e-3
    elif fault == "x_short":
        x = x[:-1]
    elif fault == "x_nan":
        x = x.copy()
        x[0] = np.nan
    assert kkt.worst(kkt.shares(lp, x, y, obj, EPS)) > 3 * LIMIT
