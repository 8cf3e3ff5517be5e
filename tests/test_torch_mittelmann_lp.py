"""tests/test_mittelmann_lp.py's gate on the port, on the CPU: on a
shrunken copy of every Mittelmann-structure family, PDLP at 1e-6 agrees
with the port's dual simplex within 1e-4 (1 + |objective|).
test_torch_problem_sparse.py holds the generators equal to cuopt_tpu's.
The copies are smaller than the JAX file's (scale 800) to keep the CPU
run short; staircase-supply, whose GENERATORS entry keeps at least 50
periods of 200 products, is built with 12 periods of 40."""

import pytest
import torch

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.problem.mittelmann import GENERATORS, supply_chain_staircase
from cuopt_torch.utils.timer import Timer

torch.set_num_threads(1)


def shrunken(name):
    if name == "staircase-supply":
        return supply_chain_staircase(n_periods=12, n_products=40, seed=3)
    return GENERATORS[name](200, 3)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_pdlp_matches_simplex_on_shrunken_copy(name):
    prob = shrunken(name)
    prob.validate()
    s = PDLPSolverSettings()
    s.time_limit = 120
    s.log_to_console = False
    ds = solve_lp_simplex(prob, s, Timer(120))
    assert ds["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL, name
    s2 = PDLPSolverSettings()
    s2.time_limit = 300
    s2.log_to_console = False
    s2.set_optimality_tolerance(1e-6)
    s2.iteration_limit = 200_000
    lp = PdlpSolver(prob, s2, "cpu").run()
    assert lp["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL, name
    a, b = ds["primal_objective"], lp["primal_objective"]
    assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (name, a, b)
