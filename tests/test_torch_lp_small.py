"""The small hand-built LPs of tests/test_lp_solver.py through both
packages' `linear_programming` façade (the port's on the CPU): the same
status and objective, and the solution object's vectors and names.

The JAX file's other LPs are read from the absent reference datasets;
their behaviours (presets, limits, warm start, infeasibility, primal
modes) are held on generated LPs by test_torch_pdlp.py and
test_torch_warm_start.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.linear_programming as T  # noqa: E402
import cuopt_tpu.linear_programming as J  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402

torch.set_num_threads(1)


def ranged(L):
    """1 <= x + y <= 3, min x + 2y, x, y in [0, 5]: objective 1."""
    dm = L.DataModel()
    dm.set_csr_constraint_matrix([1.0, 1.0], [0, 1], [0, 2])
    dm.set_objective_coefficients([1.0, 2.0])
    dm.set_constraint_lower_bounds([1.0])
    dm.set_constraint_upper_bounds([3.0])
    dm.set_variable_lower_bounds([0.0, 0.0])
    dm.set_variable_upper_bounds([5.0, 5.0])
    return dm


def infeasible(L):
    """x >= 2 and x <= 1."""
    dm = L.DataModel()
    dm.set_csr_constraint_matrix([1.0, 1.0], [0, 0], [0, 1, 2])
    dm.set_objective_coefficients([1.0])
    dm.set_row_types("GL")
    dm.set_constraint_bounds([2.0, 1.0])
    return dm


def row_types(L):
    """min -x1 - 2 x2, x1 + x2 <= 4, x1 <= 3, x2 <= 2: objective -6."""
    dm = L.DataModel()
    dm.set_csr_constraint_matrix([1.0, 1.0], [0, 1], [0, 2])
    dm.set_objective_coefficients([-1.0, -2.0])
    dm.set_row_types("L")
    dm.set_constraint_bounds([4.0])
    dm.set_variable_lower_bounds([0.0, 0.0])
    dm.set_variable_upper_bounds([3.0, 2.0])
    return dm


def equality(L):
    """x + y = 3, x - y = 1, min x + y: x = 2, y = 1."""
    dm = L.DataModel()
    dm.set_csr_constraint_matrix([1.0, 1.0, 1.0, -1.0], [0, 1, 0, 1],
                                 [0, 2, 4])
    dm.set_objective_coefficients([1.0, 1.0])
    dm.set_row_types("EE")
    dm.set_constraint_bounds([3.0, 1.0])
    dm.set_variable_lower_bounds([-10.0, -10.0])
    dm.set_variable_upper_bounds([10.0, 10.0])
    return dm


CASES = {"ranged": (ranged, 1.0), "infeasible": (infeasible, None),
         "row-types": (row_types, -6.0), "equality": (equality, 3.0)}


def _settings(L):
    s = L.PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.detect_infeasibility = True
    s.iteration_limit = 20000
    s.log_to_console = False
    return s


@pytest.mark.parametrize("case", list(CASES))
def test_small_lp_matches(case):
    build, want = CASES[case]
    a = T.Solve(build(T), _settings(T), device="cpu")
    b = J.Solve(build(J), _settings(J))
    assert a.get_termination_status() == b.get_termination_status()
    if want is None:
        assert a.get_termination_status() == \
            C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
        return
    assert a.get_termination_status() == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    np.testing.assert_allclose(a.get_primal_objective(),
                               b.get_primal_objective(), rtol=1e-6)
    assert abs(a.get_primal_objective() - want) <= 0.01 * abs(want)
    x = a.get_primal_solution()
    np.testing.assert_allclose(x, b.get_primal_solution(), atol=1e-6)
    if case == "equality":
        np.testing.assert_allclose(x, [2.0, 1.0], atol=1e-2)
    # the solution object (tests/test_lp_solver.py:215-235)
    n_rows = len(b.get_dual_solution())
    assert a.get_dual_solution().shape == (n_rows,)
    assert a.get_reduced_costs().shape == (2,)
    assert list(a.get_vars()) == list(b.get_vars())
