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
