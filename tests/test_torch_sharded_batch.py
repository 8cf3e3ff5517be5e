"""A sharded frontier batch, the port's against cuopt_tpu's, on the CPU (8
shards against cuopt_tpu's 8-device mesh; sizes and tolerances of
cuopt_tpu's tests/test_multichip.py)."""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_helpers import run_tpu, serve  # noqa: E402

from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.lp.batch import _pick_batch_kind, batch_solve  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings  # noqa: E402
from cuopt_torch.parallel import make_mesh  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp  # noqa: E402

CPU8 = ["cpu"] * 8


def _frontier(generate):
    """Six nodes of one LP: 8 upper bounds cut to 0.5 in each."""
    base = generate(2048, 2048, 6, seed=5, band=96)
    rng = np.random.default_rng(1)
    probs = []
    for _ in range(6):
        uv = base.variable_upper_bounds.copy()
        j = rng.integers(0, base.n_variables, 8)
        uv[j] = np.minimum(uv[j], 0.5)
        probs.append(dataclasses.replace(
            base, variable_lower_bounds=base.variable_lower_bounds.copy(),
            variable_upper_bounds=uv))
    return probs


# ------------------------------------------------------ cuopt_tpu's side
def tpu_frontier():
    from cuopt_tpu.lp.batch import batch_solve as j_batch
    from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings
    from cuopt_tpu.parallel import make_mesh as j_mesh
    from cuopt_tpu.problem.synthetic import generate_lp as j_generate

    s = JSettings()
    s.set_optimality_tolerance(1e-4)
    s.iteration_limit = 20000
    sols = j_batch(_frontier(j_generate), s, mesh=j_mesh(8))
    return dict(status=np.array([x.get_termination_status() for x in sols]),
                obj=np.array([x.get_primal_objective() for x in sols]))


# ---------------------------------------------------------------- tests
def test_sharded_frontier_batch():
    """Six node relaxations padded to eight members over 8 shards (the
    two duplicates solved and dropped): statuses equal to cuopt_tpu's
    batch_solve(mesh=), objectives within 1e-4."""
    probs = _frontier(generate_lp)
    assert _pick_batch_kind(probs) == "blockband"
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.set_optimality_tolerance(1e-4)
    s.iteration_limit = 20000
    got = batch_solve(probs, s, "cpu", mesh=make_mesh(devices=CPU8))
    want = run_tpu(__file__, tpu_frontier)
    assert len(got) == 6
    assert [x.get_termination_status() for x in got] == \
        [int(v) for v in want["status"]]
    for x, w in zip(got, want["obj"]):
        assert x.get_termination_status() == \
            C.CUOPT_TERIMINATION_STATUS_OPTIMAL
        assert abs(x.get_primal_objective() - w) <= 1e-4 * (1 + abs(w))
        assert x._raw["solved_by"] == "pdlp_batch"


if __name__ == "__main__":
    torch.set_num_threads(1)
    serve(globals())
