"""A sharded PDLP solve, the port's against cuopt_tpu's, on the CPU (8
shards against cuopt_tpu's 8-device mesh; the size and tolerance of
cuopt_tpu's tests/test_multichip.py fullsolve)."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_helpers import run_tpu, serve  # noqa: E402

from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.lp.pdlp import PdlpSolver  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings  # noqa: E402
from cuopt_torch.parallel import make_mesh  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp  # noqa: E402

CPU8 = ["cpu"] * 8


# ------------------------------------------------------ cuopt_tpu's side
def tpu_full_solve():
    """cuopt_tpu's sharded solve of tests/test_multichip.py's fullsolve:
    majors on its 8-device mesh until OPTIMAL."""
    import jax.numpy as jnp

    from cuopt_tpu.lp.hyper_params import PRESETS
    from cuopt_tpu.lp.pdlp import (
        PdlpSolver as JSolver,
        build_device_problem,
        initial_state,
        make_major_fn,
    )
    from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings
    from cuopt_tpu.parallel import make_mesh as j_mesh
    from cuopt_tpu.parallel import shard_problem_and_state as j_shard
    from cuopt_tpu.problem.synthetic import generate_lp as j_generate

    prob = j_generate(2048, 2048, 6, seed=11, band=192)
    cfg = JSolver(prob, JSettings()).cfg
    hp = PRESETS[JSettings().pdlp_solver_mode]
    dev = build_device_problem(prob, hp, jnp.float64, "blockband")
    dev, state = j_shard(dev, initial_state(dev, hp, jnp.float64), j_mesh(8))
    fn = make_major_fn(cfg)
    for _ in range(200):
        state, report = fn(dev, state)
        if bool(report["opt_cur"]) or bool(report["opt_avg"]):
            break
    return dict(obj=np.asarray(report["info_cur"]["primal_obj"]),
                done=np.asarray(bool(report["opt_cur"])
                                or bool(report["opt_avg"])))



# ---------------------------------------------------------------- tests
def test_sharded_full_solve():
    """The 2048 block-band LP solved on 8 shards: OPTIMAL, within 5e-4 of
    cuopt_tpu's sharded solve (both stop somewhere in the 1e-4 ball)."""
    want = run_tpu(__file__, tpu_full_solve)
    assert bool(want["done"])
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.operator_kind = "blockband"
    prob = generate_lp(2048, 2048, 6, seed=11, band=192)
    raw = PdlpSolver(prob, s, "cpu", mesh=make_mesh(devices=CPU8)).run()
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    np.testing.assert_allclose(raw["primal_objective"], float(want["obj"]),
                               rtol=5e-4)
    assert raw["primal_solution"].shape == (2048,)
    # the answer is the problem's: its rows rechecked on the host
    act = np.zeros(2048)
    rows = np.repeat(np.arange(2048), np.diff(prob.offsets))
    np.add.at(act, rows, prob.values * raw["primal_solution"][prob.indices])
    viol = np.maximum(prob.constraint_lower_bounds - act,
                      act - prob.constraint_upper_bounds).clip(min=0)
    assert np.linalg.norm(viol) <= 1e-4 * (1 + np.linalg.norm(
        np.maximum(np.abs(prob.constraint_lower_bounds),
                   np.abs(prob.constraint_upper_bounds))))


def test_sharded_solve_runs_the_step_driver():
    """A solve on 8 CPU shards runs every shard's steps as the step
    driver's slots: one slot an attempt and a few count reads a major,
    the first shard's counts, as the unsharded solve reports them."""
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.operator_kind = "blockband"
    s.iteration_limit = 80
    prob = generate_lp(1024, 1024, 6, seed=11, band=192)
    raws = [PdlpSolver(prob, s, "cpu", mesh=mesh).run()
            for mesh in (make_mesh(devices=CPU8), None)]
    for raw in raws:
        assert raw["iterations"] == 80
        assert raw["graph_slots"] == raw["attempts"] >= 80
        assert 2 <= raw["graph_count_reads"] <= raw["attempts"]
    keys = ("attempts", "graph_slots", "graph_count_reads")
    assert [raws[0][k] for k in keys] == [raws[1][k] for k in keys]


if __name__ == "__main__":
    torch.set_num_threads(1)
    serve(globals())
