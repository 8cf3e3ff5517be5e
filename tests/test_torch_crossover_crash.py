"""Crossover from a float32 PDLP point whose crash basis fails to
factorize within the shared simplex source's 8 rank-repair attempts
(cpp/dual_simplex/simplex.cpp Refactorize :676-725): Solve then returns
before x_B exists and reads it (:99 -> Finish :885), which kills the
process. The port builds a copy of simplex.cpp
(cuopt_torch/kernels/build.py SIMPLEX_PATCHES) whose rank repair makes
up to 16 attempts, so its crossover reaches the vertex; and whose exits
before x_B exists return NUMERICAL with zero vectors, which a build with
the source's 8 attempts still reaches.

The point is the first of scripts/torch_crossover_crashes.py's samples:
the 2k staircase, float32, tolerance 1e-4, seeded start 1."""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_simplex_exits as exits
from cuopt_torch import constants as C
from cuopt_torch.dual_simplex.crossover import crossover
from cuopt_torch.kernels import build
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solve import solve_lp
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.utils.timer import Timer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2000


def _settings(crossover_flag=False):
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.dtype = "float32"
    s.method = C.CUOPT_METHOD_PDLP
    s.operator_kind = "blockband"
    s.crossover = crossover_flag
    s.set_optimality_tolerance(1e-4)
    s.initial_primal_solution = np.random.default_rng(1).uniform(
        0.0, 1e-3, N)
    return s


@pytest.fixture(scope="module")
def point(tmp_path_factory):
    prob = generate_lp(N, N, 8, seed=123, band=256)
    raw = PdlpSolver(prob, _settings(), "cpu").run()
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    path = tmp_path_factory.mktemp("point") / "point.npz"
    np.savez(path, x=raw["primal_solution"], y=raw["dual_solution"])
    return prob, raw, path


_CROSS = textwrap.dedent("""
    import sys
    import numpy as np
    z = np.load(sys.argv[2])
    if sys.argv[1] == "cuopt_tpu":
        from cuopt_tpu.dual_simplex.bindings import solve_lp_simplex
        from cuopt_tpu.lp.settings import PDLPSolverSettings
        from cuopt_tpu.problem.synthetic import generate_lp
        from cuopt_tpu.utils.timer import Timer
    else:  # the port's library, built without some of its patches
        from cuopt_torch.kernels import build
        build.SIMPLEX_PATCHES = () if sys.argv[1] == "unpatched" else \
            tuple(p for p in build.SIMPLEX_PATCHES
                  if not p[0].lstrip().startswith("for (int attempt"))
        build.BUILD_DIR = build.Path(sys.argv[3])
        from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
        from cuopt_torch.lp.settings import PDLPSolverSettings
        from cuopt_torch.problem.synthetic import generate_lp
        from cuopt_torch.utils.timer import Timer
    prob = generate_lp(2000, 2000, 8, seed=123, band=256)
    raw = solve_lp_simplex(prob, PDLPSolverSettings(), Timer(60),
                           x_hint=z["x"], y_hint=z["y"], want_vstat=True)
    print("status", raw["status"])
""")


@pytest.mark.parametrize("library", ["cuopt_tpu", "unpatched"])
def test_the_shared_source_crashes(point, library, tmp_path):
    """cuopt_tpu's library, and the port's built without the patches,
    die by SIGSEGV on this point (each in a process of its own)."""
    _, _, path = point
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", _CROSS, library, str(path),
                        str(tmp_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGSEGV, (r.returncode, r.stdout,
                                             r.stderr[-2000:])


def test_with_eight_attempts_the_port_returns_numerical(point, tmp_path):
    """The port built with SIMPLEX_PATCHES but the source's 8 rank-repair
    attempts: the basis still fails, and the simplex returns
    NUMERICAL_ERROR instead of crashing (FinishUnfactored)."""
    _, _, path = point
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", _CROSS, "eight-attempts",
                        str(path), str(tmp_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
    assert r.stdout.split()[-2:] == [
        "status", str(C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR)]


def test_the_ports_crossover_reaches_the_vertex(point):
    """In this process the crossover reaches HiGHS's optimum,
    118.88362819361583, within 1e-9: in the simplex, and end to end as
    `--crossover true` reaches it."""
    prob, raw, _ = point
    assert build.SIMPLEX_PATCHES
    status, highs = exits.highs(prob)
    assert status == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert abs(highs - 118.88362819361583) <= 1e-9 * highs
    got = crossover(prob, dict(raw), _settings(), Timer(60))
    assert got["solved_by"] == "pdlp+crossover"
    assert "crossover_status" not in got
    assert abs(got["primal_objective"] - highs) <= 1e-9 * abs(highs)
    sol = solve_lp(prob, _settings(crossover_flag=True), device="cpu")
    assert sol.get_termination_reason() == "Optimal"
    info = sol.get_additional_termination_information()
    assert info["solved_by"] == "pdlp+crossover"
    assert info["crossover_iterations"] == got["crossover_iterations"]
    assert abs(sol.get_primal_objective() - highs) <= 1e-9 * abs(highs)
