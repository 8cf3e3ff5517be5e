"""cuopt_torch stands alone: it imports neither JAX nor cuopt_tpu.

Importing cuopt_tpu loads JAX and turns on jax_enable_x64 for the whole
process (cuopt_tpu/__init__.py), so the port keeps its own copies of what
it needs. Only the tests import both packages.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "flax", "cuopt_tpu")
# installed here but not on the machine with the card: cuopt_tpu's server
# and clients use them, the port's use the standard library
_NOT_ON_THE_CARD = ("aiohttp", "pydantic", "msgpack", "requests", "pandas")


def _benches():
    """The port's measuring code: bench_torch.py and scripts/torch_*.py."""
    return [ROOT / "bench_torch.py",
            *sorted((ROOT / "scripts").glob("torch_*.py"))]


def _sources():
    files = sorted((ROOT / "cuopt_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files + _benches()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_or_cuopt_tpu_imports():
    files = _sources()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m and m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_benches_import_no_reference_script():
    """The port's benches import the standard library, torch, numpy,
    cuopt_torch and each other, never bench.py or a reference script
    under scripts/ (whose helpers they copy)."""
    benches = _benches()
    assert len(benches) >= 11
    ours = {p.stem for p in benches}
    reference = {p.stem for p in (ROOT / "scripts").glob("*.py")} - ours
    assert "bks_benchmark" in reference
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                               "cuopt_torch"} | ours
    bad = [(f.name, m) for f in benches for m in _imported_modules(f)
           if m and (m.split(".")[0] not in allowed
                     or m.split(".")[-1] in reference | {"bench"})]
    assert not bad, bad


def test_no_package_the_card_lacks_is_imported():
    bad = [(str(f.relative_to(ROOT)), m) for f in _sources()
           for m in _imported_modules(f)
           if m and m.split(".")[0] in _NOT_ON_THE_CARD]
    assert not bad, bad


def test_surface_modules_stand_alone():
    """Every module of cuopt_tpu's surface has its counterpart, and
    importing all of them loads neither JAX nor a package the card
    lacks."""
    surface = ["io/mps_parser.py", "io/native_mps.py", "io/__init__.py",
               "lp/settings.py", "linear_programming/__init__.py",
               "cli.py", "c_api.py", "c_api_embed.py",
               "server/data_definition.py", "server/result_store.py",
               "server/solver.py", "server/worker.py",
               "server/job_queue.py", "server/webserver.py",
               "server/__main__.py", "clients/self_hosted.py",
               "clients/cuopt_sh.py", "clients/__init__.py"]
    for rel in surface:
        assert (ROOT / "cuopt_tpu" / rel).exists(), rel
        assert (ROOT / "cuopt_torch" / rel).exists(), rel
    modules = [("cuopt_torch." + r[:-3].replace("/", ".")).removesuffix(
        ".__init__") for r in surface]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        f"       {_FORBIDDEN + _NOT_ON_THE_CARD!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_multi_device_modules_stand_alone():
    """cuopt_tpu's multi-device modules have their counterparts, which
    import nothing but torch, numpy, the standard library and the port
    itself; importing them loads neither JAX nor cuopt_tpu."""
    modules = ["parallel/__init__.py", "parallel/sharding.py",
               "routing/islands.py"]
    for rel in modules:
        assert (ROOT / "cuopt_tpu" / rel).exists(), rel
        assert (ROOT / "cuopt_torch" / rel).exists(), rel
    ours = modules + ["parallel/dryrun.py"]
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                               "cuopt_torch"}
    bad = [(rel, m) for rel in ours
           for m in _imported_modules(ROOT / "cuopt_torch" / rel)
           if m and m.split(".")[0] not in allowed]
    assert not bad, bad
    names = [("cuopt_torch." + r[:-3].replace("/", ".")).removesuffix(
        ".__init__") for r in ours]
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        f"       {_FORBIDDEN + _NOT_ON_THE_CARD!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_client_and_service_front_load_no_torch():
    """The thin client and the service's front process solve nothing:
    importing them loads no torch (the workers do)."""
    code = (
        "import sys\n"
        "import cuopt_torch.clients.cuopt_sh\n"
        "import cuopt_torch.server.__main__\n"
        "import cuopt_torch.server.webserver\n"
        "assert 'torch' not in sys.modules\n"
        "from cuopt_torch import solve_mip\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cpu_solve_loads_no_jax():
    code = (
        "import sys\n"
        "import cuopt_torch\n"
        "from cuopt_torch.lp.settings import PDLPSolverSettings\n"
        "from cuopt_torch.lp.solve import solve_lp\n"
        "from cuopt_torch.problem.synthetic import generate_lp\n"
        "s = PDLPSolverSettings(); s.log_to_console = False\n"
        "sol = solve_lp(generate_lp(200, 200, 5, seed=3, band=64), s,\n"
        "               device='cpu')\n"
        "assert sol.get_termination_reason() == 'Optimal'\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cuopt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_default_device_is_cuda():
    """Without a card, a solve that does not ask for the CPU raises: no
    silent fallback."""
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.problem.synthetic import generate_lp

    from cuopt_torch import batch_solve, solve_mip
    from cuopt_torch.lp.settings import MIPSolverSettings

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    s = PDLPSolverSettings()
    s.log_to_console = False
    with pytest.raises((RuntimeError, AssertionError)):
        solve_lp(generate_lp(64, 64, 4, seed=3), s)
    with pytest.raises((RuntimeError, AssertionError)):
        batch_solve([generate_lp(64, 64, 4, seed=k) for k in (3, 4)], s)
    # a MIP the host alone could solve (presolve fixes every variable)
    p = generate_lp(8, 8, 2, seed=3)
    p.variable_types[:] = "I"
    p.variable_upper_bounds[:] = 0.0
    ms = MIPSolverSettings()
    ms.log_to_console = False
    with pytest.raises((RuntimeError, AssertionError)):
        solve_mip(p, ms)
    # a 5-order routing instance, which the host heuristics alone could
    # solve, and a waypoint graph
    from cuopt_torch.distance_engine import WaypointMatrix
    from cuopt_torch.routing import DataModel, Solve

    dm = DataModel(6, 2)
    dm.add_cost_matrix(np.ones((6, 6)) - np.eye(6))
    with pytest.raises(RuntimeError, match="CUDA card"):
        Solve(dm)
    with pytest.raises(RuntimeError, match="CUDA card"):
        WaypointMatrix([0, 1, 2], [1, 0], [1.0, 1.0])


def test_cpu_routing_solve_loads_no_jax_or_pandas():
    """A routing solve on the CPU imports neither JAX, cuopt_tpu nor
    pandas (the machine with the card has no pandas): the answer is a
    RouteTable of numpy columns."""
    code = (
        "import sys\n"
        "from cuopt_torch.io.vrp import solution_cost, synth_gh_instance\n"
        "from cuopt_torch.routing import Solve, SolverSettings\n"
        "inst = synth_gh_instance(30, 'C', seed=1)\n"
        "s = SolverSettings(); s.set_time_limit(2.0)\n"
        "sol = Solve(inst.to_data_model(), s, device='cpu')\n"
        "assert sol.get_status() == 0, sol.get_message()\n"
        "assert solution_cost(inst, sol)[0] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'cuopt_tpu', 'pandas')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
