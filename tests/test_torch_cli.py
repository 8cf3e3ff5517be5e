"""cuopt_torch's CLI against cuopt_tpu's, both run as processes on the same
MPS files (written here from seeded generators): the same printed Status
and Objective (to 1e-6 relative), the same exit codes and the same flags.
cuopt_tpu's runs under JAX_PLATFORMS=cpu, the port's under
CUOPT_TORCH_DEVICE=cpu; without that variable the port's CLI solves on the
card, and with none it refuses. Each pair of processes runs side by side,
each with its own deadline.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuopt_torch import constants as C
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.problem.synthetic import generate_lp
from torch_mip_instances import twelve_binaries
from torch_surface_instances import staircase, write_mps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DEADLINE = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "lp.mps").write_text(write_mps(staircase(generate_lp), "S200"))
    (d / "mip.mps").write_text(write_mps(twelve_binaries(OptimizationProblem),
                                         "TWELVE"))
    (d / "bad.mps").write_text("NAME B\nROWS\n N obj\nCOLUMNS\n"
                               "    x obj 1.2.3\nENDATA\n")
    # an initial solution in .sol form: names and values, comments skipped
    (d / "start.sol").write_text("# Status: Optimal\nC0 0.5\nC1 1\n")
    return d


def _env(package, device="cpu"):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    env.pop("CUOPT_TORCH_DEVICE", None)
    if package == "cuopt_tpu":
        env["JAX_PLATFORMS"] = "cpu"
    elif device is not None:
        env["CUOPT_TORCH_DEVICE"] = device
    return env


def run_both(args, cwd, extra=None):
    """Both CLIs on `args` (and each on its `extra[package]` arguments),
    side by side: {package: CompletedProcess}."""
    extra = extra or {}
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli", *args,
             *extra.get(pkg, ())], cwd=cwd,
            env=_env(pkg), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pkg in ("cuopt_tpu", "cuopt_torch")}
    out = {}
    for pkg, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        out[pkg] = subprocess.CompletedProcess(p.args, p.returncode,
                                               stdout, stderr)
    return out


def _line(stdout, key):
    m = re.search(rf"^{key}:\s+(\S+)", stdout, re.M)
    assert m, (key, stdout)
    return m.group(1)


@pytest.mark.parametrize("case,args,want_status,want_obj", [
    ("lp-dual-simplex", ["lp.mps", "--method", "2"], "Optimal", None),
    ("mip-defaults", ["mip.mps"], "Optimal", -82.0),
    ("mip-relaxation", ["mip.mps", "--relaxation", "--method", "2"],
     "Optimal", None),
    ("initial-solution", ["lp.mps", "--method", "2",
                          "--initial-solution", "start.sol"],
     "Optimal", None),
])
def test_solve_lines_equal(files, case, args, want_status, want_obj):
    runs = run_both([*args, "--log_to_console", "false"], files)
    tpu, port = runs["cuopt_tpu"], runs["cuopt_torch"]
    assert tpu.returncode == 0, tpu.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert _line(port.stdout, "Status") == _line(tpu.stdout, "Status") \
        == want_status
    obj_t = float(_line(tpu.stdout, "Objective"))
    obj_p = float(_line(port.stdout, "Objective"))
    assert math.isclose(obj_p, obj_t, rel_tol=1e-6, abs_tol=1e-9)
    if want_obj is not None:
        assert obj_p == want_obj
    if case == "mip-relaxation":
        assert obj_p < -82.0  # the relaxation's bound is below the MIP's


def test_solution_file(files, tmp_path):
    """--solution_file (a registry flag) writes the same .sol."""
    runs = run_both(
        ["lp.mps", "--method", "2", "--log_to_console", "false"], files,
        {pkg: ["--solution_file", str(tmp_path / f"{pkg}.sol")]
         for pkg in ("cuopt_tpu", "cuopt_torch")})
    for r in runs.values():
        assert r.returncode == 0, r.stderr[-2000:]
    want = (tmp_path / "cuopt_tpu.sol").read_text().splitlines()
    got = (tmp_path / "cuopt_torch.sol").read_text().splitlines()
    assert len(got) == len(want) == 2 + 200
    assert got[0] == want[0] == "# Status: Optimal"
    for g, w in zip(got[2:], want[2:]):
        name_g, v_g = g.split()
        name_w, v_w = w.split()
        assert name_g == name_w
        assert math.isclose(float(v_g), float(v_w), rel_tol=1e-9,
                            abs_tol=1e-9)


@pytest.mark.parametrize("case,args,code", [
    ("missing-file", ["nope.mps"], C.CUOPT_MPS_FILE_ERROR),
    ("unparsable-file", ["bad.mps"], C.CUOPT_MPS_FILE_ERROR),
    ("unknown-flag", ["lp.mps", "--not-a-flag"], 2),  # argparse
    ("bad-boolean", ["lp.mps", "--crossover", "maybe"], 1),  # raised
])
def test_exit_codes_equal(files, case, args, code):
    runs = run_both(args, files)
    assert runs["cuopt_torch"].returncode == runs["cuopt_tpu"].returncode \
        == code
    assert "Status" not in runs["cuopt_torch"].stdout


def test_help_lists_the_same_flags(files):
    runs = run_both(["--help"], files)

    def flags(text):
        return sorted(set(re.findall(r"--[\w-]+", text)))

    assert runs["cuopt_torch"].returncode == 0
    assert flags(runs["cuopt_torch"].stdout) == \
        flags(runs["cuopt_tpu"].stdout)
    assert "--initial-solution" in runs["cuopt_torch"].stdout


def test_without_a_card_the_cli_refuses(files):
    """CUOPT_TORCH_DEVICE unset means the card: on this machine, which
    has none, the solve raises; any other value than cuda or cpu
    raises too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for device, message in ((None, "CUDA"),
                            ("gpu", "CUOPT_TORCH_DEVICE='gpu'")):
        r = subprocess.run(
            [sys.executable, "-m", "cuopt_torch.cli", "lp.mps", "--method",
             "2"], cwd=files, env=_env("cuopt_torch", device),
            capture_output=True, text=True, timeout=DEADLINE)
        assert r.returncode != 0
        assert "Status" not in r.stdout
        assert message in r.stderr
