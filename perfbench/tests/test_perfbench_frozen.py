"""The frozen LPs equal the program's generator today, and nothing a run
loads is JAX or the JAX package; the reference loads nothing of the
program."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness, lpgen

ROOT = harness.ROOT


@pytest.mark.parametrize("n,seed", [(3000, 0), (4096, 123), (2500, 2**40)])
def test_staircase_equals_generate_lp(n, seed):
    from cuopt_torch.problem.synthetic import generate_lp

    p = generate_lp(n, n, 8, seed=seed, band=256)
    lp = lpgen.staircase(n, n, 8, 256, seed)
    for key, want in (("offsets", p.offsets), ("indices", p.indices),
                      ("values", p.values), ("c", p.objective_coefficients),
                      ("lc", p.constraint_lower_bounds),
                      ("uc", p.constraint_upper_bounds),
                      ("lv", p.variable_lower_bounds),
                      ("uv", p.variable_upper_bounds)):
        assert np.array_equal(lp[key], np.asarray(want)), key


def test_shuffle_equals_the_program_recipe():
    from cuopt_torch.sparse.reorder import permute_csr

    lp = lpgen.staircase(3000, 3000, 8, 256, 9)
    got = lpgen.shuffle(lp, np.random.default_rng(7))
    rng = np.random.default_rng(7)
    rp, cp = rng.permutation(3000), rng.permutation(3000)
    offs, idx, vals = permute_csr(lp["offsets"], lp["indices"],
                                  lp["values"], rp, cp, 3000, 3000)
    assert np.array_equal(got["offsets"], offs)
    assert np.array_equal(got["indices"], idx)
    assert np.array_equal(got["values"], vals)
    assert np.array_equal(got["c"], lp["c"][cp])
    assert np.array_equal(got["uc"], lp["uc"][rp])


TESTS = os.path.dirname(os.path.abspath(__file__))
RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {tests!r}]
t = time.perf_counter()
from perfbench import harness
from cpu_card import small_runs
small_runs(harness)
rc = harness.run({cell!r}, 5, 0.5, {traced}, t)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


@pytest.mark.parametrize("cell,traced", [("stair50k.shuffled", False),
                                         ("stair50k.ordered", True)])
def test_a_run_loads_no_jax(cell, traced):
    r = subprocess.run([sys.executable, "-c",
                        RUN.format(root=ROOT, tests=TESTS, cell=cell,
                                   traced=traced)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUOPT_TORCH_DEVICE="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    mods = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "cuopt_torch" in mods and "perfbench" in mods
    assert not mods & set(harness.FORBIDDEN)
    assert json.loads(r.stdout.strip().splitlines()[-2])["correct"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "perfbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "numpy", "perfbench"}, (f, tops)
    r = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {ROOT!r}); "
         "import perfbench.reference.kkt; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, timeout=120, check=True)
    mods = set(ast.literal_eval(r.stdout.strip()))
    assert not mods & {"cuopt_torch", "cuopt_tpu", "jax", "torch"}


def test_no_source_under_perfbench_imports_jax():
    for d, _, files in os.walk(os.path.join(ROOT, "perfbench")):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(d, f))}
                assert not tops & set(harness.FORBIDDEN), (f, tops)
