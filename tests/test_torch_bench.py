"""bench_torch.py against bench.py, on the CPU.

- The shuffled instance: bench_torch's CSR arrays and vectors equal, bit
  for bit, those bench.py builds (its lines 174-192, with cuopt_tpu's
  generate_lp and permute_csr) at the bench's own n = 50,000.
- One instance's majors: bench_torch's Instance (build, WARMUP_MAJORS,
  one window of BENCH_MAJORS) and bench.py's _bench_instance take the
  same steps over their majors and read the same slab bytes per step,
  compared exactly (integers: tighter than the 1e-8 of
  test_torch_pdlp::test_major_iterations_match). n = 4,096 is the
  smallest power of two at which operator "auto" builds the block band
  both benches measure: at n = 2,048 (n * n = 2^22) it builds the dense
  operator, on which bench.py's _bench_instance raises AttributeError
  (a DenseOp has no row_slabs) and bench_torch says why it stops.
- The JSON line: bench_torch's metric name and unit are bench.py's, and
  the whole script runs on the CPU (--device cpu) with exit code 0.

Importing bench.py sets JAX_COMPILATION_CACHE_DIR and two more variables
(bench.py:50-53): the fixture restores os.environ after it.
"""

import ast
import dataclasses
import importlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

N_BENCH = 50_000
N_SMALL = 4096


@pytest.fixture
def bench_py():
    saved = dict(os.environ)
    try:
        yield importlib.import_module("bench")
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _reference_shuffled(n):
    """bench.py:174-192 with cuopt_tpu, line for line."""
    from cuopt_tpu.problem.synthetic import generate_lp
    from cuopt_tpu.sparse.reorder import permute_csr

    prob = generate_lp(n, n, 8, seed=123, band=256)
    rng = np.random.default_rng(7)
    rp, cp = rng.permutation(n), rng.permutation(n)
    offs, idx, vals = permute_csr(
        np.asarray(prob.offsets), np.asarray(prob.indices),
        np.asarray(prob.values, np.float64), rp, cp, n, n,
    )
    return dataclasses.replace(
        prob, offsets=offs, indices=idx, values=vals,
        constraint_lower_bounds=prob.constraint_lower_bounds[rp],
        constraint_upper_bounds=prob.constraint_upper_bounds[rp],
        objective_coefficients=prob.objective_coefficients[cp],
        variable_lower_bounds=prob.variable_lower_bounds[cp],
        variable_upper_bounds=prob.variable_upper_bounds[cp],
    )


def test_shuffled_instance_equals_bench_py():
    ref = _reference_shuffled(N_BENCH)
    ours = bench_torch.shuffled(bench_torch.staircase(N_BENCH))
    for field in ("offsets", "indices", "values", "constraint_lower_bounds",
                  "constraint_upper_bounds", "objective_coefficients",
                  "variable_lower_bounds", "variable_upper_bounds"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _reference_cfg():
    from cuopt_tpu.lp.hyper_params import PRESETS
    from cuopt_tpu.lp.pdlp import StaticCfg
    from cuopt_tpu.lp.settings import PDLPSolverSettings

    settings = PDLPSolverSettings()
    hp = PRESETS[settings.pdlp_solver_mode]
    t = settings.tolerances
    return StaticCfg(
        hp=hp,
        abs_primal=t.absolute_primal_tolerance,
        rel_primal=t.relative_primal_tolerance,
        abs_dual=t.absolute_dual_tolerance,
        rel_dual=t.relative_dual_tolerance,
        abs_gap=t.absolute_gap_tolerance,
        rel_gap=t.relative_gap_tolerance,
    ), hp


@pytest.mark.parametrize("which", ["staircase", "shuffled"])
def test_instance_majors_match_bench_py(bench_py, which):
    from cuopt_tpu.problem.synthetic import generate_lp

    j_prob = generate_lp(N_SMALL, N_SMALL, 8, seed=123, band=256)
    t_prob = bench_torch.staircase(N_SMALL)
    if which == "shuffled":
        j_prob = _reference_shuffled(N_SMALL)
        t_prob = bench_torch.shuffled(t_prob)
    assert (bench_py.WARMUP_MAJORS, bench_py.BENCH_MAJORS) == \
        (bench_torch.WARMUP_MAJORS, bench_torch.BENCH_MAJORS)
    cfg, hp = _reference_cfg()
    _, j_bytes, j_steps, _ = bench_py._bench_instance(j_prob, cfg, hp,
                                                      "auto")
    t_cfg, t_hp = bench_torch.static_cfg()
    inst = bench_torch.Instance(t_prob, t_cfg, t_hp, "cpu")
    _, t_steps, _ = inst.window()
    assert inst.slab_bytes == j_bytes
    assert t_steps == j_steps
    assert t_steps == bench_torch.BENCH_MAJORS * t_hp.major_iteration
    assert inst.dev.op.row_slabs.dtype == torch.float32


def test_dense_size_is_refused_by_both(bench_py, monkeypatch):
    from cuopt_tpu.problem.synthetic import generate_lp

    cfg, hp = _reference_cfg()
    # bench.py reads the slabs after its majors: one of each is enough
    monkeypatch.setattr(bench_py, "WARMUP_MAJORS", 1)
    monkeypatch.setattr(bench_py, "BENCH_MAJORS", 1)
    with pytest.raises(AttributeError, match="row_slabs"):
        bench_py._bench_instance(generate_lp(2048, 2048, 8, seed=123,
                                             band=256), cfg, hp, "auto")
    t_cfg, t_hp = bench_torch.static_cfg()
    with pytest.raises(RuntimeError, match="DenseOp"):
        bench_torch.Instance(bench_torch.staircase(2048), t_cfg, t_hp,
                             "cpu")


def _reference_line_keys():
    """The "metric" and "unit" of the dict bench.py prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "metric" in keys and "unit" in keys:
                vals = dict(zip(keys, node.values))
                return vals["metric"].value, vals["unit"].value
    raise AssertionError("bench.py prints no metric")


def test_json_line_names_bench_py_metric(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_torch, "BENCH_MAJORS", 4)
    out = tmp_path / "bench.json"
    rc = bench_torch.main(["--device", "cpu", "--n", str(N_SMALL),
                           "--repeats", "3", "--out", str(out)])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert (line["metric"], line["unit"]) == _reference_line_keys()
    assert json.loads(out.read_text()) == line
    d = line["detail"]
    assert d["device"] == "cpu" and line["vs_baseline"] is None
    assert len(d["geomean_runs"]) == 3
    assert line["value"] == pytest.approx(float(np.median(d["geomean_runs"])),
                                          abs=0.01)
    # on the CPU the pass takes its plain version: no kernel launch
    assert d["launches"]["staircase"] == {"row_pass_atomic": 0,
                                          "row_pass_partials": 0}
    assert d["slab_bytes_per_iter"] == d["shuffled_slab_bytes_per_iter"]
