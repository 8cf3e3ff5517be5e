"""Every ported bench under scripts/torch_*.py, at a small size on the CPU.

Each script's main(argv) runs in this process with --device cpu and its
artifact under tmp_path (the working directory too): it must return 0,
print a JSON object as its last line, write that artifact and nothing
in the repository, and pass its own checks (routes rechecked on the
host, MIP points rechecked on the host, the cross-check). Where the
reference script's solve runs on the CPU, cuopt_tpu solves the same
instance with the reference's settings and must reach the same status
and an objective within 1e-3 relative: the concurrent race on
staircase-500 and the structured family set-cover at scale 2,000.
"""

import importlib.util
import json
import math
import os
import pathlib

import pytest

jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
OBJ_RTOL = 1e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_state():
    """Names and modification times of the files where a script could
    write by default: the repository root and scripts/."""
    return {p.name: p.stat().st_mtime_ns for d in (ROOT, SCRIPTS)
            for p in d.iterdir() if p.is_file()}


def _write_mps_dir(path):
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_surface_instances import write_mps

    from cuopt_torch.problem.synthetic import generate_lp

    path.mkdir()
    for n in (120, 200):
        (path / f"staircase-{n}.mps").write_text(
            write_mps(generate_lp(n, n, 6, seed=123, band=32)))
    return path


def _j_concurrent(name):
    """The reference script's race (concurrent_lp_bench.py) of one of the
    port's cases, by cuopt_tpu."""
    from cuopt_tpu import constants as C
    from cuopt_tpu.lp.settings import PDLPSolverSettings
    from cuopt_tpu.lp.solve import solve_lp
    from cuopt_tpu.problem.synthetic import generate_lp

    n = {"staircase-500": 500}[name]
    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_CONCURRENT
    s.time_limit = 60
    s.set_optimality_tolerance(1e-4)
    sol = solve_lp(generate_lp(n, n, 8, seed=123, band=256), s)
    return int(sol.get_termination_status()), \
        float(sol.get_primal_objective())


def _j_structured(family, scale):
    """lp_structured_bench.py's solve of one family, by cuopt_tpu."""
    from cuopt_tpu import constants as C
    from cuopt_tpu.lp.settings import PDLPSolverSettings
    from cuopt_tpu.lp.solve import solve_lp
    from cuopt_tpu.problem.mittelmann import GENERATORS

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_CONCURRENT
    s.set_optimality_tolerance(1e-4)
    s.time_limit = 60
    s.dtype = "float32"
    raw = solve_lp(GENERATORS[family](scale, 0), s)._raw
    return int(raw["status"]), float(raw["primal_objective"])


def _close(a, b):
    return abs(a - b) <= OBJ_RTOL * max(1.0, abs(b))


def check_bks(line, art):
    assert line["solved"] == line["total"] == 2
    for r in art["results"]:
        assert r["status"] == 0 and r["host_check"]["ok"], r


def check_routing_tpu(line, art):
    assert line["host_ok"] and line["ls_rounds_timed"] >= 1
    assert line["cost_after_ls"] <= line["construction_cost"]
    assert all(r["eval_device_ms"] is None for r in line["rounds"])


def check_routing_scale(line, art):
    assert line["status"] == 0 and line["host_check"]["ok"]


def check_mip(line, art):
    assert line["host_check_failed"] == [] and line["instances"] == 3
    by = {r["instance"]: r for r in art["results"]}
    assert by["knapsack"]["objective"] == -14.0
    assert by["twelve-binaries"]["objective"] == -82.0
    for r in art["results"]:
        assert r["host_ok"] is True, r
        assert "callback_first_incumbent_s" in r


def check_concurrent(line, art):
    (r,) = art["results"]
    status, obj = _j_concurrent(r["instance"])
    assert r["status"] == status == 1
    assert _close(r["objective"], obj), (r["objective"], obj)


def check_structured(line, art):
    (r,) = art["results"]
    assert r["cross_check"]["agree"]
    status, obj = _j_structured(r["family"], 2000)
    assert r["status"] == status == 1
    assert _close(r["objective"], obj), (r["objective"], obj)


def check_large(line, art):
    for k in ("banded", "shuffled"):
        for when in ("cold", "warm"):
            assert line[k][when]["status"] == 1 and line[k][when]["finite"]
        assert line[k]["operator"] == "BlockBandOp"
    assert _close(line["banded"]["warm"]["objective"],
                  line["shuffled"]["warm"]["objective"])


def check_weak(line, art):
    assert [r["devices"] for r in line["table"]] == [1, 2, 4]
    assert line["kind"] == "validation"
    assert all(r["steps"] > 0 for r in line["table"])
    assert line["table"][1]["bytes_per_attempt"] > 0


def check_benchmark_lp(line, art):
    assert line["instances"] == line["solved_optimal"] == 2


CASES = {
    "torch_bks_benchmark": (
        ["--instances", "GHC_30_1,GHRC_40_3", "--time-limit", "1"],
        check_bks),
    "torch_routing_tpu_bench": (
        ["--orders", "60", "--ls-rounds", "3"], check_routing_tpu),
    "torch_routing_scale_bench": (
        ["--orders", "60", "--time-limit", "1"], check_routing_scale),
    "torch_mip_benchmark": (
        ["--instances", "knapsack,twelve-binaries,staircase-mip-150",
         "--time-limit", "2"], check_mip),
    "torch_concurrent_lp_bench": (
        ["--cases", "staircase-500", "--time-limit", "60"],
        check_concurrent),
    "torch_lp_structured_bench": (
        ["--families", "set-cover", "--scale", "2000", "--check-scale",
         "400"], check_structured),
    "torch_large_lp_bench": (
        ["--rows", "3000", "--nnz", "8"], check_large),
    "torch_weak_scaling": (
        ["--virtual", "4", "--rows-per-dev", "512", "--majors", "1"],
        check_weak),
    "torch_benchmark_lp": (["--time-limit", "60"], check_benchmark_lp),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_script_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    argv, check = CASES[name]
    if name == "torch_benchmark_lp":
        argv = argv + ["--dir", str(_write_mps_dir(tmp_path / "mps"))]
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    out = work / "artifact.json"
    before = _tree_state()
    rc = _load(name).main(argv + ["--device", "cpu", "--out", str(out)])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert line["device"] == "cpu"
    assert _tree_state() == before
    assert sorted(os.listdir(work)) == ["artifact.json"]
    art = json.loads(out.read_text())
    summary = {k: v for k, v in art.items() if k != "results"}
    assert summary == line
    assert not any(isinstance(v, float) and not math.isfinite(v)
                   for v in line.values() if v is not None)
    check(line, art)


def test_every_ported_bench_is_tested():
    """The ten ported benches: the nine here and bench_torch.py
    (tests/test_torch_bench.py)."""
    reference = {"benchmark_lp", "bks_benchmark", "concurrent_lp_bench",
                 "large_lp_bench", "lp_structured_bench", "mip_benchmark",
                 "routing_scale_bench", "routing_tpu_bench", "weak_scaling"}
    assert {p.stem for p in SCRIPTS.glob("*.py")
            if not p.stem.startswith("torch_")} == reference
    assert set(CASES) == {f"torch_{r}" for r in reference}
    assert (ROOT / "bench_torch.py").exists()
