"""The float64 cell's readers (f64_pair_roofline, f64_steps_per_solve,
f64_loop_steps_per_s, f64_tail_s) and its yardstick: on a stair50k.f64
trace recorded on the card (data/stair50k_f64_trace.json.gz, written by
tests/record_f64_trace.py), where they must give what that run printed;
on small hand-built inputs; and in a traced run of the cell on the CPU
card at a small size. Also the float32 control's configuration and the
torch reference's imports."""

import ast
import gzip
import io
import json
import os
import time

import pytest
from cpu_card import CpuCard

from perfbench import control_f32, harness, trace, yardstick_f64

F64 = ("f64_pair_roofline", "f64_steps_per_solve", "f64_loop_steps_per_s",
       "f64_tail_s")
DATA = os.path.join(os.path.dirname(__file__), "data",
                    "stair50k_f64_trace.json.gz")


@pytest.fixture(scope="module")
def recorded():
    with gzip.open(DATA, "rt") as f:
        return json.load(f)


def _recorded_ctx(doc):
    tr = doc["trace"]
    return harness.Context(
        setup_s=0.0, trace=tr, solves=doc["solves"],
        window=trace.span_window(tr, harness.SOLVE_SPAN),
        profiled_shape=tuple(doc["profiled_shape"]),
        twin_wall=doc["twin_wall"])


@pytest.mark.parametrize("name", F64)
def test_readers_give_what_the_card_run_printed(recorded, name):
    got = harness.reader(name).read(_recorded_ctx(recorded))
    assert got == pytest.approx(recorded["metrics"][name], rel=1e-9)
    assert got > 0
    if name == "f64_pair_roofline":
        assert got < 100


def test_recorded_solve_ran_the_unfused_float64_pair(recorded):
    """No row-pass kernel ran in the profiled solve; the pair's batched
    double products did, two an attempt and two for the initial
    state."""
    ops = recorded["device_ops"]
    assert not [k for k in ops if "row_pass" in k]
    names = harness.reader("f64_pair_roofline").KERNEL_NAMES
    pair = [k for k in ops if any(n in k for n in names)]
    assert pair and all("double" in k for k in pair)
    attempts = recorded["solves"][-1]["raw"]["attempts"]
    assert sum(ops[k][0] for k in pair) == 2 * (attempts + 1)
    assert recorded["device"]["busy_s"] > 0


def test_tail_spans_once_a_major(recorded):
    ctx = _recorded_ctx(recorded)
    from perfbench import program_spans

    majors = len(program_spans.inside(ctx, "pdlp_pdhg_steps"))
    for name in ("pdlp_termination", "pdlp_restart"):
        assert len(program_spans.inside(ctx, name)) == majors > 100


def test_least_bytes_of_the_pair():
    # 12 B a nonzero, 16 B a column, 48 B a row: 8.0 MB at 50k
    assert yardstick_f64.pair_bytes(50_000, 50_000, 400_000) == 8_000_000
    assert yardstick_f64.pair_bytes(1, 0, 0) == 48
    assert yardstick_f64.pair_bytes(0, 1, 0) == 16
    assert yardstick_f64.pair_bytes(0, 0, 1) == 12


SMALL = {
    # [start, duration, name] in microseconds, as perfbench.trace has them
    "device": [
        [10, 4, "gemv2T_kernel_val<int, int, double, double, double, "
                "double, 128, 16, 4, 4, false, false>"],
        [20, 5, "gemv2T_kernel_val<int, int, double, double, double, "
                "double, 128, 16, 4, 4, false, false>"],
        [30, 2, "index_elementwise_kernel<128, 4>"],
        [40, 3, "gemv2T_kernel_val<int, int, float, float, float, "
                "float, 128, 16, 4, 4, false, false>"],
        [2000, 7, "gemv2T_kernel_val<int, int, double, double, double, "
                  "double, 128, 16, 4, 4, false, false>"]],
    "spans": [[0, 1000, harness.SOLVE_SPAN],
              [100, 30, "pdlp_termination"], [130, 20, "pdlp_restart"],
              [300, 40, "pdlp_termination"], [340, 10, "pdlp_restart"],
              [1500, 99, "pdlp_restart"]],
}


def _small_ctx(attempts=3, spans=None):
    tr = dict(SMALL, spans=SMALL["spans"] if spans is None else spans)
    return harness.Context(
        setup_s=0.0, trace=tr, window=(0.0, 1000.0),
        profiled_shape=(100, 200, 800), twin_wall=1e-3, solves=[
            {"wall": 1.0, "profiled": False, "raw": {
                "iterations": 6000, "attempts": 6010, "loop_steps": 5960,
                "solve_loop_s": 3.0}},
            {"wall": 2.0, "profiled": True, "raw": {
                "iterations": 5000, "attempts": attempts,
                "loop_steps": 4960, "solve_loop_s": 2.5}},
            {"wall": 1.5, "profiled": False, "raw": {
                "iterations": 5500, "attempts": 5510, "loop_steps": 5460,
                "solve_loop_s": 2.0}}])


def test_readers_by_hand():
    ctx = _small_ctx()
    r = harness.reader
    # 3 attempts of 12*800 + 16*200 + 48*100 bytes at 3.35 TB/s, over the
    # two double products inside the window (9 us); the float one, the
    # gather and the product after the window are not counted
    assert r("f64_pair_roofline").read(ctx) == pytest.approx(
        100 * 3 * 17600 / 3.35e12 / 9e-6)
    # the tail spans inside the window: 30 + 20 + 40 + 10 us
    assert r("f64_tail_s").read(ctx) == pytest.approx(100e-6)
    assert r("f64_steps_per_solve").read(ctx) == pytest.approx(5500)
    assert r("f64_loop_steps_per_s").read(ctx) == pytest.approx(
        (5960 + 5460) / 5.0)


def test_steps_readers_are_the_lp_ones():
    for f64, lp in (("f64_steps_per_solve", "lp_steps_per_solve"),
                    ("f64_loop_steps_per_s", "lp_loop_steps_per_s")):
        assert harness.reader(f64).read is harness.reader(lp).read


def test_readers_without_their_inputs_give_none():
    r = harness.reader
    for name in F64:
        assert r(name).read(harness.Context(setup_s=1.0)) is None
    assert r("f64_pair_roofline").read(_small_ctx(attempts=0)) is None
    assert r("f64_tail_s").read(_small_ctx(spans=[
        [0, 1000, harness.SOLVE_SPAN]])) is None
    # one of the two spans is enough
    assert r("f64_tail_s").read(_small_ctx(spans=[
        [0, 1000, harness.SOLVE_SPAN], [5, 7, "pdlp_restart"]])) == \
        pytest.approx(7e-6)
    no_pair = _small_ctx()
    no_pair.trace = dict(SMALL, device=SMALL["device"][2:4])
    assert r("f64_pair_roofline").read(no_pair) is None


def test_traced_run_on_the_cpu_card(monkeypatch):
    """The cell through harness.run on the CPU at 256 rows: correct, and
    the readers of counters and spans report; the CPU has no device
    trace, so f64_pair_roofline has nothing to read."""
    cell = harness.cell

    def small_cell(manifest, workload):
        c = cell(manifest, workload)
        c["config"]["generator"].update(n_rows=256, n_cols=256)
        return c

    monkeypatch.setattr(harness, "CARD", CpuCard())
    monkeypatch.setattr(harness, "cell", small_cell)
    out, err = io.StringIO(), io.StringIO()
    assert harness.run("stair50k.f64", 2**31 + 77, 0.5, True,
                       time.perf_counter(), out=out, err=err) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"], err.getvalue()[-2000:]
    assert set(line["metrics"]) == set(F64) - {"f64_pair_roofline"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_float32_config_changes_the_dtype_alone():
    c = harness.cell(harness.load_json(harness.ROOT, "BENCHMARK.json"),
                     "stair50k.f64")["config"]
    c32 = control_f32.float32_config(c)
    assert c["solver"]["dtype"] == "float64"
    assert c32["solver"] == dict(c["solver"], dtype="float32")
    assert {k: v for k, v in c32.items() if k != "solver"} == \
        {k: v for k, v in c.items() if k != "solver"}


def test_torch_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.ROOT, "perfbench", "torch_reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, f)).read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom):
                    tops.add((node.module or "").split(".")[0])
            assert tops <= {"__future__", "numpy", "torch"}, (f, tops)
