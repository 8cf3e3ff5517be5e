"""The metric readers: on a trace recorded on the card (data/), where
they must give what that run printed, and on small made-up inputs."""

import gzip
import json
import os

import pytest

from perfbench import harness, trace

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "stair50k_trace.json.gz")
TRACED = ("row_pass_roofline", "device_idle_share")


@pytest.fixture(scope="module")
def recorded():
    with gzip.open(DATA, "rt") as f:
        return json.load(f)


def _ctx(doc):
    tr = doc["trace"]
    return harness.Context(
        setup_s=0.0, trace=tr,
        window=trace.span_window(tr, harness.SOLVE_SPAN),
        profiled_shape=tuple(doc["profiled_shape"]),
        twin_wall=doc["twin_wall"])


@pytest.mark.parametrize("name", TRACED)
def test_trace_readers_give_what_the_run_printed(recorded, name):
    got = harness.reader(name).read(_ctx(recorded))
    assert got == pytest.approx(recorded["metrics"][name], rel=1e-9)
    assert 0 < got < 100


def test_busy_and_window_as_printed(recorded):
    lo, hi = _ctx(recorded).window
    assert (hi - lo) / 1e6 == pytest.approx(
        recorded["device"]["window_s"], rel=1e-9)
    assert trace.busy_us(recorded["trace"], lo, hi) / 1e6 == pytest.approx(
        recorded["device"]["busy_s"], rel=1e-6)


def test_recorded_trace_has_the_programs_spans(recorded):
    names = {s[2] for s in recorded["trace"]["spans"]}
    assert {"pdlp_pdhg_steps", "pdlp_termination", "pdlp_restart",
            harness.SOLVE_SPAN, harness.MAKE_SPAN} <= names
    b = trace.breakdown(recorded["trace"], *_ctx(recorded).window)
    assert 0 < len(b["device_ops"]) <= 10 and 0 < len(b["idle_gaps"]) <= 10
    assert any("row_pass_one_pass" in n for n, _ in b["device_ops"])


SMALL = {
    # device: [start, duration, name] in microseconds
    "device": [[10, 5, "k_a"], [12, 6, "row_pass_one_pass<false, 3>"],
               [30, 10, "k_b"], [55, 100, "k_c"]],
    "spans": [[0, 60, harness.SOLVE_SPAN], [20, 15, "pdlp_pdhg_steps"]],
}


def test_interval_arithmetic_by_hand():
    assert trace.union(SMALL, 0, 60) == [[10, 18], [30, 40], [55, 60]]
    assert trace.busy_us(SMALL, 0, 60) == 8 + 10 + 5
    assert trace.idle_gaps(SMALL, 0, 60) == [(0, 10), (18, 30), (40, 55)]
    assert trace.host_span_at(SMALL, 24) == "pdlp_pdhg_steps"
    assert trace.host_span_at(SMALL, 45) == harness.SOLVE_SPAN
    assert trace.host_span_at(SMALL, 70) == "none"
    assert trace.kernels(SMALL, ("row_pass_",), 0, 60) == (1, 6)
    b = trace.breakdown(SMALL, 0, 60)
    assert b["idle_gaps"] == [[harness.SOLVE_SPAN, 25e-6],
                              ["pdlp_pdhg_steps", 12e-6]]


def test_idle_share_and_roofline_by_hand():
    ctx = harness.Context(setup_s=0.0, trace=SMALL, window=(0.0, 60.0),
                          profiled_shape=(100, 100, 800), twin_wall=50e-6)
    # 23 us busy inside the profiled span, over the unprofiled twin's wall
    assert harness.reader("device_idle_share").read(ctx) == \
        pytest.approx(100 * (1 - 23 / 50))
    # 8*800 + 8*100 + 24*100 bytes at 3.35 TB/s over 6 us
    assert harness.reader("row_pass_roofline").read(ctx) == \
        pytest.approx(100 * 9600 / 3.35e12 / 6e-6)


def test_readers_without_a_trace_give_nothing():
    ctx = harness.Context(setup_s=1.0)
    for name in TRACED:
        assert harness.reader(name).read(ctx) is None
    for name in ("lp_solve_s", "lp_first_major_s", "lp_loop_steps_per_s",
                 "lp_steps_per_solve"):
        assert harness.reader(name).read(ctx) is None
    assert harness.reader("setup_s").read(ctx) == 1.0


def test_counter_readers_skip_the_profiled_solve():
    ctx = harness.Context(setup_s=0.0, solves=[
        {"wall": 1.0, "profiled": False, "raw": {
            "iterations": 600, "compile_s": 0.3, "loop_steps": 560,
            "solve_loop_s": 0.5}},
        {"wall": 3.0, "profiled": True, "raw": {
            "iterations": 640, "compile_s": 0.9, "loop_steps": 600,
            "solve_loop_s": 2.0}},
        {"wall": 2.0, "profiled": False, "raw": {
            "iterations": 680, "compile_s": 0.5, "loop_steps": 640,
            "solve_loop_s": 1.5}}])
    r = harness.reader
    assert r("lp_solve_s").read(ctx) == 2.0
    assert r("lp_first_major_s").read(ctx) == pytest.approx(0.4)
    assert r("lp_loop_steps_per_s").read(ctx) == pytest.approx(1200 / 2.0)
    assert r("lp_steps_per_solve").read(ctx) == 640
