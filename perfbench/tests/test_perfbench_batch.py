"""The batch cell (`stair50k.batch8`): its driver's checks, its readers
and its yardstick.

On the CPU card at a small size (1,500 rows and columns, 4 members, so
the batch still stacks a block band): a short traced window reads
`correct`, with the readers of counters reporting; two members' answers
swapped read not correct; a float32 batch reads `objective_drift` over
its limit where the float64 one is far inside it; every member of the
recipe is feasible at the generator's interior point. On a
stair50k.batch8 trace recorded on the card
(data/stair50k_batch8_trace.json.gz, written by
tests/record_batch_trace.py) the four readers give what that run
printed. By hand: the readers and the yardstick on small inputs, and
None where a program without the batch's counters gives nothing."""

import copy
import gzip
import io
import json
import os
import time

import numpy as np
import pytest
from cpu_card import CpuCard

from perfbench import harness, trace, yardstick_batch
from perfbench.drivers import lp_batch

BATCH = ("batch_member_steps_per_s", "batch_syncs_per_step",
         "batch_build_s", "batch_pair_roofline")
DATA = os.path.join(os.path.dirname(__file__), "data",
                    "stair50k_batch8_trace.json.gz")
N_SMALL, MEMBERS_SMALL = 1500, 4
SEED = 2**31 + 61


def _small(c):
    c["config"]["generator"].update(n_rows=N_SMALL, n_cols=N_SMALL)
    c["traffic"]["members"] = MEMBERS_SMALL
    return c


def _cell():
    return _small(copy.deepcopy(harness.cell(
        harness.load_json(harness.ROOT, "BENCHMARK.json"),
        "stair50k.batch8")))


def _driver(dtype=None):
    c = _cell()
    if dtype is not None:
        c["config"]["solver"]["dtype"] = dtype
    return lp_batch.Driver(c["config"], c["traffic"], "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU batches on one thread: the vmapped loop's many small ops
    gain nothing from more, and other test files' timed windows in
    parallel workers would lose the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_request():
    """(driver, request, answer): the run's first request, solved."""
    drv = _driver()
    req = drv.make(SEED, 0)
    return drv, req, drv.call(req)


# ------------------------------------------------- the checks, on the CPU
def test_traced_run_on_the_cpu_card_is_correct(monkeypatch):
    """The cell through harness.run on the CPU at 1,500 rows: correct,
    every member batched, and the readers of counters report; the CPU
    has no device trace, so batch_pair_roofline has nothing to read."""
    cell = harness.cell
    monkeypatch.setattr(harness, "CARD", CpuCard())
    monkeypatch.setattr(harness, "cell",
                        lambda m, w: _small(cell(m, w)))
    out, err = io.StringIO(), io.StringIO()
    assert harness.run("stair50k.batch8", SEED, 0.5, True,
                       time.perf_counter(), out=out, err=err) == 0
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    assert line["correct"], err.getvalue()[-2000:]
    assert line["failed"] == 0
    assert set(line["checks"]) == {"kkt_worst", "wrong_claims",
                                   "not_optimal", "objective_drift"}
    assert set(line["metrics"]) == set(BATCH) - {"batch_pair_roofline"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert "'pdlp_batch': " in lines[0]


def test_each_member_is_judged_by_its_own_bounds(one_request):
    drv, req, answer = one_request
    failed, checks = drv.judge([req], [answer])
    assert failed == 0 and harness.is_correct(checks), checks
    assert answer["raw"]["solved_by"] == ["pdlp_batch"] * MEMBERS_SMALL
    # the same answers handed to the wrong members
    swapped = dict(answer, members=[answer["members"][1],
                                    answer["members"][0],
                                    *answer["members"][2:]])
    failed, checks = drv.judge([req], [swapped])
    assert failed == 1 and not harness.is_correct(checks)
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"]


def test_a_member_not_optimal_fails_its_request(one_request):
    drv, req, answer = one_request
    stopped = copy.deepcopy(answer)
    stopped["members"][2]["status"] = "IterationLimit"
    failed, checks = drv.judge([req, req], [answer, stopped])
    assert failed == 1 and checks["not_optimal"]["value"] == 1
    assert not harness.is_correct(checks)
    stopped["members"][3]["status"] = "Infeasible"
    _, checks = drv.judge([req], [stopped])
    assert checks["wrong_claims"]["value"] == 1


def test_float32_batch_drifts_past_the_limit(one_request):
    """The KKT check at 1e-4 passes float32 answers too; the drift of
    the reported objective from c.x in float64 tells the precision."""
    drv64, req64, answer64 = one_request
    _, checks64 = drv64.judge([req64], [answer64])
    limit = checks64["objective_drift"]["limit"]
    assert checks64["objective_drift"]["value"] < limit / 100
    drv32 = _driver("float32")
    assert drv32.settings.dtype == "float32"
    req = drv32.make(SEED, 0)
    failed, checks = drv32.judge([req], [drv32.call(req)])
    assert checks["objective_drift"]["value"] > 100 * limit
    assert failed == 1 and not harness.is_correct(checks)


def _interior_point(n_rows, n_cols, nnz_per_row, band, seed):
    """The generator's x0 for `seed`: lpgen.staircase's draws replayed up
    to it."""
    rng = np.random.default_rng(seed)
    Wc = min(max(band, nnz_per_row), n_cols)
    chunk = max(1, min(n_rows, (1 << 24) // max(Wc, 1)))
    for a in range(0, n_rows, chunk):
        rng.random((min(a + chunk, n_rows) - a, Wc))
    rng.standard_normal((n_rows, nnz_per_row))
    return rng.uniform(0.2, 0.8, n_cols)


@pytest.mark.parametrize("index", [-1, 0, 5])
def test_every_member_is_feasible_at_the_interior_point(index):
    drv = _driver()
    g = drv.gen
    lps = drv.lps(SEED, index)
    path = (0,) if index < 0 else (1, index)
    x0 = _interior_point(g["n_rows"], g["n_cols"], g["nnz_per_row"],
                         g["band"], lp_batch.lp_seed(SEED, *path))
    from perfbench.reference import kkt

    slack = lps[0]["uc"] - kkt.matvec(lps[0], x0)
    assert slack.min() >= 0.1 - 1e-12 and slack.max() <= 1.0 + 1e-12
    moved = int(round(N_SMALL * drv.moved_share))
    for lp in lps:
        assert lp["values"] is lps[0]["values"]
        assert np.all(lp["lv"] <= x0) and np.all(x0 <= lp["uv"])
        assert (lp["lv"] == 0.1).sum() + (lp["uv"] == 0.9).sum() == moved
    # each member moves its own columns
    assert len({lp["lv"].tobytes() + lp["uv"].tobytes()
                for lp in lps}) == MEMBERS_SMALL


# ------------------------------------------- the readers on a card trace
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


@pytest.mark.parametrize("name", BATCH)
def test_readers_give_what_the_card_run_printed(recorded, name):
    got = harness.reader(name).read(_recorded_ctx(recorded))
    assert got == pytest.approx(recorded["metrics"][name], rel=1e-9)
    assert got > 0
    if name == "batch_pair_roofline":
        assert got < 100


def test_recorded_request_ran_the_batch(recorded):
    """Every member batched; the profiled request's spans as its
    counters say, and no graph and no step kernel on the card."""
    raw = recorded["solves"][-1]["raw"]
    assert raw["solved_by"] == ["pdlp_batch"] * 8
    assert raw["batch_size"] == 8
    assert raw["batch_steps"] == max(raw["iterations"])
    ctx = _recorded_ctx(recorded)
    from perfbench import program_spans

    count = {n: len(program_spans.inside(ctx, n)) for n in (
        "pdlp_batch_build", "pdlp_batch_steps", "pdlp_batch_sync",
        "pdlp_batch_tail", "pdlp_batch_readback")}
    majors = count["pdlp_batch_steps"]
    assert count == {"pdlp_batch_build": 1, "pdlp_batch_steps": majors,
                     "pdlp_batch_sync": raw["batch_passes"],
                     "pdlp_batch_tail": majors,
                     "pdlp_batch_readback": majors}
    assert raw["batch_syncs"] == raw["batch_passes"] + majors
    ops = recorded["device_ops"]
    assert not [k for k in ops if "pdhg_" in k or "row_pass" in k]
    assert recorded["device"]["busy_s"] > 0


# --------------------------------------------------------------- by hand
def test_least_bytes_of_a_batch():
    # the shared matrix once a pass, 3.2 MB of vectors a member attempt
    assert yardstick_batch.batch_pair_bytes(
        50_000, 50_000, 400_000, [1] * 8) == 4_800_000 + 8 * 3_200_000
    assert yardstick_batch.batch_pair_bytes(1, 1, 1, [3, 5]) == \
        5 * 12 + 8 * (16 + 48)


SMALL = {
    "device": [
        [10, 4, "gemv2T_kernel_val<int, int, double, double, double, "
                "double, 128, 16, 4, 4, false, false>"],
        [20, 6, "sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_tilesize32x64x32_"
                "stage3_warpsize2x2x1_tensor16x8x8_execute_kernel__5x_cublas"],
        [30, 2, "index_elementwise_kernel<128, 4>"],
        [40, 3, "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8"],
        [2000, 7, "gemv2T_kernel_val<int, int, double, double, double, "
                  "double, 128, 16, 4, 4, false, false>"]],
    "spans": [[0, 1000, harness.SOLVE_SPAN]],
}


def _small_ctx(attempts=(3, 2)):
    return harness.Context(
        setup_s=0.0, trace=SMALL, window=(0.0, 1000.0),
        profiled_shape=(100, 200, 800, 2), twin_wall=1e-3, solves=[
            {"wall": 1.0, "profiled": False, "raw": {
                "iterations": [600, 560], "attempts": [610, 565],
                "batch_steps": 600, "batch_syncs": 660,
                "batch_build_s": 0.5, "batch_loop_s": 2.0}},
            {"wall": 2.0, "profiled": True, "raw": {
                "iterations": [1, 1], "attempts": list(attempts),
                "batch_steps": 9, "batch_syncs": 99,
                "batch_build_s": 9.0, "batch_loop_s": 9.0}},
            {"wall": 1.5, "profiled": False, "raw": {
                "iterations": [640, 640], "attempts": [650, 645],
                "batch_steps": 640, "batch_syncs": 700,
                "batch_build_s": 0.7, "batch_loop_s": 2.0}}])


def test_readers_by_hand():
    ctx = _small_ctx()
    r = harness.reader
    assert r("batch_member_steps_per_s").read(ctx) == pytest.approx(
        (600 + 560 + 640 + 640) / 4.0)
    assert r("batch_syncs_per_step").read(ctx) == pytest.approx(
        1360 / 1240)
    assert r("batch_build_s").read(ctx) == pytest.approx(0.6)
    # 3 matrix reads of 12 * 800 bytes and 5 member attempts of
    # 16 * 200 + 48 * 100 bytes at 3.35 TB/s, over the double gemv and
    # the double GEMM inside the window (10 us); the gather, the float
    # GEMM and the product after the window are not counted
    assert r("batch_pair_roofline").read(ctx) == pytest.approx(
        100 * (3 * 9600 + 5 * 8000) / 3.35e12 / 10e-6)


def test_readers_without_their_inputs_give_none():
    """A program without the batch's counters (the raw of the entry
    before them) and a run without a trace give nothing to read."""
    r = harness.reader
    for name in BATCH:
        assert r(name).read(harness.Context(setup_s=1.0)) is None
    bare = _small_ctx()
    for s in bare.solves:
        s["raw"] = {k: s["raw"][k] for k in ("iterations", "attempts")}
    for name in BATCH[:3]:
        assert r(name).read(bare) is None
    assert r("batch_pair_roofline").read(bare) is not None
    assert r("batch_pair_roofline").read(_small_ctx(attempts=())) is None
    no_pair = _small_ctx()
    no_pair.trace = dict(SMALL, device=SMALL["device"][2:3])
    assert r("batch_pair_roofline").read(no_pair) is None
