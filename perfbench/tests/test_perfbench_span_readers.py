"""The readers of the program's own spans (lp_build_s, lp_layout_s,
lp_reorder_s, lp_upload_s, lp_syncs_per_step) on small hand-built
traces: the value, None where the span is absent, and only the spans
inside the profiled solve's window counted; and on a stair50k.ordered
trace recorded on the card (data/stair50k_spans_trace.json.gz, written
by tests/record_trace.py), where they must give what that run printed
and the sync spans must hold every device-to-host copy of the loop."""

import gzip
import json
import os

import pytest

from perfbench import harness, trace

# reader -> the program span it sums
SUMS = {"lp_build_s": "pdlp_build", "lp_layout_s": "sparse_band_layout",
        "lp_reorder_s": "sparse_reorder", "lp_upload_s": "device_upload"}
WINDOW = (0.0, 1000.0)
INSIDE = [
    # [start, duration, name] in microseconds, as perfbench.trace has them
    [0, 1000, harness.SOLVE_SPAN],
    [10, 400, "pdlp_build"],
    [20, 100, "sparse_band_layout"],
    [130, 50, "sparse_reorder"],
    [190, 80, "sparse_band_layout"],
    [275, 5, "device_upload"], [285, 3, "device_upload"],
    [300, 2, "device_upload"],
    [500, 100, "pdlp_pdhg_steps"],
    [510, 1, "pdlp_step_sync"], [520, 1, "pdlp_step_sync"],
    [530, 1, "pdlp_step_sync"],
    [610, 2, "pdlp_major_readback"],
]
OUTSIDE = [
    # before the window, after it, and across its end
    [-500, 400, "pdlp_build"], [-90, 10, "pdlp_step_sync"],
    [-80, 60, "sparse_reorder"], [990, 20, "device_upload"],
    [1100, 10, "sparse_band_layout"], [1200, 5, "pdlp_major_readback"],
]
WANT = {"lp_build_s": 400e-6, "lp_layout_s": 180e-6,
        "lp_reorder_s": 50e-6, "lp_upload_s": 10e-6,
        "lp_syncs_per_step": 4 / 8}


def _ctx(spans, steps=8):
    return harness.Context(
        setup_s=0.0, trace={"device": [[5, 1, "k"]], "spans": sorted(spans)},
        window=WINDOW, solves=[
            {"wall": 1.0, "profiled": False, "raw": {"iterations": 640}},
            {"wall": 1.0, "profiled": True, "raw": {"iterations": steps}}])


def _without(names):
    return [s for s in INSIDE + OUTSIDE if s[2] not in names]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_sums_the_spans_inside_the_window(name):
    got = harness.reader(name).read(_ctx(INSIDE + OUTSIDE))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(SUMS))
def test_reader_without_its_span_gives_none(name):
    assert harness.reader(name).read(_ctx(_without({SUMS[name]}))) is None
    # spans outside the window alone are nothing to read either
    only_out = [s for s in OUTSIDE if s[2] == SUMS[name]]
    assert harness.reader(name).read(
        _ctx(INSIDE[:1] + only_out)) is None


def test_syncs_per_step_counts_each_kind_and_needs_one():
    r = harness.reader("lp_syncs_per_step")
    assert r.read(_ctx(_without({"pdlp_step_sync"}))) == 1 / 8
    assert r.read(_ctx(_without({"pdlp_major_readback"}))) == 3 / 8
    assert r.read(_ctx(_without({"pdlp_step_sync",
                                 "pdlp_major_readback"}))) is None
    # with no step counted by the program there is no ratio
    assert r.read(_ctx(INSIDE, steps=0)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_a_trace_gives_none(name):
    assert harness.reader(name).read(harness.Context(setup_s=1.0)) is None


DATA = os.path.join(os.path.dirname(__file__), "data",
                    "stair50k_spans_trace.json.gz")
STEPS_PER_MAJOR = 40  # the 50k LP's major (PDLP's default Stable2 preset)


@pytest.fixture(scope="module")
def recorded():
    with gzip.open(DATA, "rt") as f:
        return json.load(f)


def _recorded_ctx(doc):
    tr = doc["trace"]
    window = trace.span_window(tr, harness.SOLVE_SPAN)
    majors = sum(n == "pdlp_pdhg_steps" and window[0] <= ts <= window[1]
                 for ts, _, n in tr["spans"])
    return harness.Context(
        setup_s=0.0, trace=tr, window=window, solves=[
            {"wall": doc["twin_wall"], "profiled": True,
             "raw": {"iterations": STEPS_PER_MAJOR * majors}}])


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_give_what_the_card_run_printed(recorded, name):
    got = harness.reader(name).read(_recorded_ctx(recorded))
    if name == "lp_reorder_s":  # an LP in banded order is not reordered
        assert got is None and name not in recorded["metrics"]
        return
    assert got == pytest.approx(recorded["metrics"][name], rel=1e-9)
    assert got > 0


def test_sync_spans_hold_every_copy_to_the_host_in_the_loop(recorded):
    tr = recorded["trace"]
    lo, hi = trace.span_window(tr, harness.SOLVE_SPAN)
    spans = [s for s in tr["spans"] if lo <= s[0] and s[0] + s[1] <= hi]

    def inside(t, names):
        return any(ts <= t <= ts + dur for ts, dur, n in spans
                   if n in names)

    dtoh = [ts for ts, _, n in tr["device"] if "DtoH" in n and lo <= ts <= hi]
    loop = [t for t in dtoh
            if inside(t, ("pdlp_pdhg_steps", "pdlp_major_readback"))]
    syncs = [s for s in spans
             if s[2] in ("pdlp_step_sync", "pdlp_major_readback")]
    assert len(loop) == len(syncs) > 0
    assert all(inside(t, ("pdlp_step_sync", "pdlp_major_readback"))
               for t in loop)
