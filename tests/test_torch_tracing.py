"""cuopt_torch's tracing and debug asserts (utils/tracing.py), held to
cuopt_tpu's contract (tests/test_tracing.py): PDLP opens the same named
spans (and more), CUOPT_PROFILE_DIR makes the first solve write a
trace, and debug_assert fires under CUOPT_DEBUG_ASSERTS=1 and is a no-op
without it. cuopt_tpu's spans are checked in its HLO; the port's in a
torch.profiler trace of a CPU solve: on the band path each span sits
inside the one its layer belongs to, the sync spans count the syncs, and
with no profiler active no span is recorded at all."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from cuopt_torch import constants as C
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solve import solve_lp
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.utils.tracing import debug_assert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"pdlp_pdhg_steps", "pdlp_termination", "pdlp_restart"}
# each span the port opens, and the span it opens inside
PARENT = {
    "pdlp_run": None,
    "pdlp_build": "pdlp_run",
    "sparse_band_layout": "pdlp_build",
    "sparse_layout_fold": "sparse_band_layout",
    "sparse_reorder": "pdlp_build",
    "device_upload": "pdlp_build",
    "pdlp_scaling": "pdlp_build",
    "pdlp_pdhg_steps": "pdlp_run",
    "pdlp_step_sync": "pdlp_pdhg_steps",
    "pdlp_graph_capture": "pdlp_pdhg_steps",
    "pdlp_termination": "pdlp_run",
    "pdlp_restart": "pdlp_run",
    "pdlp_major_readback": "pdlp_run",
    "pdlp_answer": "pdlp_run",
}
# the spans each traced module of the port opens
MODULE_SPANS = {
    "cuopt_torch/lp/pdlp.py": {
        "pdlp_run", "pdlp_build", "device_upload", "pdlp_scaling",
        "pdlp_pdhg_steps", "pdlp_step_sync", "pdlp_graph_capture",
        "pdlp_termination", "pdlp_restart", "pdlp_major_readback",
        "pdlp_answer"},
    "cuopt_torch/sparse/ops.py": {
        "sparse_band_layout", "sparse_layout_fold", "sparse_reorder",
        "device_upload"},
}

torch.set_num_threads(1)


def _settings():
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.method = C.CUOPT_METHOD_PDLP
    s.set_optimality_tolerance(1e-6)
    return s


def _solve():
    sol = solve_lp(generate_lp(64, 64, 4, seed=1), _settings(), device="cpu")
    assert sol.get_termination_reason() == "Optimal"
    return sol


def _scopes(path):
    """The names a module's PDLP opens with trace_scope (or an alias of
    it imported as `_ts`)."""
    with open(os.path.join(REPO, path)) as f:
        return set(re.findall(r'(?:trace_scope|_ts)\("([a-z_]+)"\)',
                              f.read()))


def test_span_names_match_reference():
    """cuopt_tpu names its PDHG steps and termination check; the port
    names those, its restart, and the LP path's other layers."""
    assert _scopes("cuopt_tpu/lp/pdlp.py") == SPANS - {"pdlp_restart"}
    assert _scopes("cuopt_tpu/lp/pdlp.py") <= _scopes(
        "cuopt_torch/lp/pdlp.py")
    assert SPANS <= _scopes("cuopt_torch/lp/pdlp.py")
    for path, names in MODULE_SPANS.items():
        assert _scopes(path) == names, path
    assert set().union(*MODULE_SPANS.values()) == set(PARENT)


def test_spans_in_profiler_trace():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve()
    names = {e.key for e in prof.key_averages()}
    assert SPANS <= names, sorted(n for n in names if n.startswith("pdlp"))
    counts = {e.key: e.count for e in prof.key_averages() if e.key in SPANS}
    # one termination check and one restart decision per major iteration
    assert counts["pdlp_termination"] == counts["pdlp_restart"] >= 1
    assert counts["pdlp_pdhg_steps"] >= counts["pdlp_termination"]


def _band_lp(shuffled):
    """An LP on the band path: a staircase under "blockband", or a
    shuffled one under "auto", which tries the band, fails, reorders and
    tries again. Cut to three majors."""
    s = _settings()
    s.iteration_limit = 120
    if shuffled:
        s.operator_kind = "auto"
        return bench_torch.shuffled(
            generate_lp(2100, 2100, 8, seed=2, band=256)), s
    s.operator_kind = "blockband"
    return generate_lp(512, 512, 8, seed=2, band=64), s


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in PARENT]


def _enclosing(span, spans):
    """The innermost other span of `spans` whose interval holds `span`'s."""
    best = None
    for p in spans:
        if p is span or not (p.time_range.start <= span.time_range.start
                             and span.time_range.end <= p.time_range.end):
            continue
        if best is None or p.time_range.elapsed_us() < \
                best.time_range.elapsed_us():
            best = p
    return best


@pytest.mark.parametrize("shuffled", [False, True])
def test_band_path_spans_nest_by_layer(shuffled):
    prob, s = _band_lp(shuffled)
    sol, spans = _profiled(lambda: solve_lp(prob, s, device="cpu"))
    info = sol.get_additional_termination_information()
    count = {n: sum(e.name == n for e in spans) for n in PARENT}
    assert count["sparse_reorder"] == int(shuffled)
    assert count["sparse_band_layout"] == 1 + int(shuffled)
    # the vectors, the CSR for each band try, the permutations
    assert count["device_upload"] == 2 + 2 * int(shuffled)
    assert count["sparse_layout_fold"] == 0  # no (row, column) repeats
    for name in ("pdlp_run", "pdlp_build", "pdlp_scaling", "pdlp_answer"):
        assert count[name] == 1, name
    for e in spans:
        parent = _enclosing(e, spans)
        assert (parent and parent.name) == PARENT[e.name], e.name
    # the build is timed apart, inside the first major's time
    assert 0 < info["build_s"] <= info["compile_s"]
    # one slot an attempt, one sync per step-count read, and one readback
    # per major
    assert info["graph_slots"] == info["attempts"] >= info["iterations"]
    assert count["pdlp_step_sync"] == info["graph_count_reads"] >= 3
    per_major = PdlpSolver(prob, s, "cpu").hp.major_iteration
    majors = info["iterations"] // per_major
    assert count["pdlp_major_readback"] == count["pdlp_termination"] == \
        majors == 3


def test_layout_fold_span_only_for_repeats():
    """The layout opens its fold span once a side for a CSR that repeats
    a (row, column), inside that side's layout span, and never for one
    that repeats none."""
    from cuopt_torch.sparse import build_operator

    p = generate_lp(512, 512, 8, seed=2, band=64)
    # row 5's first entry once more, at the row's end
    end = int(p.offsets[6])
    repeated = (p.offsets + (np.arange(513) > 5),
                np.insert(p.indices, end, p.indices[p.offsets[5]]),
                np.insert(p.values, end, 1.0))

    def build(off, idx, vals):
        return build_operator(off, idx, vals, 512, 512, kind="blockband",
                              device="cpu")

    for (off, idx, vals), folds in (((p.offsets, p.indices, p.values), 0),
                                    (repeated, 2)):
        _, spans = _profiled(lambda: build(off, idx, vals))
        names = [e.name for e in spans]
        assert names.count("sparse_layout_fold") == folds
        assert names.count("sparse_band_layout") == 1
        for e in spans:
            if e.name == "sparse_layout_fold":
                assert _enclosing(e, spans).name == "sparse_band_layout"


def test_attempt_cap_reads_no_flag():
    """An attempt at the cap commits without a flag read: with a cap of
    one, every slot commits, so a solve reads one step count a major and
    syncs never per step."""
    prob, s = _band_lp(False)
    s.iteration_limit = 80
    solver = PdlpSolver(prob, s, device="cpu")
    solver.cfg = dataclasses.replace(solver.cfg, max_step_attempts=1)
    raw, spans = _profiled(solver.run)
    names = [e.name for e in spans]
    assert raw["attempts"] == raw["iterations"] == 80
    assert names.count("pdlp_step_sync") == raw["graph_count_reads"] == 2
    assert names.count("pdlp_major_readback") == 2


def test_no_profiler_records_no_span(monkeypatch):
    """With no profiler active a span is the shared do-nothing context:
    a solve through every span never builds a record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    prob, s = _band_lp(True)
    sol = solve_lp(prob, s, device="cpu")
    assert sol.get_additional_termination_information()["iterations"] == 120


def test_profile_dir_writes_one_chrome_trace(tmp_path):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from cuopt_torch import constants as C;"
        "from cuopt_torch.lp.settings import PDLPSolverSettings;"
        "from cuopt_torch.lp.solve import solve_lp;"
        "from cuopt_torch.problem.synthetic import generate_lp;"
        "s = PDLPSolverSettings(); s.log_to_console = False;"
        "s.method = C.CUOPT_METHOD_PDLP;"
        "p = generate_lp(64, 64, 4, seed=1);"
        "solve_lp(p, s, device='cpu'); solve_lp(p, s, device='cpu')"
    )
    out = tmp_path / "trace"
    env = dict(os.environ, CUOPT_PROFILE_DIR=str(out))
    r = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(out / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert SPANS <= names


def test_debug_assert_fires_under_env(monkeypatch):
    monkeypatch.setenv("CUOPT_DEBUG_ASSERTS", "1")
    with pytest.raises(AssertionError, match="positive input required"):
        debug_assert(torch.tensor(-1.0) > 0, "positive input required")
    debug_assert(torch.tensor(1.0) > 0, "positive input required")
    # the solver's own asserts hold on a solve that reaches optimality
    _solve()


def test_debug_assert_noop_by_default(monkeypatch):
    monkeypatch.delenv("CUOPT_DEBUG_ASSERTS", raising=False)
    debug_assert(torch.tensor(False), "must not fire")
    debug_assert(False, "must not fire")
