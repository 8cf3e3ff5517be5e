"""cuopt_torch's tracing and debug asserts (utils/tracing.py), held to
cuopt_tpu's contract (tests/test_tracing.py): PDLP opens the same named
spans (and one more), CUOPT_PROFILE_DIR makes the first solve write a
trace, and debug_assert fires under CUOPT_DEBUG_ASSERTS=1 and is a no-op
without it. cuopt_tpu's spans are checked in its HLO; the port's in a
torch.profiler trace of a CPU solve."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from cuopt_torch import constants as C
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solve import solve_lp
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.utils.tracing import debug_assert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"pdlp_pdhg_steps", "pdlp_termination", "pdlp_restart"}

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
    names its restart as well."""
    assert _scopes("cuopt_tpu/lp/pdlp.py") == SPANS - {"pdlp_restart"}
    assert _scopes("cuopt_torch/lp/pdlp.py") == SPANS


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
