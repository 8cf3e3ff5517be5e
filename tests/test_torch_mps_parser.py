"""cuopt_torch's MPS parser against cuopt_tpu's, on MPS text written here.

Both of the port's backends (the native parser of cpp/mps_parser, built
by cuopt_torch/kernels/build.py, and the pure-Python one) are held against
cuopt_tpu's pure-Python `_parse_text` and `parse_mps` and against
cuopt_tpu's ctypes binding of the native parser (pointed at the port's
build of the same source, so that no test writes into cuopt_tpu/): every
array, flag and name equal exactly. The bad texts raise MpsParseError in
free format in both packages. The datasets that tests/test_mps_parser.py
reads are not needed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cuopt_tpu.io.mps_parser as tpu_mps
import cuopt_tpu.io.native_mps as tpu_native
import cuopt_tpu.utils.errors as tpu_errors
from cuopt_torch.io import mps_parser as port_mps
from cuopt_torch.io import native_mps
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.utils.errors import MpsParseError
from torch_surface_instances import write_mps

torch.set_num_threads(1)

FREE_LP = """\
NAME          TESTLP
* a comment line
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  MYEQN
COLUMNS
    XONE      COST         1.0   LIM1         1.0
    XONE      LIM2         1.0
    YTWO      COST         2.0   LIM1         1.0
    YTWO      MYEQN       -1.0
    ZTHREE    COST        -1.0   MYEQN        1.0   $ trailing comment
RHS
    RHS       LIM1         4.0   LIM2         1.0
    RHS       MYEQN        7.0
BOUNDS
 UP BND       XONE         4.0
 LO BND       YTWO        -1.0
 UP BND       YTWO         1.0
ENDATA
"""


def _fixed(*fields):
    """A fixed-format data line: fields at columns 2-3, 5-12, 15-22, 25-36,
    40-47 and 50-61 (1-based)."""
    starts = (1, 4, 14, 24, 39, 49)
    line = ""
    for start, f in zip(starts, fields):
        line = line.ljust(start) + f
    return line


FIXED_LP = "\n".join([
    "NAME          FIXED",
    "ROWS",
    _fixed("N", "COST"),
    _fixed("L", "ROW ONE"),
    _fixed("G", "ROW TWO"),
    "COLUMNS",
    _fixed("", "X ONE", "COST", "1.5", "ROW ONE", "2.0"),
    _fixed("", "X ONE", "ROW TWO", "1.0"),
    _fixed("", "Y TWO", "COST", "-1", "ROW TWO", "3.25"),
    "RHS",
    _fixed("", "RHS", "ROW ONE", "10", "ROW TWO", "1"),
    "BOUNDS",
    _fixed("UP", "BND", "Y TWO", "4"),
    "ENDATA",
]) + "\n"

RANGES_LP = """\
NAME RANGES
ROWS
 N obj
 E e1
 E e2
 G g1
 L l1
 L l2
 G g2
COLUMNS
    x obj 1 e1 1 e2 2
    x g1 1 l1 1
    y obj 2 e1 1 e2 -1
    y l2 1 g2 3
RHS
    rhs e1 3 e2 -1
    rhs g1 2 l1 8
    rhs l2 5 g2 1
RANGES
    rng e1 2 e2 -3
    rng g1 4 l1 -5
    rng g2 -0.5
ENDATA
"""

BOUNDS_LP = """\
NAME BOUNDS
ROWS
 N obj
 L c1
COLUMNS
    a obj 1 c1 1
    b obj 1 c1 1
    c obj 1 c1 1
    d obj 1 c1 1
    e obj 1 c1 1
    f obj 1 c1 1
    g obj 1 c1 1
    h obj 1 c1 1
    i obj 1 c1 1
    j obj 1 c1 1
    k obj 1 c1 1
    l obj 1 c1 1
RHS
    rhs c1 10
BOUNDS
 LO bnd a 1.5
 UP bnd b -2
 LO bnd c -3
 UP bnd c -1
 FX bnd d 2.5
 FR bnd e
 MI bnd f
 UP bnd f 4
 PL bnd g
 BV bnd h
 LI bnd i 2
 UI bnd j -4
 UP bnd k 7
 LI bnd k 1
 UI bnd l 9
 MI bnd m
ENDATA
"""

MAX_OBJNAME_LP = """\
NAME MAXOBJ
OBJSENSE
    MAX
OBJNAME COST2
ROWS
 N COST1
 N COST2
 L c1
COLUMNS
    x COST1 5 COST2 1
    x c1 1
    y COST1 -2 COST2 3
    y c1 1
RHS
    rhs c1 4 COST2 12.5
ENDATA
"""

OBJNAME_NEXT_LINE_LP = """\
NAME OBJNEXT
OBJSENSE MAXIMIZE
OBJNAME
    COST2
ROWS
 N COST1
 N COST2
 G c1
COLUMNS
    x COST1 5 COST2 1
    x c1 1
    y COST2 3 c1 2
RHS
    rhs COST1 3.0 c1 1
BOUNDS
 UP bnd x 2
 UP bnd y 2
ENDATA
"""

MIP_LP = """\
NAME MIP
ROWS
 N obj
 L c1
 G c2
COLUMNS
    x obj -1 c1 1
    MARKER 'MARKER' 'INTORG'
    y obj -2 c1 1
    y c2 1
    z obj 1 c2 1
    MARKER 'MARKER' 'INTEND'
    w obj 0.5 c1 2
RHS
    rhs c1 7.5 c2 1
BOUNDS
 UP bnd y 3
 UP bnd z 3
ENDATA
"""


def _staircase_text():
    p = generate_lp(200, 200, 6, seed=123, band=48)
    rng = np.random.default_rng(3)
    lo = np.asarray(p.constraint_upper_bounds) - rng.uniform(1, 5, 200)
    rows = rng.choice(200, 40, replace=False)
    lc = np.asarray(p.constraint_lower_bounds).copy()
    lc[rows] = lo[rows]  # two-sided rows: written as RANGES
    types = np.full(200, "C")
    types[rng.choice(200, 30, replace=False)] = "I"
    ub = np.asarray(p.variable_upper_bounds).copy()
    ub[types == "I"] = 1.0
    p = dataclasses.replace(p, constraint_lower_bounds=lc,
                            variable_types=types.astype("U1"),
                            variable_upper_bounds=ub,
                            objective_offset=2.5)
    return write_mps(p, "STAIR200")


GOOD = {
    "free": FREE_LP,
    "ranges": RANGES_LP,
    "bounds": BOUNDS_LP,
    "max-objname": MAX_OBJNAME_LP,
    "objname-next-line": OBJNAME_NEXT_LINE_LP,
    "mip-markers": MIP_LP,
    "staircase-200": _staircase_text(),
}

_HEAD = "NAME BAD\nROWS\n N obj\n L c1\n"
BAD = {
    "unknown-section": _HEAD + "FOO\nCOLUMNS\n    x obj 1\nENDATA\n",
    "duplicate-row": "NAME B\nROWS\n N obj\n L c1\n G c1\nCOLUMNS\n"
                     "    x obj 1\nENDATA\n",
    "unknown-row": _HEAD + "COLUMNS\n    x obj 1 c9 1\nENDATA\n",
    "non-contiguous": _HEAD + "COLUMNS\n    x obj 1\n    y obj 1\n"
                      "    x c1 1\nENDATA\n",
    "no-objective": "NAME B\nROWS\n L c1\nCOLUMNS\n    x c1 1\nENDATA\n",
    "bad-number": _HEAD + "COLUMNS\n    x obj 1.2.3\nENDATA\n",
    "data-before-section": "    x obj 1\n" + _HEAD + "COLUMNS\n"
                           "    x obj 1\nENDATA\n",
    "truncated-rhs": _HEAD + "COLUMNS\n    x obj 1 c1 1\nRHS\n"
                     "    rhs c1 1 obj\nENDATA\n",
    "semi-continuous": _HEAD + "COLUMNS\n    x obj 1 c1 1\nBOUNDS\n"
                       " SC bnd x 4\nENDATA\n",
    "bad-bound-type": _HEAD + "COLUMNS\n    x obj 1 c1 1\nBOUNDS\n"
                      " XX bnd x 4\nENDATA\n",
    "bad-row-type": "NAME B\nROWS\n N obj\n Q c1\nCOLUMNS\n"
                    "    x obj 1\nENDATA\n",
    "bad-objsense": "NAME B\nOBJSENSE\n    UP\n" + _HEAD[7:] +
                    "COLUMNS\n    x obj 1\nENDATA\n",
    "objname-missing": "NAME B\nOBJNAME nope\n" + _HEAD[7:] +
                       "COLUMNS\n    x obj 1\nENDATA\n",
    "no-columns": _HEAD + "RHS\n    rhs c1 1\nENDATA\n",
}


def assert_same_problem(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype.kind == np.asarray(vb).dtype.kind, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, (k, va, vb)


@pytest.mark.parametrize("name", sorted(GOOD))
def test_python_backend_equals_cuopt_tpu(name):
    fixed = False
    assert_same_problem(port_mps._parse_text(GOOD[name], fixed),
                        tpu_mps._parse_text(GOOD[name], fixed))


@pytest.fixture
def tpu_binding(monkeypatch):
    """cuopt_tpu's native_mps binding, loading the port's library."""
    from cuopt_torch.kernels.build import mps_target

    native_mps.load_library()
    monkeypatch.setattr(tpu_native, "_LIB_PATH", mps_target())
    monkeypatch.setattr(tpu_native, "_lib", None)
    return tpu_native


@pytest.mark.parametrize("name", sorted(GOOD))
def test_native_backend_equals_cuopt_tpu(name, tmp_path, tpu_binding):
    path = tmp_path / f"{name}.mps"
    path.write_text(GOOD[name])
    port = port_mps.parse_mps(str(path))
    assert_same_problem(port, tpu_mps.parse_mps(str(path),
                                                backend="python"))
    assert_same_problem(port, tpu_binding.parse_mps_native(str(path)))
    assert_same_problem(native_mps.parse_mps_string_native(GOOD[name]),
                        tpu_mps._parse_text(GOOD[name], False))


def test_fixed_format(tmp_path):
    """Names with spaces: the free-format parse fails, and parse_mps
    retries in fixed format in both packages (mps_parser.py:519-532)."""
    path = tmp_path / "fixed.mps"
    path.write_text(FIXED_LP)
    port = port_mps.parse_mps(str(path), backend="python")
    assert port.row_names == ["ROW ONE", "ROW TWO"]
    assert port.variable_names == ["X ONE", "Y TWO"]
    assert_same_problem(port, tpu_mps.parse_mps(str(path),
                                                backend="python"))
    assert_same_problem(port_mps.parse_mps(str(path), fixed_format=True),
                        tpu_mps._parse_text(FIXED_LP, True))
    with pytest.raises(MpsParseError):
        port_mps._parse_text(FIXED_LP, False)


def test_semantics_read_back():
    """A few of the values, besides their equality with cuopt_tpu's."""
    p = port_mps._parse_text(RANGES_LP, False)
    np.testing.assert_array_equal(p.constraint_lower_bounds,
                                  [3, -4, 2, 3, -np.inf, 1])
    np.testing.assert_array_equal(p.constraint_upper_bounds,
                                  [5, -1, 6, 8, 5, 1.5])
    p = port_mps._parse_text(MAX_OBJNAME_LP, False)
    assert p.maximize and p.objective_name == "COST2"
    np.testing.assert_array_equal(p.objective_coefficients, [1, 3])
    assert p.objective_offset == -12.5
    p = port_mps._parse_text(BOUNDS_LP, False)
    assert p.variable_names[-1] == "m"  # first named in BOUNDS
    assert "".join(p.variable_types) == "CCCCCCCIIIII" + "C"
    p = port_mps._parse_text(GOOD["staircase-200"], False)
    assert p.n_constraints == 200 and p.is_mip()


def _outcome(parse):
    try:
        return parse()
    except (MpsParseError, tpu_errors.MpsParseError) as exc:
        return type(exc).__name__


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_text_raises_in_both_packages(name, tmp_path, tpu_binding):
    """Free format alone, each bad text raises in both packages. parse_mps
    then retries in fixed format, as the native parser does by itself,
    and a text may read as a fixed-format file instead; the native
    parser's fixed reading differs from the Python one's (it takes the
    non-contiguous text, which the Python parser refuses), so each backend
    is held against its own counterpart in cuopt_tpu: the same outcome,
    and the same problem when there is one."""
    text = BAD[name]
    with pytest.raises(MpsParseError):
        port_mps._parse_text(text, False)
    with pytest.raises(tpu_errors.MpsParseError):
        tpu_mps._parse_text(text, False)
    path = tmp_path / f"{name}.mps"
    path.write_text(text)
    for got, want in (
            (lambda: port_mps.parse_mps(str(path)),
             lambda: tpu_binding.parse_mps_native(str(path))),
            (lambda: port_mps.parse_mps(str(path), backend="python"),
             lambda: tpu_mps.parse_mps(str(path), backend="python"))):
        got, want = _outcome(got), _outcome(want)
        if isinstance(want, str):
            assert got == want
        else:
            assert_same_problem(got, want)


def test_unknown_backend_and_missing_file(tmp_path):
    with pytest.raises(ValueError):
        port_mps.parse_mps(str(tmp_path / "x.mps"), backend="cplex")
    with pytest.raises(MpsParseError):
        port_mps.parse_mps(str(tmp_path / "missing.mps"))
    empty = tmp_path / "empty.mps"
    empty.write_text("   \n")
    with pytest.raises(MpsParseError):
        port_mps.parse_mps(str(empty), backend="python")


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: when the parser library does not build, parse_mps
    raises instead of parsing in Python."""
    from cuopt_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "gxx", lambda: "false")  # exits 1
    monkeypatch.setattr(native_mps, "BUILDER", build.Builder())
    path = tmp_path / "free.mps"
    path.write_text(FREE_LP)
    with pytest.raises(RuntimeError, match="failed on"):
        port_mps.parse_mps(str(path))
    # the pure-Python parser runs when it is asked for
    assert port_mps.parse_mps(str(path), backend="python").nnz == 5
