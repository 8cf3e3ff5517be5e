"""The ctypes declarations of cuopt_torch's kernels against their C source.

The wrappers in cuopt_torch/lp/pdhg_fused.py and lp/pdhg_step.py call the
`extern "C"` entry points of cuopt_torch/csrc/row_pass.cu and
csrc/pdhg_step.cu through ctypes, which trusts the declared argument
types: a pointer declared as an int is cut to 32 bits without a word.
These tests parse the C prototypes and hold every declaration against
them, on the CPU (nothing is compiled).
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from cuopt_torch.lp import pdhg_fused as pf
from cuopt_torch.lp import pdhg_step as ps

torch.set_num_threads(1)

CSRC = Path(pf.__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "row_pass.cu"
STEP_SOURCE = CSRC / "pdhg_step.cu"


def _prototypes(source: Path = SOURCE) -> dict:
    """{name: (return type, [parameter types])} of the functions defined
    at the top level of `source`'s extern "C" block."""
    src = source.read_text()
    block = src[src.index('extern "C" {'):]
    block = re.sub(r"//[^\n]*", "", block)
    out = {}
    for ret, name, params in re.findall(
            r"^((?:const\s+)?\w+\s*\**)\s*(\w+)\s*\(([^)]*)\)\s*\{",
            block, flags=re.M):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p:
                # drop the parameter's name, keep its type
                types.append(re.sub(r"\s*\b\w+$", "", p).replace(" *", "*"))
        out[name] = (" ".join(ret.split()), types)
    return out


def _ctype_of(c_type: str):
    if c_type.endswith("*"):
        return ctypes.c_void_p
    if c_type == "int":
        return ctypes.c_int
    if c_type == "double":
        return ctypes.c_double
    raise AssertionError(f"no ctypes rule for C type {c_type!r}")


def test_every_entry_point_is_declared():
    declared = {k.name for k in pf.KERNELS} | {
        "row_pass_config", "row_pass_launches", "cuda_error_string"}
    assert set(_prototypes()) == declared


def test_every_step_entry_point_is_declared():
    declared = {k.name for k in ps.KERNELS} | {
        "pdhg_step_launches", "cuda_error_string"}
    assert set(_prototypes(STEP_SOURCE)) == declared


@pytest.mark.parametrize("kernel", pf.KERNELS + ps.KERNELS,
                         ids=lambda k: k.name)
def test_kernel_argtypes_match_the_prototype(kernel):
    assert kernel.source in ("row_pass", "pdhg_step")
    ret, params = _prototypes(CSRC / f"{kernel.source}.cu")[kernel.name]
    assert ret == "int"  # the cudaError_t of the launch
    assert len(kernel.argtypes) == len(params)
    for i, (declared, c_type) in enumerate(zip(kernel.argtypes, params)):
        assert declared is _ctype_of(c_type), (kernel.name, i, c_type)
    # the last argument is the stream, a pointer
    assert params[-1] == "void*"


def test_config_argtypes_match_the_prototype():
    ret, params = _prototypes()["row_pass_config"]
    assert ret == "int"
    assert [_ctype_of(c) for c in params] == pf.CONFIG_ARGS


def test_count_argtypes_match_the_prototype():
    ret, params = _prototypes()["row_pass_launches"]
    assert ret == "int"
    assert [_ctype_of(c) for c in params] == pf.COUNT_ARGS
    assert params[-1] == "unsigned long long*"  # ctypes.c_ulonglong
    # each kernel reads its own count, the partials mode's at index 1
    assert [k.index for k in pf.KERNELS] == [0, 1]
    # Kernel reads its count through <source>_launches
    assert {k.source for k in pf.KERNELS} == {"row_pass"}


def test_step_count_argtypes_match_the_prototype():
    """The step kernels' counts, in the order of the source's enum."""
    ret, params = _prototypes(STEP_SOURCE)["pdhg_step_launches"]
    assert ret == "int"
    assert [_ctype_of(c) for c in params] == pf.COUNT_ARGS
    assert {k.source for k in ps.KERNELS} == {"pdhg_step"}
    assert [k.index for k in ps.KERNELS] == [0, 1, 2, 3]
    assert "enum Which { PRIMAL = 0, DUAL = 1, ROW_SUMS = 2, COMMIT = 3, " \
        "N_KERNELS = 4 };" in STEP_SOURCE.read_text()
    assert [k.name for k in ps.KERNELS] == [
        "pdhg_primal", "pdhg_dual", "pdhg_row_sums", "pdhg_commit"]


def test_error_string_exists():
    for source in (SOURCE, STEP_SOURCE):
        ret, params = _prototypes(source)["cuda_error_string"]
        assert ret == "const char*", source
        assert params == ["int"], source


def test_one_pass_width_matches_the_source():
    m = re.search(r"constexpr int W_ONE_PASS = (\d+);", SOURCE.read_text())
    assert m, "W_ONE_PASS not found in row_pass.cu"
    assert int(m.group(1)) == pf.W_ONE_PASS
    assert pf.W_ONE_PASS % 128 == 0 and pf.W_ONE_PASS >= 1024


def test_column_split_width_matches_the_source():
    m = re.search(r"constexpr int W_COLUMN_SPLIT = (\d+);",
                  SOURCE.read_text())
    assert m, "W_COLUMN_SPLIT not found in row_pass.cu"
    assert int(m.group(1)) == pf.W_COLUMN_SPLIT
    # one template case per 1024 columns (with_n in row_pass.cu: 2..8)
    assert pf.W_COLUMN_SPLIT % 1024 == 0
    assert pf.W_COLUMN_SPLIT // 1024 == pf.W_ONE_PASS // 128 == 8


@pytest.mark.parametrize("W,body", [
    (128, "one-pass"), (pf.W_ONE_PASS, "one-pass"),
    (pf.W_ONE_PASS + 128, "column-split"), (4224, "column-split"),
    (pf.W_COLUMN_SPLIT, "column-split"),
    (pf.W_COLUMN_SPLIT + 128, "two-read")])
def test_body_of_width(W, body):
    """The body the wrappers expect at each width, in the order of the
    codes row_pass_config returns (0 two-read, 1 one-pass, 2
    column-split)."""
    assert pf.body_of_width(W) == body
    assert pf._BODIES == ("two-read", "one-pass", "column-split")
    src = SOURCE.read_text()
    assert "enum Body { TWO_READ = 0, ONE_PASS = 1, COLUMN_SPLIT = 2 };" \
        in src
