"""cuopt_torch's problem generators and sparse operators against cuopt_tpu.

The generators and the operator builders are host numpy in both packages,
so their arrays must be identical. The operators' device methods run on
CPU tensors in float64 and must agree with cuopt_tpu's within 1e-12
relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cuopt_torch.problem.data_model import OptimizationProblem  # noqa: E402
from cuopt_torch.problem.mittelmann import GENERATORS as T_GENERATORS  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate_lp  # noqa: E402
from cuopt_torch.sparse import build_operator as t_build  # noqa: E402
from cuopt_tpu.problem.mittelmann import GENERATORS as J_GENERATORS  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate_lp  # noqa: E402
from cuopt_tpu.sparse import build_operator as j_build  # noqa: E402
from cuopt_tpu.sparse.reorder import permute_csr  # noqa: E402

torch.set_num_threads(1)

_PROBLEM_FIELDS = [f.name for f in dataclasses.fields(OptimizationProblem)]


def _assert_same_problem(a, b):
    for name in _PROBLEM_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


@pytest.mark.parametrize("kw", [
    dict(n_rows=300, n_cols=250, nnz_per_row=6, seed=3),
    dict(n_rows=500, n_cols=400, nnz_per_row=8, seed=123, band=64),
    dict(n_rows=200, n_cols=300, nnz_per_row=5, seed=1,
         equality_fraction=0.3, band=32),
])
def test_generate_lp_identical(kw):
    _assert_same_problem(t_generate_lp(**kw), j_generate_lp(**kw))


@pytest.mark.parametrize("family,scale", [
    ("set-cover", 300), ("netflow-dense", 200), ("degen-transport", 200),
    ("l1-fitting", 150),
])
def test_generators_identical(family, scale):
    _assert_same_problem(T_GENERATORS[family](scale, 4),
                         J_GENERATORS[family](scale, 4))


# ------------------------------------------------------------- operators
def _csr(case):
    """(offsets, indices, values, n_rows, n_cols) of a small instance."""
    if case == "banded":
        p = j_generate_lp(1000, 900, 6, seed=5, band=64)
    elif case == "shuffled":
        p = j_generate_lp(1024, 1024, 6, seed=5, band=96)
        rng = np.random.default_rng(9)
        rp, cp = rng.permutation(1024), rng.permutation(1024)
        off, idx, val = permute_csr(np.asarray(p.offsets),
                                    np.asarray(p.indices),
                                    np.asarray(p.values, np.float64),
                                    rp, cp, 1024, 1024)
        return off, idx, val, 1024, 1024
    elif case == "wide":
        p = J_GENERATORS["degen-transport"](632, 0)
    else:
        p = j_generate_lp(300, 400, 5, seed=3)
    return (p.offsets, p.indices, p.values, p.n_constraints,
            p.n_variables)


def _fields(op):
    """{name: numpy array or python value} of an operator of either
    package (tensors and jax arrays become numpy, ints widened)."""
    out = {"kind": type(op).__name__}
    for f in dataclasses.fields(op):
        if f.name in ("mesh", "ext_row_slabs", "ext_row_starts",
                      "halo_meta", "row_win", "col_win"):
            continue
        v = getattr(op, f.name)
        if f.name == "inner":
            out[f.name] = _fields(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _assert_same_fields(a, b, path="op"):
    assert a.keys() == b.keys(), path
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            _assert_same_fields(va, vb, f"{path}.{k}")
        elif isinstance(va, np.ndarray):
            if va.dtype.kind in "iu":  # int64 here, int32 in cuopt_tpu
                va, vb = va.astype(np.int64), vb.astype(np.int64)
            else:
                assert va.dtype == vb.dtype, f"{path}.{k}"
            np.testing.assert_array_equal(va, vb, err_msg=f"{path}.{k}")
        else:
            assert va == vb, f"{path}.{k}"


_KIND_CASES = [("blockband", "banded"), ("blockband", "wide"),
               ("bandperm", "shuffled"), ("ell", "random"),
               ("csr", "random"), ("dense", "random")]


def _both(kind, case):
    off, idx, val, n, m = _csr(case)
    t_op = t_build(off, idx, val, n, m, dtype=torch.float64, kind=kind,
                   device="cpu")
    j_op = j_build(off, idx, val, n, m, dtype=jnp.float64, kind=kind)
    return t_op, j_op


@pytest.mark.parametrize("kind,case", _KIND_CASES)
def test_build_operator_identical(kind, case):
    t_op, j_op = _both(kind, case)
    assert type(t_op).__name__ == type(j_op).__name__
    _assert_same_fields(_fields(t_op), _fields(j_op))
    if case == "wide":
        assert t_op.spill_vals.numel() > 0  # the spill path is covered


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(float(np.max(np.abs(b), initial=0.0)), 1e-300))


@pytest.mark.parametrize("kind,case", _KIND_CASES)
def test_operator_methods_match(kind, case):
    t_op, j_op = _both(kind, case)
    n, m = t_op.shape
    rng = np.random.default_rng(17)
    x = rng.normal(size=m)
    y = rng.normal(size=n)
    rs = rng.uniform(0.5, 2.0, n)
    cs = rng.uniform(0.5, 2.0, m)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    checks = [
        ("matvec", t_op.matvec(tx), j_op.matvec(jnp.asarray(x))),
        ("rmatvec", t_op.rmatvec(ty), j_op.rmatvec(jnp.asarray(y))),
        ("abs_max", t_op.abs_max(), j_op.abs_max()),
        ("row_abs_max", t_op.row_abs_max(), j_op.row_abs_max()),
        ("col_abs_max", t_op.col_abs_max(), j_op.col_abs_max()),
    ]
    for p in (1.0, 0.7, 2.0):
        checks += [(f"row_abs_reduce{p}", t_op.row_abs_reduce(p),
                    j_op.row_abs_reduce(p)),
                   (f"col_abs_reduce{p}", t_op.col_abs_reduce(p),
                    j_op.col_abs_reduce(p))]
    t_sc = t_op.rescale(torch.as_tensor(rs), torch.as_tensor(cs))
    j_sc = j_op.rescale(jnp.asarray(rs), jnp.asarray(cs))
    checks += [("rescaled matvec", t_sc.matvec(tx), j_sc.matvec(
                   jnp.asarray(x))),
               ("rescaled rmatvec", t_sc.rmatvec(ty), j_sc.rmatvec(
                   jnp.asarray(y)))]
    for name, a, b in checks:
        assert a.dtype == torch.float64, name
        assert _rel(a.numpy(), b) < 1e-12, (name, _rel(a.numpy(), b))


def _outlier_row(p, m):
    """p's CSR with 300 scattered entries in place of row 0's (a dense
    coupling row), as tests/test_sparse_ops.py:96 builds it."""
    offs, idx = np.asarray(p.offsets), np.asarray(p.indices)
    vals = np.asarray(p.values, np.float64)
    rng = np.random.default_rng(0)
    idx = np.concatenate([rng.choice(m, 300, replace=False), idx[offs[1]:]])
    vals = np.concatenate([rng.normal(size=300), vals[offs[1]:]])
    offs = offs.copy()
    offs[1:] = offs[1:] - (offs[1] - offs[0]) + 300
    return offs, idx, vals


@pytest.mark.parametrize("case", ["banded-auto", "shuffled-auto",
                                  "outlier-row"])
def test_operator_choice_matches(case):
    """tests/test_sparse_ops.py:62-190: "auto" takes the block band for a
    banded matrix and the permuted band for a shuffled one; a dense
    coupling row goes to the spill, not into the window. Both packages
    build the same operator."""
    n = 3000 if case == "shuffled-auto" else 4000
    p = j_generate_lp(n, n, 6, seed=7 if case == "shuffled-auto" else 2,
                      band=160 if case == "shuffled-auto" else 192)
    off, idx, val = p.offsets, p.indices, p.values
    kind, kw = "auto", dict(dense_size_limit=1 << 10)
    if case == "shuffled-auto":
        rng = np.random.default_rng(8)
        off, idx, val = permute_csr(np.asarray(off), np.asarray(idx),
                                    np.asarray(val, np.float64),
                                    rng.permutation(n), rng.permutation(n),
                                    n, n)
    elif case == "outlier-row":
        off, idx, val = _outlier_row(p, n)
        kind, kw = "blockband", {}
    t_op = t_build(off, idx, val, n, n, dtype=torch.float64, kind=kind,
                   device="cpu", **kw)
    j_op = j_build(off, idx, val, n, n, dtype=jnp.float64, kind=kind, **kw)
    want = {"banded-auto": "BlockBandOp", "shuffled-auto": "PermutedOp",
            "outlier-row": "BlockBandOp"}[case]
    assert type(t_op).__name__ == type(j_op).__name__ == want
    _assert_same_fields(_fields(t_op), _fields(j_op))
    if case == "outlier-row":
        assert t_op.w_row < n and t_op.spill_vals.numel() > 0


def test_blockband_rejects_unstructured():
    p = j_generate_lp(4000, 4000, 6, seed=2)  # uniform random columns
    for build, dt in ((t_build, torch.float32), (j_build, jnp.float32)):
        kw = {"device": "cpu"} if build is t_build else {}
        with pytest.raises(ValueError):
            build(p.offsets, p.indices, p.values, 4000, 4000, dtype=dt,
                  kind="blockband", **kw)
