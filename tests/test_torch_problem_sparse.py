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
from cuopt_torch.sparse import build_block_band as t_build_band  # noqa: E402
from cuopt_torch.sparse import build_operator as t_build  # noqa: E402
from cuopt_tpu.problem.mittelmann import GENERATORS as J_GENERATORS  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate_lp  # noqa: E402
from cuopt_tpu.sparse import build_block_band as j_build_band  # noqa: E402
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
def _crafted(case):
    """(offsets, indices, values, n_rows, n_cols) of a 1,024 x 1,000 band
    (five distinct columns a row, within 40 of the diagonal) with one
    feature that the slab layout must treat as cuopt_tpu's NumPy layout
    does:
      repeats  a (row, column) twice in every 7th row and three times in
               every 11th, the copies among the row's other entries;
      empty    every 13th row, the rows of tile 2 and the columns 512-639
               (a column tile) hold nothing;
      edge     tile 3's nonzeros lie in columns 850-999, so its window
               runs past the last column, and tile 4's in columns 100-250;
      tie      tile 5's nonzeros in two clusters of 320, at columns 0-39
               and 900-939: two candidate windows cover equally many.
    Values are seeded normals, one of them -0.0."""
    n, m = 1024, 1000
    rng = np.random.default_rng(31)
    rows = []
    for i in range(n):
        c = i * m // n
        cols = list(rng.choice(np.arange(max(0, c - 40), min(m, c + 41)), 5,
                               replace=False))
        if case == "edge" and 384 <= i < 640:
            lo, hi = (850, 1000) if i < 512 else (100, 251)
            cols = list(rng.choice(np.arange(lo, hi), 5, replace=False))
        if case == "tie" and 640 <= i < 768:
            base = 0 if i < 704 else 900
            cols = list(base + rng.choice(40, 5, replace=False))
        if case == "repeats":
            if i % 7 == 0:
                cols.insert(2, cols[0])
            if i % 11 == 0:
                cols.insert(1, cols[-1])
                cols.append(cols[-1])
        if case == "empty":
            if i % 13 == 0 or 256 <= i < 384:
                cols = []
            cols = [j for j in cols if not 512 <= j < 640]
        rows.append(cols)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate(rows).astype(np.int64)
    values = rng.normal(size=len(indices))
    values[7] = -0.0
    return offsets, indices, values, n, m


def _csr(case):
    """(offsets, indices, values, n_rows, n_cols) of a small instance."""
    if case in ("repeats", "empty", "edge", "tie"):
        return _crafted(case)
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
            else:  # bit for bit: -0.0 is not 0.0
                assert va.dtype == vb.dtype, f"{path}.{k}"
                assert va.shape == vb.shape, f"{path}.{k}"
                va, vb = (np.ascontiguousarray(a).view(np.uint8)
                          for a in (va, vb))
            np.testing.assert_array_equal(va, vb, err_msg=f"{path}.{k}")
        else:
            assert va == vb, f"{path}.{k}"


_KIND_CASES = [("blockband", "banded"), ("blockband", "wide"),
               ("bandperm", "shuffled"), ("ell", "random"),
               ("csr", "random"), ("dense", "random")]
# the slab layout's corners (_crafted), float64 unless the case says f32
_LAYOUT_CASES = [("blockband", "repeats"), ("blockband", "repeats-f32"),
                 ("blockband", "empty"), ("blockband", "edge"),
                 ("blockband", "tie")]


def _both(kind, case):
    f32 = case.endswith("-f32")
    off, idx, val, n, m = _csr(case.removesuffix("-f32"))
    t_op = t_build(off, idx, val, n, m, kind=kind, device="cpu",
                   dtype=torch.float32 if f32 else torch.float64)
    j_op = j_build(off, idx, val, n, m, kind=kind,
                   dtype=jnp.float32 if f32 else jnp.float64)
    return t_op, j_op


@pytest.mark.parametrize("kind,case", _KIND_CASES + _LAYOUT_CASES)
def test_build_operator_identical(kind, case):
    t_op, j_op = _both(kind, case)
    assert type(t_op).__name__ == type(j_op).__name__
    _assert_same_fields(_fields(t_op), _fields(j_op))
    if case == "wide":
        assert t_op.spill_vals.numel() > 0  # the spill path is covered
    if case.startswith("repeats"):
        # the CSR repeats (row, column)s: 5 + 1 + 2 entries in row 0
        off = _csr("repeats")[0]
        assert off[1] == 8 and t_op.spill_vals.numel() < off[-1]
    if case == "empty":
        assert t_op.row_slabs[2].eq(0).all() and t_op.col_slabs[4].eq(0).all()
        assert t_op.row_starts[2] == t_op.col_starts[4] == 0
    if case == "edge":
        assert t_op.row_starts[3] + t_op.w_row > t_op.n_cols
    if case == "tie":
        # one cluster in the window, the other spilled: the lesser start
        assert t_op.w_row < 900 and t_op.row_starts[5] == 0
        assert t_op.spill_rows.ge(640).logical_and(
            t_op.spill_rows.lt(768)).sum() == 320


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
                                  "outlier-row", "shuffled-unpermuted"])
def test_operator_choice_matches(case):
    """tests/test_sparse_ops.py:62-190: "auto" takes the block band for a
    banded matrix and the permuted band for a shuffled one; a dense
    coupling row goes to the spill, not into the window. Both packages
    build the same operator. On the shuffled matrix the unpermuted band
    try fails in both ("shuffled-unpermuted")."""
    shuffled = case.startswith("shuffled")
    n = 3000 if shuffled else 4000
    p = j_generate_lp(n, n, 6, seed=7 if shuffled else 2,
                      band=160 if shuffled else 192)
    off, idx, val = p.offsets, p.indices, p.values
    kind, kw = "auto", dict(dense_size_limit=1 << 10)
    if shuffled:
        rng = np.random.default_rng(8)
        off, idx, val = permute_csr(np.asarray(off), np.asarray(idx),
                                    np.asarray(val, np.float64),
                                    rng.permutation(n), rng.permutation(n),
                                    n, n)
    elif case == "outlier-row":
        off, idx, val = _outlier_row(p, n)
        kind, kw = "blockband", {}
    if case == "shuffled-unpermuted":
        assert t_build_band(off, idx, val, n, n, torch.float64,
                            device="cpu") is None
        assert j_build_band(off, idx, val, n, n, jnp.float64) is None
    t_op = t_build(off, idx, val, n, n, dtype=torch.float64, kind=kind,
                   device="cpu", **kw)
    j_op = j_build(off, idx, val, n, n, dtype=jnp.float64, kind=kind, **kw)
    want = "PermutedOp" if shuffled else "BlockBandOp"
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
