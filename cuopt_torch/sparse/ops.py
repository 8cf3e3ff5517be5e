"""Sparse linear operators for the constraint matrix A, over torch tensors.

The reference uses cusparse CSR SpMV (cpp/src/linear_programming/
cusparse_view.hpp:30) for the PDHG hot pair Ax / A^T y. The operator is
chosen per problem, with the same host builders (and therefore the same
layouts) as cuopt_tpu/sparse/ops.py:

  - DenseOp: A stored dense; matvec is one matrix-vector product.
  - EllOp: ELLPACK (padded fixed-width rows) for A and for A^T.
  - CsrOp: flat nnz gather + segment sum (index_add_).
  - BlockBandOp: dense 128-row slabs over per-tile column windows; the
    fused PDHG row pass (lp/pdhg_fused.py) streams its row slabs.
  - PermutedOp: a BlockBandOp under a bandwidth-reducing permutation.

Every operator holds its tensors on one device and supports matvec,
rmatvec, rescale (diag(r) A diag(c), returning a new operator) and the
abs reductions used by Ruiz / Pock-Chambolle scaling.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _segment_sum(vals, seg, n):
    # out of place, so that lp/batch.py can vmap it over stacked values
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .index_add(0, seg, vals)


def _segment_abs_max(vals, seg, n):
    """max(0, max |v| per segment): empty segments give 0."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce_(0, seg, vals.abs(), "amax", include_self=True)


class LinearOperator:
    """Interface marker: matvec (A x), rmatvec (A^T y), rescale, abs_max."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class DenseOp(LinearOperator):
    mat: torch.Tensor  # (n_rows, n_cols)

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, y):
        return self.mat.T @ y

    def rescale(self, row_scale, col_scale):
        return DenseOp(mat=self.mat * row_scale[:, None] * col_scale[None, :])

    def abs_max(self):
        return self.mat.abs().max()

    def row_abs_reduce(self, power):
        """sum_j |a_ij|^power per row."""
        return self.mat.abs().pow(power).sum(1)

    def col_abs_reduce(self, power):
        return self.mat.abs().pow(power).sum(0)

    def row_abs_max(self):
        return self.mat.abs().amax(1)

    def col_abs_max(self):
        return self.mat.abs().amax(0)


@dataclass
class EllOp(LinearOperator):
    """ELLPACK for A and A^T. Padded entries have value 0 and index 0."""

    n_rows: int
    n_cols: int
    row_vals: torch.Tensor  # (n_rows, Lr)
    row_cols: torch.Tensor  # (n_rows, Lr) int64
    col_vals: torch.Tensor  # (n_cols, Lc)
    col_rows: torch.Tensor  # (n_cols, Lc) int64

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def matvec(self, x):
        return (self.row_vals * x[self.row_cols]).sum(1)

    def rmatvec(self, y):
        return (self.col_vals * y[self.col_rows]).sum(1)

    def rescale(self, row_scale, col_scale):
        return self.replace(
            row_vals=self.row_vals * row_scale[:, None]
            * col_scale[self.row_cols],
            col_vals=self.col_vals * col_scale[:, None]
            * row_scale[self.col_rows],
        )

    def abs_max(self):
        return self.row_vals.abs().max()

    def row_abs_reduce(self, power):
        return self.row_vals.abs().pow(power).sum(1)

    def col_abs_reduce(self, power):
        return self.col_vals.abs().pow(power).sum(1)

    def row_abs_max(self):
        return self.row_vals.abs().amax(1)

    def col_abs_max(self):
        return self.col_vals.abs().amax(1)


@dataclass
class CsrOp(LinearOperator):
    """Flat gather + segment-sum SpMV; holds both CSR and CSC orderings."""

    n_rows: int
    n_cols: int
    csr_vals: torch.Tensor  # (nnz,)
    csr_rows: torch.Tensor  # (nnz,) int64, sorted
    csr_cols: torch.Tensor  # (nnz,) int64
    csc_vals: torch.Tensor
    csc_rows: torch.Tensor
    csc_cols: torch.Tensor  # sorted

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def matvec(self, x):
        return _segment_sum(self.csr_vals * x[self.csr_cols], self.csr_rows,
                            self.n_rows)

    def rmatvec(self, y):
        return _segment_sum(self.csc_vals * y[self.csc_rows], self.csc_cols,
                            self.n_cols)

    def rescale(self, row_scale, col_scale):
        return self.replace(
            csr_vals=self.csr_vals * row_scale[self.csr_rows]
            * col_scale[self.csr_cols],
            csc_vals=self.csc_vals * row_scale[self.csc_rows]
            * col_scale[self.csc_cols],
        )

    def abs_max(self):
        if self.csr_vals.numel() == 0:
            return torch.zeros((), dtype=self.csr_vals.dtype,
                               device=self.csr_vals.device)
        return self.csr_vals.abs().max()

    def row_abs_reduce(self, power):
        return _segment_sum(self.csr_vals.abs().pow(power), self.csr_rows,
                            self.n_rows)

    def col_abs_reduce(self, power):
        return _segment_sum(self.csc_vals.abs().pow(power), self.csc_cols,
                            self.n_cols)

    def row_abs_max(self):
        return _segment_abs_max(self.csr_vals, self.csr_rows, self.n_rows)

    def col_abs_max(self):
        return _segment_abs_max(self.csc_vals, self.csc_cols, self.n_cols)


def _window_index(starts, width, device):
    """(T, width) gather index of each tile's window (one index gather
    replaces T slices)."""
    idx = np.add.outer(np.asarray(starts, np.int64),
                       np.arange(width, dtype=np.int64))
    return torch.as_tensor(idx.reshape(len(starts), width), device=device)


@dataclass
class BlockBandOp(LinearOperator):
    """Banded block-dense operator: rows are tiled in groups of `tile`
    (128); each row tile stores a DENSE slab covering a 128-aligned
    column window placed over its nonzeros (densest-window heuristic).
    matvec is a batched (T, tile, W) x (T, W) product plus a small COO
    "spill" segment sum for the entries outside their tile's window. A
    transposed band (col tiles x row windows) of the same matrix serves
    rmatvec, with its own spill. Layout and builder are those of
    cuopt_tpu/sparse/ops.py:198, so both packages build the same slabs.
    """

    n_rows: int
    n_cols: int
    tile: int
    w_row: int  # row-slab window width
    w_col: int  # col-slab window width
    row_starts: tuple  # (T_r,) column-window starts, multiples of 128
    col_starts: tuple  # (T_c,)
    row_slabs: torch.Tensor  # (T_r, tile, w_row)  A row tiles
    col_slabs: torch.Tensor  # (T_c, tile, w_col)  A^T col tiles
    # spill of A entries outside the row-slab windows (row-sorted COO)
    spill_vals: torch.Tensor  # (S_r,)
    spill_rows: torch.Tensor  # (S_r,) int64, sorted
    spill_cols: torch.Tensor  # (S_r,) int64
    # spill of A^T entries outside the col-slab windows (A^T-row-sorted)
    t_spill_vals: torch.Tensor  # (S_c,)
    t_spill_rows: torch.Tensor  # (S_c,) int64 = A columns, sorted
    t_spill_cols: torch.Tensor  # (S_c,) int64 = A rows
    # (T, W) window gather indices, derived from the starts
    row_win: torch.Tensor = field(default=None, repr=False)
    col_win: torch.Tensor = field(default=None, repr=False)

    def __post_init__(self):
        dev = self.row_slabs.device
        if self.row_win is None:
            self.row_win = _window_index(self.row_starts, self.w_row, dev)
        if self.col_win is None:
            self.col_win = _window_index(self.col_starts, self.w_col, dev)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @staticmethod
    def _windows(v, win):
        width = win.shape[1]
        vp = torch.cat([v, v.new_zeros(width)])
        return vp[win]

    def matvec(self, x):
        xw = self._windows(x, self.row_win)
        out = torch.bmm(self.row_slabs, xw.unsqueeze(2)).reshape(-1)
        out = out[: self.n_rows]
        if self.spill_vals.numel():
            out = out + _segment_sum(self.spill_vals * x[self.spill_cols],
                                     self.spill_rows, self.n_rows)
        return out

    def rmatvec(self, y):
        yw = self._windows(y, self.col_win)
        out = torch.bmm(self.col_slabs, yw.unsqueeze(2)).reshape(-1)
        out = out[: self.n_cols]
        if self.t_spill_vals.numel():
            out = out + _segment_sum(
                self.t_spill_vals * y[self.t_spill_cols],
                self.t_spill_rows, self.n_cols)
        return out

    def rescale(self, row_scale, col_scale):
        rw = self._windows(col_scale, self.row_win)
        rs_pad = torch.cat([
            row_scale, row_scale.new_zeros(
                self.row_slabs.shape[0] * self.tile - self.n_rows)
        ]).reshape(-1, self.tile)
        cw = self._windows(row_scale, self.col_win)
        cs_pad = torch.cat([
            col_scale, col_scale.new_zeros(
                self.col_slabs.shape[0] * self.tile - self.n_cols)
        ]).reshape(-1, self.tile)
        new = self.replace(
            row_slabs=self.row_slabs * rs_pad[:, :, None] * rw[:, None, :],
            col_slabs=self.col_slabs * cs_pad[:, :, None] * cw[:, None, :],
        )
        if self.spill_vals.numel():
            new.spill_vals = self.spill_vals * row_scale[self.spill_rows] \
                * col_scale[self.spill_cols]
        if self.t_spill_vals.numel():
            new.t_spill_vals = self.t_spill_vals \
                * col_scale[self.t_spill_rows] \
                * row_scale[self.t_spill_cols]
        return new

    def abs_max(self):
        m = self.row_slabs.abs().max()
        if self.spill_vals.numel():
            m = torch.maximum(m, self.spill_vals.abs().max())
        return m

    def row_abs_reduce(self, power):
        r = self.row_slabs.abs().pow(power).sum(2).reshape(-1)
        r = r[: self.n_rows]
        if self.spill_vals.numel():
            r = r + _segment_sum(self.spill_vals.abs().pow(power),
                                 self.spill_rows, self.n_rows)
        return r

    def col_abs_reduce(self, power):
        r = self.col_slabs.abs().pow(power).sum(2).reshape(-1)
        r = r[: self.n_cols]
        if self.t_spill_vals.numel():
            r = r + _segment_sum(self.t_spill_vals.abs().pow(power),
                                 self.t_spill_rows, self.n_cols)
        return r

    def row_abs_max(self):
        r = self.row_slabs.abs().amax(2).reshape(-1)[: self.n_rows]
        if self.spill_vals.numel():
            r = torch.maximum(r, _segment_abs_max(
                self.spill_vals, self.spill_rows, self.n_rows))
        return r

    def col_abs_max(self):
        r = self.col_slabs.abs().amax(2).reshape(-1)[: self.n_cols]
        if self.t_spill_vals.numel():
            r = torch.maximum(r, _segment_abs_max(
                self.t_spill_vals, self.t_spill_rows, self.n_cols))
        return r


@dataclass
class PermutedOp(LinearOperator):
    """A under a bandwidth-reducing row/column permutation:
    inner = A[row_perm][:, col_perm] (a BlockBandOp). The wrapper routes
    matvec/rmatvec through O(m+n) gathers (sparse/reorder.py). The PDLP
    driver absorbs the permutation into the problem instead
    (lp/pdlp.py build_device_problem), so the hot loop never gathers."""

    inner: BlockBandOp
    row_perm: torch.Tensor      # (n,) int64: inner row i = A row row_perm[i]
    inv_row_perm: torch.Tensor  # (n,) int64
    col_perm: torch.Tensor      # (m,) int64
    inv_col_perm: torch.Tensor  # (m,) int64

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, x):
        return self.inner.matvec(x[self.col_perm])[self.inv_row_perm]

    def rmatvec(self, y):
        return self.inner.rmatvec(y[self.row_perm])[self.inv_col_perm]

    def rescale(self, row_scale, col_scale):
        return self.replace(inner=self.inner.rescale(
            row_scale[self.row_perm], col_scale[self.col_perm]))

    def abs_max(self):
        return self.inner.abs_max()

    def row_abs_reduce(self, power):
        return self.inner.row_abs_reduce(power)[self.inv_row_perm]

    def col_abs_reduce(self, power):
        return self.inner.col_abs_reduce(power)[self.inv_col_perm]

    def row_abs_max(self):
        return self.inner.row_abs_max()[self.inv_row_perm]

    def col_abs_max(self):
        return self.inner.col_abs_max()[self.inv_col_perm]


def operator_from_arrays(d: dict, device) -> LinearOperator:
    """Build an operator from its fields given as numpy arrays and Python
    values, with d["kind"] the class name ("DenseOp", "EllOp", "CsrOp",
    "BlockBandOp", "PermutedOp"; a PermutedOp's d["inner"] is a dict of
    the same form). Integer arrays become int64 tensors."""
    kinds = {c.__name__: c for c in (DenseOp, EllOp, CsrOp, BlockBandOp,
                                     PermutedOp)}
    cls = kinds[d["kind"]]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "inner":
            v = operator_from_arrays(v, device)
        elif f.name in ("row_starts", "col_starts"):
            v = tuple(int(s) for s in v)
        elif isinstance(v, np.ndarray):
            a = np.array(v)  # a writable copy
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            v = torch.as_tensor(a, device=device)
        kw[f.name] = v
    return cls(**kw)


# ----------------------------------------------------------- host builders
_ALIGN = 128  # window starts are 128-aligned: the fused row pass
# (lp/pdhg_fused.py) and cuopt_tpu's Pallas kernel both take starts in
# 128-column units


def _tile_windows(offsets, indices, n_axis, tile, W):
    """Per-tile window starts for width W, placed on the densest
    128-ALIGNED window of each tile's (sorted) column indices.
    Returns (starts (T,), inside mask over nnz)."""
    T = (n_axis + tile - 1) // tile
    starts = np.zeros(T, np.int64)
    inside = np.zeros(offsets[-1], bool)
    for t in range(T):
        a = int(offsets[min(t * tile, n_axis)])
        b = int(offsets[min((t + 1) * tile, n_axis)])
        if b <= a:
            continue
        seg = np.sort(indices[a:b])
        lo = (int(seg[0]) // _ALIGN) * _ALIGN
        if int(seg[-1]) - lo < W:
            s = lo
        else:
            # candidate aligned starts; count coverage via two pointers
            cand = np.unique((seg // _ALIGN) * _ALIGN)
            jj = np.searchsorted(seg, cand + W, side="left")
            ii = np.searchsorted(seg, cand, side="left")
            s = int(cand[int(np.argmax(jj - ii))])
        starts[t] = s
        inside[a:b] = (indices[a:b] >= s) & (indices[a:b] < s + W)
    return starts, inside


def _band_slabs(offsets, indices, values, n_axis, n_other, tile,
                np_dtype, spill_frac=0.15):
    """Slab decomposition of a CSR matrix along `n_axis` rows.

    Picks the window width W (multiple of `tile`) of least modeled cost
    among the full width (zero spill), per-tile-width quantiles and a
    geometric ladder, subject to the spill staying under spill_frac * nnz
    and the slab budgets. Returns (slabs (T, tile, W), starts tuple, W,
    (spill_vals, spill_rows, spill_cols)) or None if every candidate
    blows the slab budget."""
    T = (n_axis + tile - 1) // tile
    nnz = len(values)
    # slab budget: up to ~256 stored elements per nonzero, and 3 GiB
    elem_budget = max(256 * max(nnz, 1), 1 << 22)
    byte_budget = 3 << 30
    rows = np.repeat(np.arange(n_axis, dtype=np.int64), np.diff(offsets))

    # per-tile full window widths
    full_w = np.zeros(T, np.int64)
    for t in range(T):
        a = int(offsets[min(t * tile, n_axis)])
        b = int(offsets[min((t + 1) * tile, n_axis)])
        if b > a:
            seg = indices[a:b]
            # width needed from a 128-aligned start (see _tile_windows)
            full_w[t] = int(seg.max()) - (int(seg.min()) // _ALIGN) * _ALIGN + 1

    def _round(w):
        return max(tile, ((int(w) + tile - 1) // tile) * tile)

    nz_w = full_w[full_w > 0]
    cands = [_round(full_w.max() if T else tile)]
    if len(nz_w):
        for q in (0.95, 0.85, 0.7, 0.5):
            cands.append(_round(np.quantile(nz_w, q)))
    # geometric ladder: quantiles of full widths are poisoned when outlier
    # entries stretch many tiles' windows
    w = tile
    w_max = elem_budget // max(T * tile, 1)
    while w <= min(w_max, max(int(full_w.max()) if T else tile, tile)):
        cands.append(w)
        w *= 4
    cands.extend([256, 384, 512])
    # Modeled cost in slab-element units. These two constants were fitted
    # on a TPU (cuopt_tpu/sparse/ops.py:812-813) and are kept unchanged so
    # that both packages build the same layout; refitting them for the
    # H100 waits for the port's bench.
    SPILL_COST = 3200
    WIDE_RATE_PENALTY = 2.2
    chosen, best_cost = None, np.inf
    for W in sorted(set(cands), reverse=True):
        slab_elems = T * tile * W
        if slab_elems > elem_budget or \
                slab_elems * np.dtype(np_dtype).itemsize > byte_budget:
            continue
        starts, inside = _tile_windows(offsets, indices, n_axis, tile, W)
        n_spill = int((~inside).sum())
        if n_spill > spill_frac * max(nnz, 1):
            continue
        rate = 1.0 if W <= 512 else WIDE_RATE_PENALTY
        cost = slab_elems * rate + SPILL_COST * n_spill
        if cost < best_cost:
            best_cost = cost
            chosen = (W, starts, inside)
    if chosen is None:
        return None
    W, starts, inside = chosen

    slabs = np.zeros((T, tile, W), np_dtype)
    if nnz:
        t_of = rows // tile
        r_in = rows % tile
        local = indices - starts[t_of]
        np.add.at(slabs, (t_of[inside], r_in[inside], local[inside]),
                  values[inside])
    out = ~inside
    spill = (
        values[out].astype(np_dtype),
        rows[out].astype(np.int64),
        indices[out].astype(np.int64),
    )
    return slabs, tuple(int(s) for s in starts), W, spill


def build_block_band(offsets, indices, values, n_rows, n_cols, dtype,
                     tile=128, spill_frac=0.15, device="cuda"):
    """Build a BlockBandOp, or None when the matrix has no usable band
    structure (window blow-up guard in _band_slabs)."""
    np_dtype = _np_dtype(dtype)
    row = _band_slabs(offsets, indices, values, n_rows, n_cols, tile,
                      np_dtype, spill_frac)
    if row is None:
        return None
    t_offsets, t_indices, t_values, _ = _transpose_csr(
        offsets, indices, values, n_rows, n_cols
    )
    col = _band_slabs(t_offsets, t_indices, t_values, n_cols, n_rows,
                      tile, np_dtype, spill_frac)
    if col is None:
        return None
    row_slabs, row_starts, w_row, (sv, sr, sc) = row
    col_slabs, col_starts, w_col, (tv, tr, tc) = col

    def t(a):
        return torch.as_tensor(a, device=device)

    return BlockBandOp(
        n_rows=n_rows, n_cols=n_cols, tile=tile,
        w_row=w_row, w_col=w_col,
        row_starts=row_starts, col_starts=col_starts,
        row_slabs=t(row_slabs), col_slabs=t(col_slabs),
        spill_vals=t(sv), spill_rows=t(sr), spill_cols=t(sc),
        t_spill_vals=t(tv), t_spill_rows=t(tr), t_spill_cols=t(tc),
    )


def build_permuted_band(offsets, indices, values, n_rows, n_cols, dtype,
                        tile=128, spill_frac=0.15, device="cuda"):
    """Bandwidth-reduce via row/col permutation (sparse/reorder.py), then
    build the slab operator on the permuted matrix. Returns a PermutedOp
    or None when even the permuted pattern has no usable band."""
    from cuopt_torch.sparse.reorder import (
        bandwidth_permutation,
        permute_csr,
    )

    rp, cp = bandwidth_permutation(offsets, indices, n_rows, n_cols,
                                   tile=tile)
    if np.array_equal(rp, np.arange(n_rows)) and \
            np.array_equal(cp, np.arange(n_cols)):
        return None  # permutation found nothing better than identity
    p_offsets, p_indices, p_values = permute_csr(
        offsets, indices, values, rp, cp, n_rows, n_cols
    )
    inner = build_block_band(p_offsets, p_indices, p_values, n_rows,
                             n_cols, dtype, tile, spill_frac, device)
    if inner is None:
        return None
    inv_rp = np.empty(n_rows, np.int64)
    inv_rp[rp] = np.arange(n_rows)
    inv_cp = np.empty(n_cols, np.int64)
    inv_cp[cp] = np.arange(n_cols)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return PermutedOp(inner=inner, row_perm=t(rp), inv_row_perm=t(inv_rp),
                      col_perm=t(cp), inv_col_perm=t(inv_cp))


def _csr_to_ell(offsets, indices, values, n_rows, width, dtype):
    counts = np.diff(offsets)
    ell_vals = np.zeros((n_rows, width), dtype)
    ell_idx = np.zeros((n_rows, width), np.int64)
    if len(values):
        pos_in_row = np.arange(len(values)) - np.repeat(offsets[:-1], counts)
        rows = np.repeat(np.arange(n_rows), counts)
        ell_vals[rows, pos_in_row] = values
        ell_idx[rows, pos_in_row] = indices
    return ell_vals, ell_idx


def _transpose_csr(offsets, indices, values, n_rows, n_cols):
    """CSR -> CSC (i.e. CSR of A^T) on host."""
    nnz = len(values)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(offsets))
    order = np.argsort(indices, kind="stable")
    t_offsets = np.zeros(n_cols + 1, np.int64)
    np.add.at(t_offsets, indices + 1, 1)
    np.cumsum(t_offsets, out=t_offsets)
    return t_offsets, rows[order], values[order], nnz


def build_operator(
    offsets: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    n_rows: int,
    n_cols: int,
    dtype: torch.dtype = torch.float64,
    kind: str = "auto",
    ell_padding_limit: float = 4.0,
    dense_size_limit: int = 1 << 22,
    device="cuda",
) -> LinearOperator:
    """Build the operator for this sparsity pattern on `device`.

    kind: 'auto' | 'dense' | 'blockband' | 'bandperm' | 'ell' | 'csr'.
    auto: dense if n_rows*n_cols small; else blockband when the sparsity
    has usable band/staircase structure (directly or after a
    bandwidth-reducing permutation); else ELL when padded size is within
    ell_padding_limit x nnz; else CSR segment sum.
    """
    offsets = np.asarray(offsets, np.int64)
    indices = np.asarray(indices, np.int64)
    np_dtype = _np_dtype(dtype)
    values = np.asarray(values, np_dtype)
    nnz = len(values)

    if kind in ("auto", "blockband", "bandperm") and n_rows > 0 and \
            n_cols > 0 and \
            not (kind == "auto" and n_rows * n_cols <= dense_size_limit):
        if kind != "bandperm":
            op = build_block_band(offsets, indices, values, n_rows, n_cols,
                                  dtype, device=device)
            if op is not None:
                return op
        if kind in ("auto", "bandperm"):
            op = build_permuted_band(offsets, indices, values, n_rows,
                                     n_cols, dtype, device=device)
            if op is not None:
                return op
        if kind == "blockband":
            raise ValueError(
                "matrix has no usable band structure for 'blockband'"
            )
        if kind == "bandperm":
            raise ValueError(
                "matrix has no usable band structure even after "
                "bandwidth-reducing permutation"
            )

    if kind == "auto":
        if n_rows * n_cols <= dense_size_limit:
            kind = "dense"
        else:
            max_row = int(np.max(np.diff(offsets), initial=0))
            t_offsets, _, _, _ = _transpose_csr(
                offsets, indices, values, n_rows, n_cols
            )
            max_col = int(np.max(np.diff(t_offsets), initial=0))
            padded = n_rows * max_row + n_cols * max_col
            kind = "ell" if padded <= ell_padding_limit * 2 * max(nnz, 1) \
                else "csr"

    def t(a):
        return torch.as_tensor(a, device=device)

    if kind == "dense":
        A = np.zeros((n_rows, n_cols), np_dtype)
        if nnz:
            rows = np.repeat(
                np.arange(n_rows, dtype=np.int64), np.diff(offsets)
            )
            np.add.at(A, (rows, indices), values)
        return DenseOp(mat=t(A))

    t_offsets, t_indices, t_values, _ = _transpose_csr(
        offsets, indices, values, n_rows, n_cols
    )
    if kind == "ell":
        wr = max(int(np.max(np.diff(offsets), initial=0)), 1)
        wc = max(int(np.max(np.diff(t_offsets), initial=0)), 1)
        rv, ri = _csr_to_ell(offsets, indices, values, n_rows, wr, np_dtype)
        cv, ci = _csr_to_ell(
            t_offsets, t_indices, t_values, n_cols, wc, np_dtype
        )
        return EllOp(n_rows=n_rows, n_cols=n_cols, row_vals=t(rv),
                     row_cols=t(ri), col_vals=t(cv), col_rows=t(ci))
    if kind == "csr":
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(offsets))
        csc_cols = np.repeat(
            np.arange(n_cols, dtype=np.int64), np.diff(t_offsets)
        )
        return CsrOp(
            n_rows=n_rows, n_cols=n_cols,
            csr_vals=t(values), csr_rows=t(rows), csr_cols=t(indices),
            csc_vals=t(t_values), csc_rows=t(np.asarray(t_indices, np.int64)),
            csc_cols=t(csc_cols),
        )
    raise ValueError(f"unknown operator kind {kind!r}")
