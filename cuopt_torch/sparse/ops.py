"""Sparse linear operators for the constraint matrix A, over torch tensors.

The reference uses cusparse CSR SpMV (cpp/src/linear_programming/
cusparse_view.hpp:30) for the PDHG hot pair Ax / A^T y. The operator is
chosen per problem, with the same layouts as cuopt_tpu/sparse/ops.py
(the block band's built with tensor ops on the operator's device, the
others on the host):

  - DenseOp: A stored dense; matvec is one matrix-vector product.
  - EllOp: ELLPACK (padded fixed-width rows) for A and for A^T.
  - CsrOp: flat nnz gather + segment sum (index_add_).
  - BlockBandOp: dense 128-row slabs over per-tile column windows; the
    fused PDHG row pass (lp/pdhg_fused.py) streams its row slabs.
  - PermutedOp: a BlockBandOp under a bandwidth-reducing permutation.

Every operator holds its tensors on one device and supports matvec,
rmatvec, rescale (diag(r) A diag(c), returning a new operator) and the
abs reductions used by Ruiz / Pock-Chambolle scaling. `shard_operator`
splits one over a mesh (parallel/sharding.py) into Sharded* forms that
compute one shard's rows of Ax and columns of A^T y with explicit
collectives, and `halo_attempt` is a PDHG attempt on one shard of a
block-band operator with a single halo exchange.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from cuopt_torch.utils.tracing import trace_scope


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
    replaces T slices), made on `device` from the T starts."""
    s = torch.tensor(starts, dtype=torch.int64, device=device)
    return s[:, None] + torch.arange(width, device=device)


@dataclass
class BlockBandOp(LinearOperator):
    """Banded block-dense operator: rows are tiled in groups of `tile`
    (128); each row tile stores a DENSE slab covering a 128-aligned
    column window placed over its nonzeros (densest-window heuristic).
    matvec is a batched (T, tile, W) x (T, W) product plus a small COO
    "spill" segment sum for the entries outside their tile's window. A
    transposed band (col tiles x row windows) of the same matrix serves
    rmatvec, with its own spill. The layout is that of
    cuopt_tpu/sparse/ops.py:198, bit for bit; build_block_band computes
    it on the operator's device.
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


# ------------------------------------------------------- sharded operators
# The forms each operator takes on one shard of a mesh (parallel/
# sharding.py), following cuopt_tpu's _shard_operator (sharding.py:77-152).
# A shard holds its rows of y-space vectors and its columns of x-space ones
# (all of x when the layout replicates it); matvec maps the shard's x to its
# rows of Ax, rmatvec its y to its columns of A^T y (all of A^T y when x is
# replicated). The collectives go through `comm`, the shard's ShardComm,
# bound for the length of one run (`bind`). Scaling runs before sharding,
# so these forms need no rescale or abs reductions.
@dataclass
class _ShardedOp(LinearOperator):
    layout: object  # parallel.sharding.Layout
    rank: int
    comm: object = field(default=None, repr=False)

    @property
    def shape(self):
        return (self.layout.n_rows, self.layout.n_cols)

    @property
    def x_sharded(self) -> bool:
        return self.layout.col_splits is not None

    def bind(self, comm):
        return self.replace(comm=comm)

    @property
    def red(self):
        """Whole-problem reductions of this shard's partials."""
        from cuopt_torch.parallel.sharding import ShardReduce

        return ShardReduce(self.comm, self.layout)

    def _x_full(self, x):
        return self.comm.all_gather(x) if self.x_sharded else x

    def _own_cols(self, v):
        c0, c1 = self.layout.cols(self.rank)
        return v[c0:c1]

    def _own_rows(self, v):
        r0, r1 = self.layout.rows(self.rank)
        return v[r0:r1]


@dataclass
class ShardedDenseOp(_ShardedOp):
    """Row block of A: Ax from the whole x, A^T y as a partial over the
    shard's rows plus a psum."""

    mat: torch.Tensor = None  # (rows of the shard, n_cols)

    def matvec(self, x):
        return self.mat @ self._x_full(x)

    def rmatvec(self, y):
        return self._own_cols(self.comm.psum(self.mat.T @ y))


@dataclass
class ShardedEllOp(_ShardedOp):
    """Row-ELL of the shard's rows (global column indices) and the
    column-ELL of its columns (all columns when x is replicated), which
    reads an all-gathered y."""

    row_vals: torch.Tensor = None
    row_cols: torch.Tensor = None
    col_vals: torch.Tensor = None
    col_rows: torch.Tensor = None

    def matvec(self, x):
        return (self.row_vals * self._x_full(x)[self.row_cols]).sum(1)

    def rmatvec(self, y):
        y_full = self.comm.all_gather(y)
        return (self.col_vals * y_full[self.col_rows]).sum(1)


@dataclass
class ShardedCsrOp(_ShardedOp):
    """A 1/D chunk of each nonzero ordering, padded to a multiple of D by
    zero entries aimed at the last row or column (cuopt_tpu
    sharding.py:135-152): a partial segment sum over the whole output,
    psum'd, and the shard's block of it."""

    csr_vals: torch.Tensor = None
    csr_rows: torch.Tensor = None
    csr_cols: torch.Tensor = None
    csc_vals: torch.Tensor = None
    csc_rows: torch.Tensor = None
    csc_cols: torch.Tensor = None

    def matvec(self, x):
        part = _segment_sum(self.csr_vals * self._x_full(x)[self.csr_cols],
                            self.csr_rows, self.layout.n_rows)
        return self._own_rows(self.comm.psum(part))

    def rmatvec(self, y):
        y_full = self.comm.all_gather(y)
        part = _segment_sum(self.csc_vals * y_full[self.csc_rows],
                            self.csc_cols, self.layout.n_cols)
        full = self.comm.psum(part)
        return self._own_cols(full) if self.x_sharded else full


def pack_halos(xs, ys, Hx, Hy, side):
    """One buffer of halos: the last ("tail") or first ("head") Hx entries
    of each vector in xs, then Hy of each in ys. A halo is cut by its
    length, v[len(v) - H:], so a zero halo packs nothing. (cuopt_tpu
    writes v[-H:], sparse/ops.py:595, which is the WHOLE vector when H is
    0: with Hx == 0 < Hy its split below reads x data as the y halos.)"""
    def cut(v, H):
        return v[len(v) - H:] if side == "tail" else v[:H]

    return torch.cat([cut(v, Hx) for v in xs] + [cut(v, Hy) for v in ys])


def split_halos(buf, n_x, n_y, Hx, Hy):
    """The halos of pack_halos' buffer, in its order."""
    out, o = [], 0
    for H in [Hx] * n_x + [Hy] * n_y:
        out.append(buf[o:o + H])
        o += H
    return out


def _chain(D):
    """ppermute pairs of the open chain: to the next shard, to the
    previous one."""
    return ([(i, i + 1) for i in range(D - 1)],
            [(i + 1, i) for i in range(D - 1)])


@dataclass
class ShardedBlockBandOp(_ShardedOp):
    """The shard's row slabs (its 128-row tiles) and column slabs (its
    column tiles). Windows read the operand from an all-gathered vector
    (the general path), or, where cuopt_tpu's static gates pass
    (sparse/ops.py:321-322: tile counts and lengths divisible by D, no
    ragged last tile, every window within one neighbour's block), from
    the shard's block widened by a fixed halo that two neighbour
    ppermutes bring (`_halo_apply`). The spill stays with the shard that
    owns its row (row spill) or column (transpose spill).

    With a halo extension (`build_halo_extension`) the PDHG attempt runs
    as `halo_attempt`: one exchange per direction, then A x_new on row
    slabs widened by ty tiles each side, so that A^T y_new needs no
    second exchange."""

    tile: int = 128
    w_row: int = 0
    w_col: int = 0
    n_rows_loc: int = 0
    n_cols_loc: int = 0   # the shard's column-tile block
    row_slabs: torch.Tensor = None
    row_win: torch.Tensor = None   # (Tl, w_row) into the padded whole x
    col_slabs: torch.Tensor = None
    col_win: torch.Tensor = None   # (Tcl, w_col) into the padded whole y
    spill_vals: torch.Tensor = None
    spill_rows: torch.Tensor = None  # local rows
    spill_cols: torch.Tensor = None  # global columns
    t_spill_vals: torch.Tensor = None
    t_spill_rows: torch.Tensor = None  # local columns
    t_spill_cols: torch.Tensor = None  # global rows
    # fixed-halo applies: (H, (Tl, W) window index into the widened block)
    row_halo: tuple = None
    col_halo: tuple = None
    # the single-exchange attempt: (D, Lr, Lc, Hx, Hy, ty), the widened
    # row slabs (Tl + 2 ty, tile, w_row) and their windows into the
    # widened x, and the column slabs' windows into the widened y
    halo_meta: tuple = None
    ext_row_slabs: torch.Tensor = None
    ext_win: torch.Tensor = None
    halo_col_win: torch.Tensor = None

    def _halo_apply(self, v, H, win, slabs, n_out):
        fwd, bwd = _chain(self.comm.size)
        left = self.comm.ppermute(v[len(v) - H:], fwd)
        right = self.comm.ppermute(v[:H], bwd)
        width = win.shape[1]
        v_ext = torch.cat([left, v, right, v.new_zeros(width)])
        return torch.bmm(slabs, v_ext[win].unsqueeze(2)).reshape(-1)[:n_out]

    def matvec(self, x):
        if self.row_halo is not None:
            H, win = self.row_halo
            return self._halo_apply(x, H, win, self.row_slabs,
                                    self.n_rows_loc)
        x_full = self._x_full(x)
        xw = BlockBandOp._windows(x_full, self.row_win)
        out = torch.bmm(self.row_slabs, xw.unsqueeze(2)).reshape(-1)
        out = out[: self.n_rows_loc]
        if self.spill_vals.numel():
            out = out + _segment_sum(self.spill_vals * x_full[self.spill_cols],
                                     self.spill_rows, self.n_rows_loc)
        return out

    def rmatvec(self, y):
        if self.col_halo is not None:
            H, win = self.col_halo
            return self._halo_apply(y, H, win, self.col_slabs,
                                    self.n_cols_loc)
        y_full = self.comm.all_gather(y)
        yw = BlockBandOp._windows(y_full, self.col_win)
        out = torch.bmm(self.col_slabs, yw.unsqueeze(2)).reshape(-1)
        out = out[: self.n_cols_loc]
        if self.t_spill_vals.numel():
            out = out + _segment_sum(
                self.t_spill_vals * y_full[self.t_spill_cols],
                self.t_spill_rows, self.n_cols_loc)
        return out if self.x_sharded else self.comm.all_gather(out)


def halo_attempt(op: ShardedBlockBandOp, x, aty, c, lv, uv, ax, y,
                 lc0m, uc0m, tau, sigma, omega):
    """One PDHG attempt on one shard with a single halo exchange
    (cuopt_tpu sparse/ops.py:558). The halos of (x, aty, c, lv, uv) and
    (ax, y, lc0m, uc0m) ride one ppermute per direction; y_new is then
    computed again on the Hy rows each side (from the widened row slabs),
    so A^T y_new over the shard's own column tiles needs no second
    exchange: 2 ppermutes + 1 packed psum per attempt. The first shard
    receives zeros from the left and the last from the right, which the
    zero slabs there multiply.

    Returns (x_new, y_new, ax_new, aty_new, sums), sums the whole
    [dx.dx, x_new.x_new, dy.dy, dy.(ax_new - ax), y_new.y_new]. lc0m and
    uc0m are the row bounds with infinite sides at -+ the sentinel."""
    comm = op.comm
    D, Lr, Lc, Hx, Hy, ty = op.halo_meta
    xs = (x, aty, c, lv, uv)
    ys = (ax, y, lc0m, uc0m)
    fwd, bwd = _chain(D)
    left = split_halos(comm.ppermute(pack_halos(xs, ys, Hx, Hy, "tail"),
                                     fwd), 5, 4, Hx, Hy)
    right = split_halos(comm.ppermute(pack_halos(xs, ys, Hx, Hy, "head"),
                                      bwd), 5, 4, Hx, Hy)
    (x_e, aty_e, c_e, lv_e, uv_e, ax_e, y_e, lc0m_e, uc0m_e) = (
        torch.cat([lo, v, hi]) for lo, v, hi in zip(left, xs + ys, right))
    # primal step on the widened columns
    x_new_e = torch.clamp(x_e - tau * (c_e - aty_e), lv_e, uv_e)
    # A x_new over the widened row tiles (zero slabs past the ends)
    xp = torch.cat([x_new_e, x.new_zeros(op.w_row)])
    ax_new_e = torch.bmm(op.ext_row_slabs,
                         xp[op.ext_win].unsqueeze(2)).reshape(-1)
    # dual prox on the widened rows
    ax_tilde = 2.0 * ax_new_e - ax_e
    y_low = y_e + sigma * (lc0m_e - ax_tilde)
    y_high = y_e + sigma * (uc0m_e - ax_tilde)
    y_new_e = torch.where(y_low > 0.0, y_low,
                          torch.where(y_high < 0.0, y_high, 0.0))
    # A^T y_new over the shard's own column tiles
    yp = torch.cat([y_new_e, y.new_zeros(op.w_col)])
    aty_new = torch.bmm(op.col_slabs,
                        yp[op.halo_col_win].unsqueeze(2)).reshape(-1)[:Lc]
    x_new = x_new_e[Hx:Hx + Lc]
    ax_new = ax_new_e[Hy:Hy + Lr]
    y_new = y_new_e[Hy:Hy + Lr]
    dx = x_new - x
    dy = y_new - y
    sums = comm.psum(torch.stack([
        torch.dot(dx, dx), torch.dot(x_new, x_new), torch.dot(dy, dy),
        torch.dot(dy, ax_new - ax), torch.dot(y_new, y_new)]))
    return x_new, y_new, ax_new, aty_new, sums


@dataclass
class ShardedPermutedOp(_ShardedOp):
    """A PermutedOp on a mesh: the permutations replicated, the inner
    band sharded with the same layout. The solver never runs one (it
    absorbs the permutation into the problem, lp/pdlp.py); each product
    gathers the operand whole, permutes it, and gathers the inner
    result back."""

    inner: ShardedBlockBandOp = None
    row_perm: torch.Tensor = None
    inv_row_perm: torch.Tensor = None
    col_perm: torch.Tensor = None
    inv_col_perm: torch.Tensor = None

    def bind(self, comm):
        return self.replace(comm=comm, inner=self.inner.bind(comm))

    def matvec(self, x):
        xi = self._x_full(x)[self.col_perm]
        yi = self.inner.matvec(self._own_cols(xi) if self.x_sharded
                               else xi)
        return self._own_rows(self.comm.all_gather(yi)[self.inv_row_perm])

    def rmatvec(self, y):
        yi = self._own_rows(self.comm.all_gather(y)[self.row_perm])
        xi = self._x_full(self.inner.rmatvec(yi))[self.inv_col_perm]
        return self._own_cols(xi) if self.x_sharded else xi


def _halo_reach(starts, width, v_splits, t_splits):
    """The largest reach of any shard's windows beyond its own block of
    the operand (cuopt_tpu _halo_reach, sparse/ops.py:290), for the
    blocks v_splits and the tile blocks t_splits; None when a window
    reaches past a neighbour's block."""
    H = 0
    for d in range(len(v_splits) - 1):
        ss = starts[t_splits[d]:t_splits[d + 1]]
        if ss:
            H = max(H, v_splits[d] - min(ss),
                    max(s + width for s in ss) - v_splits[d + 1])
    L = min(b - a for a, b in zip(v_splits[:-1], v_splits[1:]))
    return H if H <= L else None


def _halo_win(starts, width, v0, H, device):
    """(T, width) window index into [left halo, block, right halo, pad]
    for a block starting at v0 (boundary tiles read index 0: their slabs
    are zero)."""
    off = np.maximum(np.asarray(starts, np.int64) - v0 + H, 0)
    return torch.as_tensor(np.add.outer(off, np.arange(width)),
                           device=device)


def _even(n, D):
    return tuple(int(v) for v in np.arange(D + 1) * (n // D))


def _shard_block_band(op: BlockBandOp, layout, mesh):
    """Per-shard ShardedBlockBandOps of `op` (tile-aligned layout)."""
    D, tile = mesh.size, op.tile
    T, Tc = len(op.row_starts), len(op.col_starts)
    # the column tiles split like the columns; when x is replicated, at
    # tile boundaries all the same (each shard computes its tiles' A^T y)
    col_splits = layout.col_splits or _tile_col_splits(op, D)
    rt = [s // tile for s in layout.row_splits[:-1]] + [T]
    ct = [s // tile for s in col_splits[:-1]] + [Tc]
    no_spill = not op.spill_vals.numel() and not op.t_spill_vals.numel()
    # the fixed-halo applies: cuopt_tpu's gates (sparse/ops.py:321-322),
    # and a layout whose blocks are the even ones those gates assume
    even_r = _even(op.n_rows, D)
    even_c = _even(op.n_cols, D)

    def gates(n_out, n_v, T_out, out_splits, v_splits):
        return (D > 1 and no_spill and T_out % D == 0 and n_v % D == 0
                and n_out % (tile * D) == 0 and n_out == T_out * tile
                and tuple(out_splits) == _even(n_out, D)
                and v_splits is not None and tuple(v_splits) == _even(n_v, D))

    H_row = H_col = None
    if gates(op.n_rows, op.n_cols, T, layout.row_splits, layout.col_splits):
        H_row = _halo_reach(op.row_starts, op.w_row, even_c,
                            [d * (T // D) for d in range(D + 1)])
    if gates(op.n_cols, op.n_rows, Tc, layout.col_splits,
             layout.row_splits):
        H_col = _halo_reach(op.col_starts, op.w_col, even_r,
                            [d * (Tc // D) for d in range(D + 1)])
    ops = []
    for d, device in enumerate(mesh.devices):
        r0, r1 = layout.row_splits[d], layout.row_splits[d + 1]
        c0, c1 = col_splits[d], col_splits[d + 1]

        def own(vals, rows, cols, lo, hi):
            m = (rows >= lo) & (rows < hi)
            return (vals[m].to(device), (rows[m] - lo).to(device),
                    cols[m].to(device))

        sv, sr, sc = own(op.spill_vals, op.spill_rows, op.spill_cols, r0, r1)
        tv, tr, tcl = own(op.t_spill_vals, op.t_spill_rows,
                          op.t_spill_cols, c0, c1)
        row_halo = col_halo = None
        if H_row is not None:
            row_halo = (H_row, _halo_win(op.row_starts[rt[d]:rt[d + 1]],
                                         op.w_row, even_c[d], H_row, device))
        if H_col is not None:
            col_halo = (H_col, _halo_win(op.col_starts[ct[d]:ct[d + 1]],
                                         op.w_col, even_r[d], H_col, device))
        ops.append(ShardedBlockBandOp(
            layout=layout, rank=d, tile=tile, w_row=op.w_row,
            w_col=op.w_col, n_rows_loc=r1 - r0, n_cols_loc=c1 - c0,
            row_slabs=op.row_slabs[rt[d]:rt[d + 1]].to(device),
            row_win=op.row_win[rt[d]:rt[d + 1]].to(device),
            col_slabs=op.col_slabs[ct[d]:ct[d + 1]].to(device),
            col_win=op.col_win[ct[d]:ct[d + 1]].to(device),
            spill_vals=sv, spill_rows=sr, spill_cols=sc,
            t_spill_vals=tv, t_spill_rows=tr, t_spill_cols=tcl,
            row_halo=row_halo, col_halo=col_halo))
    return build_halo_extension(op, ops, mesh)


def _tile_col_splits(op, D):
    from cuopt_torch.parallel.sharding import _tile_splits

    return _tile_splits(op.n_cols, op.tile, D)


def build_halo_extension(op: BlockBandOp, ops, mesh):
    """The single-exchange attempt's layout (cuopt_tpu sparse/ops.py:359),
    added to each shard's op, or the ops unchanged when a static gate
    fails. Shard d owns rows [d Lr, (d+1) Lr) and columns [d Lc,
    (d+1) Lc). Its column tiles read y at most Hy = ty * tile rows past
    its block, so the attempt computes y_new again on those rows, which
    needs ax_new there, which needs the row slabs of ty more tiles each
    side (zero past the ends) and x_new over an Hx-wide column halo."""
    D, tile = mesh.size, op.tile
    T, Tc = len(op.row_starts), len(op.col_starts)
    layout = ops[0].layout
    if (D <= 1 or op.n_rows % (tile * D) or op.n_cols % D
            or T % D or op.n_rows != T * tile
            or Tc % D or op.n_cols != Tc * tile
            or op.spill_vals.numel() or op.t_spill_vals.numel()
            or layout.col_splits is None):
        return ops
    Lr, Lc = op.n_rows // D, op.n_cols // D
    Tpd = T // D
    Hcol = _halo_reach(op.col_starts, op.w_col, _even(op.n_rows, D),
                       [d * (Tc // D) for d in range(D + 1)])
    if Hcol is None:
        return ops
    ty = -(-Hcol // tile)
    Hy = ty * tile
    if Hy > Lr:
        return ops
    rs = op.row_starts
    Hx = 0
    for d in range(D):
        for t in range(d * Tpd - ty, (d + 1) * Tpd + ty):
            if 0 <= t < T:
                Hx = max(Hx, d * Lc - rs[t], rs[t] + op.w_row - (d + 1) * Lc)
    if Hx > Lc:
        return ops
    out = []
    for d, (sop, device) in enumerate(zip(ops, mesh.devices)):
        lo, hi = d * Tpd - ty, (d + 1) * Tpd + ty
        z = op.row_slabs.new_zeros((ty,) + tuple(op.row_slabs.shape[1:]))
        parts = [z[:max(0, -lo)], op.row_slabs[max(lo, 0):min(hi, T)],
                 z[:max(0, hi - T)]]
        ext = torch.cat([p.to(device) for p in parts])
        starts = [rs[t] if 0 <= t < T else None for t in range(lo, hi)]
        off = np.array([0 if s is None else s - (d * Lc - Hx)
                        for s in starts], np.int64)
        ext_win = torch.as_tensor(np.add.outer(off, np.arange(op.w_row)),
                                  device=device)
        cst = np.asarray(op.col_starts[d * (Tc // D):(d + 1) * (Tc // D)],
                         np.int64)
        col_win = torch.as_tensor(
            np.add.outer(cst - (d * Lr - Hy), np.arange(op.w_col)),
            device=device)
        out.append(sop.replace(halo_meta=(D, Lr, Lc, Hx, Hy, ty),
                               ext_row_slabs=ext, ext_win=ext_win,
                               halo_col_win=col_win))
    return out


def shard_operator(op, layout, mesh) -> list:
    """The per-shard forms of `op` for `layout` on `mesh` (cuopt_tpu
    _shard_operator, sharding.py:77): unbound, one per mesh entry."""
    D = mesh.size
    devs = mesh.devices

    def base(d):
        return dict(layout=layout, rank=d)

    if isinstance(op, PermutedOp):
        inner = shard_operator(op.inner, layout, mesh)
        return [ShardedPermutedOp(
            **base(d), inner=inner[d], row_perm=op.row_perm.to(dev),
            inv_row_perm=op.inv_row_perm.to(dev),
            col_perm=op.col_perm.to(dev),
            inv_col_perm=op.inv_col_perm.to(dev))
            for d, dev in enumerate(devs)]
    if isinstance(op, BlockBandOp):
        return _shard_block_band(op, layout, mesh)
    if isinstance(op, DenseOp):
        return [ShardedDenseOp(**base(d), mat=op.mat[slice(
            *layout.rows(d))].to(dev)) for d, dev in enumerate(devs)]
    if isinstance(op, EllOp):
        out = []
        for d, dev in enumerate(devs):
            rows = slice(*layout.rows(d))
            cols = slice(*layout.cols(d))
            out.append(ShardedEllOp(
                **base(d), row_vals=op.row_vals[rows].to(dev),
                row_cols=op.row_cols[rows].to(dev),
                col_vals=op.col_vals[cols].to(dev),
                col_rows=op.col_rows[cols].to(dev)))
        return out
    if isinstance(op, CsrOp):
        pad = (-op.csr_vals.shape[0]) % D

        def padv(a, fill):
            return torch.cat([a, a.new_full((pad,), fill)])

        arrs = dict(
            csr_vals=padv(op.csr_vals, 0), csr_rows=padv(op.csr_rows,
                                                          op.n_rows - 1),
            csr_cols=padv(op.csr_cols, 0), csc_vals=padv(op.csc_vals, 0),
            csc_rows=padv(op.csc_rows, 0),
            csc_cols=padv(op.csc_cols, op.n_cols - 1))
        return [ShardedCsrOp(**base(d), **{
            k: v.chunk(D)[d].to(dev) for k, v in arrs.items()})
            for d, dev in enumerate(devs)]
    raise TypeError(f"no sharded form of {type(op).__name__}")


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


# ------------------------------------------------------------ band layout
_ALIGN = 128  # window starts are 128-aligned: the fused row pass
# (lp/pdhg_fused.py) and cuopt_tpu's Pallas kernel both take starts in
# 128-column units
# an empty tile's start before it is set to 0: above every column
_FAR = 2 ** 62


class _BandSide:
    """One side of the band layout: the nonzeros of a matrix of `n_axis`
    rows and `n_other` columns as row, column and value tensors in CSR
    order (rows ascending, as the CSR stores them), and what the window
    search of every candidate width shares. Everything is an exact
    tensor op on the device of the tensors, so the layout is the same on
    the card as on the CPU, and the same as cuopt_tpu's NumPy one.

    A nonzero's key is t * S + col, for its tile t and a stride S >= the
    column count that is a multiple of 128: `keys` holds them ascending.
    The candidate starts are the distinct keys of (t, col // 128 * 128),
    with the count of keys below each. `rank` numbers the repeats of a
    (row, column) in CSR order, 0 for the first."""

    def __init__(self, rows, cols, vals, n_axis, n_other, tile):
        self.rows, self.cols, self.vals, self.tile = rows, cols, vals, tile
        self.n_tiles = (n_axis + tile - 1) // tile
        self.stride = -(-n_other // _ALIGN) * _ALIGN
        self.t_of = rows // tile
        # sorted by (tile, column, row in the tile): keys in order, and
        # the repeats of a (row, column) side by side in CSR order
        by, order = torch.sort(
            (self.t_of * self.stride + cols) * tile + rows % tile,
            stable=True)
        self.keys = by // tile
        # a repeat's rank: its place in `by` less its first copy's place
        pos = torch.arange(len(by), device=rows.device)
        self.rank = torch.empty_like(pos).scatter_(
            0, order, pos - torch.searchsorted(by, by))
        self.cand = torch.unique_consecutive(self.keys // _ALIGN * _ALIGN)
        self.cand_t = self.cand // self.stride
        self.cand_c = self.cand - self.cand_t * self.stride
        self.cand_below = torch.searchsorted(self.keys, self.cand)

    def full_widths(self):
        """Per tile, the width a window from the 128-aligned start below
        its least column needs to cover all its nonzeros (0 if none), and
        the most repeats of one (row, column) beyond the first: one host
        read."""
        lo = self.t_of.new_full((self.n_tiles,), _FAR).scatter_reduce_(
            0, self.t_of, self.cols, "amin")
        hi = self.t_of.new_full((self.n_tiles,), -1).scatter_reduce_(
            0, self.t_of, self.cols, "amax")
        widths = torch.where(hi >= 0, hi - lo // _ALIGN * _ALIGN + 1, 0)
        most = self.rank.max().view(1) if len(self.rank) \
            else self.rank.new_zeros(1)
        read = torch.cat([widths, most]).cpu().numpy()
        return read[:-1], int(read[-1])

    def windows(self, W):
        """Each tile's window start for width W, where the window covers
        the most of the tile's nonzeros (of the starts that tie, the
        least, as np.argmax picks; 0 for a tile of none), and the mask of
        the nonzeros inside their tile's window."""
        end = self.cand + torch.clamp(self.stride - self.cand_c, max=W)
        cover = torch.searchsorted(self.keys, end) - self.cand_below
        best = self.t_of.new_zeros(self.n_tiles).scatter_reduce_(
            0, self.cand_t, cover, "amax")
        starts = self.t_of.new_full((self.n_tiles,), _FAR).scatter_reduce_(
            0, self.cand_t,
            torch.where(cover == best[self.cand_t], self.cand_c, _FAR),
            "amin")
        starts = torch.where(starts == _FAR, 0, starts)
        s = starts[self.t_of]
        return starts, (self.cols >= s) & (self.cols < s + W)

    def slabs(self, W, starts, inside, most):
        """(T, tile, W) slabs of the nonzeros inside their windows. The
        repeats of a (row, column) add up as np.add.at adds them, (0 +
        v1) + v2 + ... in CSR order: one round of adds per rank, rank 0
        first, and no slab element twice in a round."""
        flat = self.rows * W + self.cols - starts[self.t_of]
        out = torch.zeros(self.n_tiles * self.tile * W,
                          dtype=self.vals.dtype, device=flat.device)

        def add(m):
            i = flat[m]
            out[i] = out[i] + self.vals[m]

        add(inside & (self.rank == 0))
        if most:
            with trace_scope("sparse_layout_fold"):
                for k in range(1, most + 1):
                    add(inside & (self.rank == k))
        return out.view(self.n_tiles, self.tile, W)


def _band_slabs(rows, cols, vals, n_axis, n_other, tile, spill_frac=0.15):
    """Slab decomposition of a matrix of `n_axis` rows, given as the row,
    column and value tensors of its nonzeros in CSR order.

    Picks the window width W (multiple of `tile`) of least modeled cost
    among the full width (zero spill), per-tile-width quantiles and a
    geometric ladder, subject to the spill staying under spill_frac * nnz
    and the slab budgets. Returns (slabs (T, tile, W), starts tuple, W,
    (spill_vals, spill_rows, spill_cols)) as tensors on the device of the
    nonzeros, or None if every candidate blows the slab budget. The host
    reads the tiles' full widths, each candidate's spill count and the
    chosen starts."""
    side = _BandSide(rows, cols, vals, n_axis, n_other, tile)
    T = side.n_tiles
    nnz = len(vals)
    # slab budget: up to ~256 stored elements per nonzero, and 3 GiB
    elem_budget = max(256 * max(nnz, 1), 1 << 22)
    byte_budget = 3 << 30
    full_w, most = side.full_widths()

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
                slab_elems * vals.dtype.itemsize > byte_budget:
            continue
        starts, inside = side.windows(W)
        n_spill = nnz - int(inside.sum())
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
    out = ~inside
    spill = (vals[out], rows[out], cols[out])
    return (side.slabs(W, starts, inside, most),
            tuple(starts.tolist()), W, spill)


def build_block_band(offsets, indices, values, n_rows, n_cols, dtype,
                     tile=128, spill_frac=0.15, device="cuda"):
    """Build a BlockBandOp on `device`, or None when the matrix has no
    usable band structure (window blow-up guard in _band_slabs). The CSR
    goes to `device` once; both slab sets are laid out there (the
    transpose by a stable sort of the columns)."""
    with trace_scope("device_upload"):
        offsets, cols, vals = (
            torch.as_tensor(a).to(device) for a in (
                np.asarray(offsets, np.int64), np.asarray(indices, np.int64),
                np.asarray(values, _np_dtype(dtype))))
    with trace_scope("sparse_band_layout"):
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=cols.device), offsets.diff(),
            output_size=len(cols))
        row = _band_slabs(rows, cols, vals, n_rows, n_cols, tile, spill_frac)
        if row is None:
            return None
        t_rows, order = torch.sort(cols, stable=True)
        col = _band_slabs(t_rows, rows[order], vals[order], n_cols, n_rows,
                          tile, spill_frac)
        if col is None:
            return None
        row_slabs, row_starts, w_row, (sv, sr, sc) = row
        col_slabs, col_starts, w_col, (tv, tr, tc) = col
        return BlockBandOp(
            n_rows=n_rows, n_cols=n_cols, tile=tile,
            w_row=w_row, w_col=w_col,
            row_starts=row_starts, col_starts=col_starts,
            row_slabs=row_slabs, col_slabs=col_slabs,
            spill_vals=sv, spill_rows=sr, spill_cols=sc,
            t_spill_vals=tv, t_spill_rows=tr, t_spill_cols=tc,
        )


def build_permuted_band(offsets, indices, values, n_rows, n_cols, dtype,
                        tile=128, spill_frac=0.15, device="cuda"):
    """Bandwidth-reduce via row/col permutation (sparse/reorder.py,
    computed on `device`), then build the slab operator on the permuted
    matrix. Returns a PermutedOp or None when even the permuted pattern
    has no usable band."""
    from cuopt_torch.sparse.reorder import (
        bandwidth_permutation,
        permute_csr,
    )

    with trace_scope("sparse_reorder"):
        rp, cp = bandwidth_permutation(offsets, indices, n_rows, n_cols,
                                       tile=tile, device=device)
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

    with trace_scope("device_upload"):
        return PermutedOp(inner=inner, row_perm=t(rp),
                          inv_row_perm=t(inv_rp), col_perm=t(cp),
                          inv_col_perm=t(inv_cp))


# ----------------------------------------------------------- host builders
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
