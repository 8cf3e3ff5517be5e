"""Fused PDHG row pass over BlockBandOp row slabs: Ax -> dual prox -> A^T y.

Counterpart of cuopt_tpu/lp/pdhg_pallas.py. Because the PDLP dual
proximal step is elementwise in the constraint index, the chain

    Ax_new  ->  y_new = prox(y, Ax~)  ->  A^T y_new

is one pass over the row slabs of A: each 128-row tile multiplies its
dense slab by its x window, applies the two-sided dual prox to its rows
and adds y_tile^T slab_tile into A^T y over the same window. A is read
once per step attempt instead of twice.

On a CUDA tensor the pass runs the hand-written kernels of
cuopt_torch/csrc/row_pass.cu; on a CPU tensor it runs their plain
PyTorch version (`row_pass_reference`). Nothing falls back: a CUDA call
launches the kernel or raises. Up to a window width of W_COLUMN_SPLIT the
kernel reads each slab byte from device memory once: it adds each row
into A^T y as soon as the row's y_new is known. Windows up to W_ONE_PASS
take the one-pass body (a warp per row), wider ones the column-split body
(the window's columns split across the warps); windows wider still take
a body that reads the slab a second time for the transpose. The width
alone picks the body (`body_of_width`; `kernel_config` says what ran).

Two modes, as cuopt_tpu has two kernels:
  - "atomic" (cuopt_tpu `_kernel`): tiles add their A^T y parts into a
    zeroed vector with atomicAdd; the sum order varies from run to run.
  - "partials" (cuopt_tpu `_kernel_stream` and the segment sum after it):
    tiles write their parts, and the tile that completes a 128-column
    block sums that block's parts in a fixed order inside the same
    launch, so two runs give the same bits.
The mode follows cuopt_tpu's selection rule (see PARTIALS_MIN_COLS).

Entries outside the slab windows (spill) are handled here in torch: the
Ax spill is computed from x_new BEFORE the pass (y_new needs the full
row activity), the A^T y spill from y_new AFTER it. float32 only, as the
TPU kernel; the f64 path keeps the unfused matvec/rmatvec pair.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from cuopt_torch.kernels.build import BUILDER
from cuopt_torch.sparse.ops import BlockBandOp, _segment_sum

# cuopt_tpu takes its streamed kernel once the padded column count
# exceeds 2^18 (_VMEM_RESIDENT_LIMIT, pdhg_pallas.py:250, :408), a limit
# of the TPU's VMEM. Here it only selects the mode, so that both packages
# run the counterpart kernels at the same sizes; nothing on the GPU is
# bounded by it. The port's bench will refit it.
PARTIALS_MIN_COLS = 1 << 18

# Widest windows of the one-pass and the column-split kernel bodies
# (W_ONE_PASS, W_COLUMN_SPLIT in csrc/row_pass.cu); wider windows run the
# two-read body.
W_ONE_PASS = 1024
W_COLUMN_SPLIT = 8192

_P = ctypes.c_void_p
_I = ctypes.c_int
# slabs, starts, T, W, n_rows, n_cols, then x .. y_out
_PASS_ARGS = [_P, _P, _I, _I, _I, _I] + [_P] * 9
_ATOMIC_ARGS = _PASS_ARGS + [_P, _P]  # aty, stream
# parts, cb_offsets, cb_rows, counters, n_blocks, aty, stream
_PARTIALS_ARGS = _PASS_ARGS + [_P, _P, _P, _P, _I, _P, _P]
CONFIG_ARGS = [_I, _I, _P]  # row_pass_config(W, partials, int info[6])
# row_pass_launches(partials, reset, unsigned long long* out); each
# source's <source>_launches takes (index, reset, out) likewise
COUNT_ARGS = [_I, _I, _P]
_CONFIG_KEYS = ("body", "threads", "registers", "smem_bytes",
                "local_bytes", "blocks_per_sm")
_BODIES = ("two-read", "one-pass", "column-split")  # row_pass_config codes


class Kernel:
    """One entry point of csrc/<source>.cu. `launches` is how many of its
    launches have run on the card: the kernel counts itself on the device
    as it runs (slot `index` of the source's launch counts, which its C
    function `<source>_launches` reads), so a launch that a CUDA graph recorded
    counts once at each replay that runs it and not at the capture.
    Reading or resetting the count waits for every device the wrapper
    launched on, so neither is done inside a capture."""

    def __init__(self, name: str, source: str, argtypes, replaces: str,
                 index: int):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.replaces = replaces
        self.index = index
        self._devices = set()  # the CUDA devices it was launched on
        self._fn = None

    def _library(self):
        if self._fn is None:
            lib = BUILDER.library(self.source)
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            count = getattr(lib, f"{self.source}_launches")
            count.argtypes = COUNT_ARGS
            count.restype = ctypes.c_int
            self._err, self._count = lib.cuda_error_string, count
            self._fn = fn
        return self._fn

    def _raise_on(self, err, what):
        if err != 0:
            raise RuntimeError(f"{self.name}: {what} failed: error {err} "
                               f"({self._err(err).decode()})")

    def __call__(self, *args):
        fn = self._library()
        self._devices.add(torch.cuda.current_device())
        self._raise_on(fn(*args), "CUDA launch")

    def _counts(self, reset: bool) -> int:
        n = 0
        for d in sorted(self._devices):
            out = ctypes.c_ulonglong()
            with torch.cuda.device(d):
                self._raise_on(self._count(self.index, int(reset),
                                           ctypes.byref(out)),
                               "reading its launch count")
            n += out.value
        return n

    @property
    def launches(self) -> int:
        return self._counts(reset=False)

    def reset(self) -> None:
        self._counts(reset=True)


# `replaces`: the TPU kernel body (_kernel, _kernel_stream); the partials
# kernel also does the segment sum that follows _kernel_stream
# (pdhg_pallas.py:428)
ROW_PASS_ATOMIC = Kernel(
    "row_pass_atomic", "row_pass", _ATOMIC_ARGS,
    "cuopt_tpu/lp/pdhg_pallas.py:99", index=0)
ROW_PASS_PARTIALS = Kernel(
    "row_pass_partials", "row_pass", _PARTIALS_ARGS,
    "cuopt_tpu/lp/pdhg_pallas.py:253", index=1)
KERNELS = (ROW_PASS_ATOMIC, ROW_PASS_PARTIALS)


def body_of_width(W: int) -> str:
    """The kernel body the row pass runs at window width W."""
    return ("one-pass" if W <= W_ONE_PASS else
            "column-split" if W <= W_COLUMN_SPLIT else "two-read")


def kernel_config(W: int, mode: str) -> dict:
    """What the row pass of `mode` runs at window width W on the current
    CUDA device: its body (`variant`, as `body_of_width` names it),
    threads per block, registers per thread, shared memory per block,
    local memory per thread and resident blocks per SM. Launches
    nothing."""
    fn = BUILDER.library("row_pass").row_pass_config
    fn.argtypes = CONFIG_ARGS
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(_CONFIG_KEYS))()
    err = fn(W, int(mode == "partials"), ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"row_pass_config: CUDA error {err}")
    out = dict(zip(_CONFIG_KEYS, info))
    out["variant"] = _BODIES[out.pop("body")]
    return out


class PlainCount:
    """How many times the pass took its plain version (CPU tensors)."""

    calls = 0


def reset_counts() -> None:
    for k in KERNELS:
        k.reset()
    PlainCount.calls = 0


def fused_pass_supported(op, dtype) -> bool:
    """Whether the fused row pass can serve this operator/dtype: an f32
    BlockBandOp with 128-row tiles and 128-aligned windows. Any window
    width and any column count is accepted."""
    return (isinstance(op, BlockBandOp) and dtype == torch.float32
            and op.row_slabs.dtype == torch.float32 and op.tile == 128
            and all(s % 128 == 0 for s in op.row_starts))


def _col_pad(op) -> int:
    """Padded column count: the windows may run past n_cols."""
    W = op.w_row
    max_end = max((s + W for s in op.row_starts), default=W)
    return max(max_end, -(-op.n_cols // 128) * 128)


@dataclass
class RowPassPlan:
    """Host-built, per-operator launch data."""

    starts: torch.Tensor      # (T,) int32 window starts, in columns
    n_cols_pad: int
    n_blocks: int             # ceil(n_cols / 128) output column blocks
    cb_offsets: torch.Tensor  # (n_blocks + 1,) int32
    cb_rows: torch.Tensor     # (E,) int32 rows of the (T*W/128, 128) parts
    cb_of_row: torch.Tensor   # (E,) int64 column block of each listed row
    covered: bool             # every column block has a listed row
    # (n_blocks,) int32 arrival counts of the partials kernel: zero
    # between launches (the kernel resets them), so two passes over one
    # operator must not run at the same time
    counters: torch.Tensor


def plan(op: BlockBandOp) -> RowPassPlan:
    """The operator's RowPassPlan, built once and kept on the operator."""
    p = getattr(op, "_row_pass_plan", None)
    if p is not None:
        return p
    T, WB = len(op.row_starts), op.w_row // 128
    n_blocks = -(-op.n_cols // 128)
    blk = ((np.asarray(op.row_starts, np.int64) // 128)[:, None]
           + np.arange(WB)[None, :]).reshape(-1)
    rows = np.arange(T * WB, dtype=np.int64)
    keep = blk < n_blocks  # window blocks past n_cols hold only zeros
    blk, rows = blk[keep], rows[keep]
    order = np.lexsort((rows, blk))  # by column block, then tile
    blk, rows = blk[order], rows[order]
    counts = np.bincount(blk, minlength=n_blocks)
    offsets = np.zeros(n_blocks + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    dev = op.row_slabs.device

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    p = RowPassPlan(
        starts=t(op.row_starts, torch.int32),
        n_cols_pad=_col_pad(op), n_blocks=n_blocks,
        cb_offsets=t(offsets, torch.int32), cb_rows=t(rows, torch.int32),
        cb_of_row=t(blk, torch.int64), covered=bool(np.all(counts > 0)),
        counters=torch.zeros(n_blocks, dtype=torch.int32, device=dev),
    )
    op._row_pass_plan = p
    return p


def pick_mode(op) -> str:
    return "partials" if plan(op).n_cols_pad > PARTIALS_MIN_COLS \
        else "atomic"


def row_pass_partials_reference(op, x, ax_old, ax_spill, y, lc0m, uc0m,
                                sigma):
    """Plain version of `row_pass_partials`, the pass up to the per-tile
    transpose parts: returns (ax_new, y_new, parts) with parts (T, W) =
    y_tile^T slab_t."""
    p = plan(op)
    T = op.row_slabs.shape[0]
    n_rows, n_cols = op.n_rows, op.n_cols
    xp = torch.cat([x, x.new_zeros(p.n_cols_pad - n_cols)])
    xw = xp[op.row_win]                                     # (T, W)
    ax = torch.bmm(op.row_slabs, xw.unsqueeze(2)).reshape(-1)[:n_rows]
    ax_new = ax if ax_spill is None else ax + ax_spill
    ax_tilde = 2.0 * ax_new - ax_old
    y_low = y + sigma * (lc0m - ax_tilde)
    y_high = y + sigma * (uc0m - ax_tilde)
    y_new = torch.where(y_low > 0.0, y_low,
                        torch.where(y_high < 0.0, y_high, 0.0))
    y_pad = torch.cat([y_new, y_new.new_zeros(T * 128 - n_rows)])
    parts = torch.bmm(y_pad.reshape(T, 1, 128), op.row_slabs)  # (T, 1, W)
    return ax_new, y_new, parts.reshape(T, -1)


def reduce_partials_reference(op, parts):
    """Plain version of the reduction folded into `row_pass_partials`:
    each 128-column block's window parts summed in the plan's
    (tile-ascending) order. On a CPU tensor index_add_ adds them one
    after another in that order, as the kernel does, so the two give the
    same bits; on a CUDA tensor the order varies. Column blocks no window
    touches are 0."""
    p = plan(op)
    dev = parts.device
    rows = parts.reshape(-1, 128)[p.cb_rows.to(dev).long()]
    return parts.new_zeros(p.n_blocks, 128).index_add_(
        0, p.cb_of_row.to(dev), rows).reshape(-1)[:op.n_cols]


def row_pass_reference(op, x, ax_old, ax_spill, y, lc0m, uc0m, sigma,
                       mode: str):
    """Plain PyTorch version of the kernels: same inputs and outputs as
    `row_pass`, on any device. Returns (ax_new, y_new, aty) with aty the
    slab part of A^T y_new (no spill)."""
    ax_new, y_new, parts = row_pass_partials_reference(
        op, x, ax_old, ax_spill, y, lc0m, uc0m, sigma)
    if mode == "atomic":
        aty = x.new_zeros(plan(op).n_cols_pad).index_add_(
            0, op.row_win.reshape(-1), parts.reshape(-1))[:op.n_cols]
    elif mode == "partials":
        aty = reduce_partials_reference(op, parts)
    else:
        raise ValueError(f"unknown row pass mode {mode!r}")
    return ax_new, y_new, aty


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"row pass: {name} must be a contiguous float32 tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def row_pass_kernel(op, x, ax_old, ax_spill, y, lc0m, uc0m, sigma,
                    mode: str, parts=None):
    """Launch `row_pass_atomic` or `row_pass_partials` on CUDA tensors.
    Returns (ax_new, y_new, aty). The partials kernel writes the per-tile
    parts to `parts` ((T, W) float32, allocated when None) on its way to
    aty.

    The partials kernel counts the tiles that have written each column
    block in the operator's plan (`RowPassPlan.counters`) and resets the
    counts as it finishes, so two partials passes over one operator must
    never overlap: not on two streams, and not as a CUDA-graph replay
    beside an eager launch. Overlapping passes would mix their counts and
    give a wrong aty with no error."""
    p = plan(op)
    dev = x.device
    T, W = op.row_slabs.shape[0], op.w_row
    n_rows, n_cols = op.n_rows, op.n_cols
    _check("row_slabs", op.row_slabs, (T, 128, W), dev)
    if op.row_slabs.data_ptr() % 16:
        raise ValueError("row pass: row_slabs must be 16-byte aligned (the "
                         "kernel reads them as float4)")
    _check("x", x, (n_cols,), dev)
    for name, v in (("ax_old", ax_old), ("y", y), ("lc", lc0m),
                    ("uc", uc0m)):
        _check(name, v, (n_rows,), dev)
    if ax_spill is not None:
        _check("ax_spill", ax_spill, (n_rows,), dev)
    _check("sigma", sigma.reshape(1), (1,), dev)
    if mode not in ("atomic", "partials"):
        raise ValueError(f"unknown row pass mode {mode!r}")
    ax_out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    y_out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (op.row_slabs.data_ptr(), p.starts.data_ptr(), T, W,
                n_rows, n_cols, x.data_ptr(), ax_old.data_ptr(),
                None if ax_spill is None else ax_spill.data_ptr(),
                y.data_ptr(), lc0m.data_ptr(), uc0m.data_ptr(),
                sigma.data_ptr(), ax_out.data_ptr(), y_out.data_ptr())
        if mode == "atomic":
            aty = torch.zeros(n_cols, dtype=torch.float32, device=dev)
            ROW_PASS_ATOMIC(*args, aty.data_ptr(), stream)
        else:
            if parts is None:
                parts = torch.empty(T, W, dtype=torch.float32, device=dev)
            _check("parts", parts, (T, W), dev)
            # the kernel writes every column block a window touches
            aty = (torch.empty if p.covered else torch.zeros)(
                n_cols, dtype=torch.float32, device=dev)
            ROW_PASS_PARTIALS(*args, parts.data_ptr(),
                              p.cb_offsets.data_ptr(), p.cb_rows.data_ptr(),
                              p.counters.data_ptr(), p.n_blocks,
                              aty.data_ptr(), stream)
    return ax_out, y_out, aty


def row_pass(op, x, ax_old, ax_spill, y, lc0m, uc0m, sigma,
             mode: str | None = None):
    """The pass itself, without spill: the kernels for CUDA tensors, the
    plain version for CPU tensors. `sigma` is a 0-d float32 tensor on the
    operator's device (the kernel reads it there: no host sync).
    Returns (ax_new, y_new, aty) with aty = (row slabs)^T y_new."""
    mode = mode or pick_mode(op)
    if x.device.type == "cpu":
        PlainCount.calls += 1
        return row_pass_reference(op, x, ax_old, ax_spill, y, lc0m, uc0m,
                                  sigma, mode)
    if x.device.type != "cuda":
        raise ValueError(f"row pass: no kernel for device {x.device}")
    return row_pass_kernel(op, x, ax_old, ax_spill, y, lc0m, uc0m, sigma,
                           mode)


def spilled_row_pass(op, x_new, ax_old, y, lc0m, uc0m, sigma,
                     mode: str | None = None):
    """The fused Ax -> dual prox -> A^T y pass with spill handling.

    Args (float32, on the operator's device): op BlockBandOp, x_new
    (n_cols,), ax_old (n_rows,) full activity at the current iterate, y
    (n_rows,), lc0m/uc0m masked constraint bounds (-/+ sentinel where
    infinite), sigma 0-d. mode: None picks by PARTIALS_MIN_COLS.

    Returns (ax_new, y_new, aty_new).

    On the card, two passes over one operator must not run at the same
    time (see `row_pass_kernel`: the partials mode keeps per-operator
    arrival counts)."""
    n_rows = op.n_rows
    spill = op.spill_vals.numel() > 0
    ax_spill = _segment_sum(op.spill_vals * x_new[op.spill_cols],
                            op.spill_rows, n_rows) if spill else None
    ax_new, y_new, aty_new = row_pass(op, x_new, ax_old, ax_spill, y,
                                      lc0m, uc0m, sigma, mode)
    if spill:
        # the kernel covers (row slabs)^T y, so the rest is the transpose
        # of the row-side spill: aty[c] += v * y_new[r] per (v, r, c)
        aty_new.index_add_(0, op.spill_cols, op.spill_vals
                           * y_new[op.spill_rows])
    return ax_new, y_new, aty_new


def fused_row_pass(op, x_new, ax_old, y, lc0m, uc0m, sigma,
                   mode: str | None = None):
    """`spilled_row_pass` and the step's two dot products over rows:
    returns (ax_new, y_new, aty_new, interaction_raw, dy_dot), with
    interaction_raw = dy.(ax_new - ax_old) (unsigned by the caller)."""
    ax_new, y_new, aty_new = spilled_row_pass(op, x_new, ax_old, y, lc0m,
                                              uc0m, sigma, mode)
    dy = y_new - y
    interaction = torch.dot(dy, ax_new - ax_old)
    dy_dot = torch.dot(dy, dy)
    return ax_new, y_new, aty_new, interaction, dy_dot
