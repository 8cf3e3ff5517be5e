"""The PDHG slot on the card: its vector and scalar work in four kernels.

A slot (lp/pdlp.py `_slot`) is one predicated attempt of an adaptive
PDHG step. Its products (the fused row pass, or the operator's matvec
and rmatvec) were always kernels; the rest of it, some 106 PyTorch ops,
60 of them on 0-d tensors, ran as one kernel node each in the slot's CUDA
graph. `kernel_slot` runs the same slot as

    pdhg_primal -> the products -> pdhg_row_sums -> pdhg_commit   (fused)
    pdhg_primal -> matvec -> pdhg_dual -> rmatvec -> pdhg_commit  (unfused)

with the hand-written kernels of cuopt_torch/csrc/pdhg_step.cu, in float32
and float64. The products are the ones `_attempt` runs.

The sums (dx.dx, x_new.x_new, dy.(ax_new - ax), dy.dy, y_new.y_new) are
taken in a fixed order: a partial sum per block of a fixed contiguous
chunk of the vector (`_split`), then every block of pdhg_commit sums the
partials itself and reaches the same step-size decision. So a slot's
bits do not depend on whether it ran eagerly or as a graph replay. Its
sums differ from `_slot`'s (torch.dot and .sum()) only in their order,
which moves the iterates in the last bits; the vectors and the decision
follow the same arithmetic, one rounding per operation.

Each kernel has a plain PyTorch version beside its wrapper
(`primal_reference`, ...), with the same partial sums; a wrapper given
CPU tensors takes the plain version, CUDA tensors launch the kernel.
`StepWork` holds the kernels' scratch, which the step driver allocates
with its buffers, so that a capture sees fixed addresses.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from cuopt_torch.lp.pdhg_fused import Kernel, spilled_row_pass

# A partial-sum block takes at least CHUNK elements; a vector gets at
# most MAX_PARTS partial sums, which every pdhg_commit block sums again.
CHUNK = 1024
MAX_PARTS = 256

# the state fields pdhg_commit writes: the slot's (pdlp._SLOT_FIELDS)
COMMIT_FIELDS = ("x", "y", "ax", "aty", "step_size", "sum_weights",
                 "avg_x", "avg_y", "avg_ax", "avg_aty",
                 "iters_since_restart", "total_steps", "total_attempts",
                 "numerical_error")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# dbl, m, n_sent, chunk, blocks; x .. uc0m; stream
PRIMAL_ARGS = [_I] * 5 + [_P] * 16 + [_P]
# dbl, n, chunk, blocks; ax_new .. parts; stream
DUAL_ARGS = [_I] * 4 + [_P] * 10 + [_P]
ROW_SUMS_ARGS = [_I] * 4 + [_P] * 5 + [_P]
# dbl, m, n, bx, by, max_attempts; the two powers; parts .. out_pending;
# stream
COMMIT_ARGS = [_I] * 6 + [_D] * 2 + [_P] * 36 + [_P]

_REPLACES = ("none: cuopt_tpu/lp/pdlp.py _attempt and _accept are jnp "
             "code that XLA fuses")
PDHG_PRIMAL = Kernel("pdhg_primal", "pdhg_step", PRIMAL_ARGS, _REPLACES,
                     index=0)
PDHG_DUAL = Kernel("pdhg_dual", "pdhg_step", DUAL_ARGS, _REPLACES,
                   index=1)
PDHG_ROW_SUMS = Kernel("pdhg_row_sums", "pdhg_step", ROW_SUMS_ARGS,
                       _REPLACES, index=2)
PDHG_COMMIT = Kernel("pdhg_commit", "pdhg_step", COMMIT_ARGS, _REPLACES,
                     index=3)
KERNELS = (PDHG_PRIMAL, PDHG_DUAL, PDHG_ROW_SUMS, PDHG_COMMIT)


def reset_counts() -> None:
    for k in KERNELS:
        k.reset()


def _split(length: int) -> tuple[int, int]:
    """(blocks, chunk) of a vector's partial sums: block b sums elements
    [b * chunk, (b + 1) * chunk), at least CHUNK of them, at most
    MAX_PARTS blocks."""
    if length == 0:
        return 0, CHUNK
    blocks = max(1, min(length // CHUNK, MAX_PARTS))
    chunk = -(-length // blocks)
    return -(-length // chunk), chunk


def _block_sums(v, blocks: int, chunk: int):
    """The partial sums `_split` gives, of the vector v."""
    pad = v.new_zeros(blocks * chunk - v.numel())
    return torch.cat([v, pad]).reshape(blocks, chunk).sum(1)


@dataclass
class StepWork:
    """The slot kernels' scratch for one problem and dtype: the candidate
    x_new, y_new (unfused path; the row pass allocates its own), the
    masked bounds lc0m / uc0m (fused path), sigma (0-d) and the partial
    sums: (2, bx) over columns, then (3, by) over rows."""

    fused: bool
    bx: int
    chunk_x: int
    by: int
    chunk_y: int
    x_new: torch.Tensor
    y_new: torch.Tensor | None
    lc0m: torch.Tensor | None
    uc0m: torch.Tensor | None
    sigma: torch.Tensor
    parts: torch.Tensor

    def sums(self):
        """Views of the partial sums: dx.dx, x_new.x_new, dy.(ax_new -
        ax), dy.dy, y_new.y_new."""
        bx, by = self.bx, self.by
        return (self.parts[:bx], self.parts[bx:2 * bx],
                self.parts[2 * bx:2 * bx + by],
                self.parts[2 * bx + by:2 * bx + 2 * by],
                self.parts[2 * bx + 2 * by:])


def step_work(dev, s, fused: bool) -> StepWork:
    """Scratch for the slots of problem `dev` from states like `s`;
    `fused` says whether the attempt runs the fused row pass."""
    n, m = dev.op.shape
    (bx, cx), (by, cy) = _split(m), _split(n)

    def vec(k):
        return torch.empty(k, dtype=s.x.dtype, device=s.x.device)

    return StepWork(fused=fused, bx=bx, chunk_x=cx, by=by, chunk_y=cy,
                    x_new=vec(m), y_new=None if fused else vec(n),
                    lc0m=vec(n) if fused else None,
                    uc0m=vec(n) if fused else None,
                    sigma=vec(()), parts=vec(2 * bx + 3 * by))


# ================================================================ wrappers
def _on_card(t) -> bool:
    """CPU tensors take the plain versions, CUDA tensors the kernels."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"pdhg step: no kernel for device {t.device}")
    return True


def _check(tensors: dict, dtype, device):
    for name, (t, shape) in tensors.items():
        if t.dtype != dtype or t.device != device or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"pdhg step: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _dbl(dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pdhg step: no kernel for {dtype}")
    return int(dtype == torch.float64)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def primal(dev, s, work: StepWork) -> None:
    """x_new, sigma, the column partial sums and, on the fused path, lc0m
    and uc0m into `work`, from the state's x, aty, step size and primal
    weight."""
    if not _on_card(s.x):
        return primal_reference(dev, s, work)
    n, m = dev.op.shape
    dt, d = s.x.dtype, s.x.device
    vecs = dict(x=s.x, aty=s.aty, c=dev.c, lv=dev.lv, uv=dev.uv,
                x_new=work.x_new)
    rows = dict(lc0=dev.lc0, uc0=dev.uc0, lc0m=work.lc0m, uc0m=work.uc0m)
    checks = {k: (v, (m,)) for k, v in vecs.items()}
    checks.update(step_size=(s.step_size, ()),
                  primal_weight=(s.primal_weight, ()),
                  sigma=(work.sigma, ()), parts=(work.parts,
                                                 tuple(work.parts.shape)))
    if work.fused:
        checks.update({k: (v, (n,)) for k, v in rows.items()})
        _check(dict(lc_fin=(dev.lc_fin, (n,)), uc_fin=(dev.uc_fin, (n,))),
               torch.bool, d)
    _check(checks, dt, d)
    sent = (dev.lc_fin, dev.uc_fin, dev.lc0, dev.uc0, work.lc0m,
            work.uc0m) if work.fused else (None,) * 6
    with torch.cuda.device(d):
        PDHG_PRIMAL(_dbl(dt), m, n if work.fused else 0, work.chunk_x,
                    work.bx, s.x.data_ptr(), s.aty.data_ptr(),
                    dev.c.data_ptr(), dev.lv.data_ptr(), dev.uv.data_ptr(),
                    s.step_size.data_ptr(), s.primal_weight.data_ptr(),
                    work.x_new.data_ptr(), work.sigma.data_ptr(),
                    work.parts.data_ptr(),
                    *(None if t is None else t.data_ptr() for t in sent),
                    _stream(d))


def dual(dev, s, ax_new, work: StepWork):
    """The unfused path's dual prox at ax_new into work.y_new, with the
    row partial sums; returns work.y_new."""
    if not _on_card(s.x):
        return dual_reference(dev, s, ax_new, work)
    n = dev.op.shape[0]
    dt, d = s.x.dtype, s.x.device
    _check({k: (v, (n,)) for k, v in dict(
        ax_new=ax_new, ax=s.ax, y=s.y, lc0=dev.lc0, uc0=dev.uc0,
        y_new=work.y_new).items()} | dict(sigma=(work.sigma, ())), dt, d)
    _check(dict(lc_fin=(dev.lc_fin, (n,)), uc_fin=(dev.uc_fin, (n,))),
           torch.bool, d)
    with torch.cuda.device(d):
        PDHG_DUAL(_dbl(dt), n, work.chunk_y, work.by, ax_new.data_ptr(),
                  s.ax.data_ptr(), s.y.data_ptr(), dev.lc_fin.data_ptr(),
                  dev.uc_fin.data_ptr(), dev.lc0.data_ptr(),
                  dev.uc0.data_ptr(), work.sigma.data_ptr(),
                  work.y_new.data_ptr(), work.sums()[2].data_ptr(),
                  _stream(d))
    return work.y_new


def row_sums(s, ax_new, y_new, work: StepWork) -> None:
    """The row partial sums of the fused path, from the pass's y_new."""
    if not _on_card(s.x):
        return row_sums_reference(s, ax_new, y_new, work)
    n = s.y.shape[0]
    dt, d = s.x.dtype, s.x.device
    _check({k: (v, (n,)) for k, v in dict(
        ax_new=ax_new, ax=s.ax, y=s.y, y_new=y_new).items()}, dt, d)
    with torch.cuda.device(d):
        PDHG_ROW_SUMS(_dbl(dt), n, work.chunk_y, work.by, ax_new.data_ptr(),
                      s.ax.data_ptr(), s.y.data_ptr(), y_new.data_ptr(),
                      work.sums()[2].data_ptr(), _stream(d))


def commit(s, pending, cfg, out, out_pending, work: StepWork, ax_new,
           y_new, aty_new) -> None:
    """The attempt's step-size decision from the partial sums, and the
    commit of the candidate (work.x_new, y_new, ax_new, aty_new) into
    `out`'s COMMIT_FIELDS and `out_pending`, as `_slot` commits."""
    if not _on_card(s.x):
        return commit_reference(s, pending, cfg, out, out_pending, work,
                                ax_new, y_new, aty_new)
    n, m = s.y.shape[0], s.x.shape[0]
    dt, d = s.x.dtype, s.x.device
    cols = dict(x_new=work.x_new, aty_new=aty_new)
    rows = dict(y_new=y_new, ax_new=ax_new)
    for f in ("x", "aty", "avg_x", "avg_aty"):
        cols[f], cols[f"out.{f}"] = getattr(s, f), getattr(out, f)
    for f in ("y", "ax", "avg_y", "avg_ax"):
        rows[f], rows[f"out.{f}"] = getattr(s, f), getattr(out, f)
    checks = {k: (v, (m,)) for k, v in cols.items()}
    checks.update({k: (v, (n,)) for k, v in rows.items()})
    for f in ("step_size", "primal_weight", "sum_weights"):
        checks[f] = (getattr(s, f), ())
    for f in ("step_size", "sum_weights"):
        checks[f"out.{f}"] = (getattr(out, f), ())
    checks["parts"] = (work.parts, tuple(work.parts.shape))
    _check(checks, dt, d)
    counts = ("iters_since_restart", "total_steps", "total_attempts")
    _check({f: (getattr(s, f), ()) for f in counts}
           | {f"out.{f}": (getattr(out, f), ()) for f in counts}
           | dict(pending=(pending, ()), out_pending=(out_pending, ())),
           torch.int64, d)
    _check(dict(numerical_error=(s.numerical_error, ()),
                out_numerical_error=(out.numerical_error, ())),
           torch.bool, d)
    hp = cfg.hp
    ins = (work.parts, work.x_new, y_new, ax_new, aty_new, s.x, s.y, s.ax,
           s.aty, s.avg_x, s.avg_y, s.avg_ax, s.avg_aty, s.step_size,
           s.primal_weight, s.sum_weights, *(getattr(s, f) for f in counts),
           s.numerical_error, pending)
    outs = (out.x, out.y, out.ax, out.aty, out.avg_x, out.avg_y, out.avg_ax,
            out.avg_aty, out.step_size, out.sum_weights,
            *(getattr(out, f) for f in counts), out.numerical_error,
            out_pending)
    with torch.cuda.device(d):
        PDHG_COMMIT(_dbl(dt), m, n, work.bx, work.by, cfg.max_step_attempts,
                    -hp.reduction_exponent, -hp.growth_exponent,
                    *(t.data_ptr() for t in ins + outs), _stream(d))


def _slot_of(primal_, dual_, row_sums_, commit_, dev, s, pending, cfg, out,
             out_pending, work: StepWork) -> None:
    primal_(dev, s, work)
    if work.fused:
        ax_new, y_new, aty_new = spilled_row_pass(
            dev.op, work.x_new, s.ax, s.y, work.lc0m, work.uc0m, work.sigma)
        row_sums_(s, ax_new, y_new, work)
    else:
        ax_new = dev.op.matvec(work.x_new)
        y_new = dual_(dev, s, ax_new, work)
        aty_new = dev.op.rmatvec(y_new)
    commit_(s, pending, cfg, out, out_pending, work, ax_new, y_new, aty_new)


def kernel_slot(dev, s, pending, cfg, out, out_pending,
                work: StepWork) -> None:
    """`_slot` through the step kernels (their plain versions on CPU
    tensors): the same attempt, commit and next attempt index, written
    into `out` and `out_pending`."""
    _slot_of(primal, dual, row_sums, commit, dev, s, pending, cfg, out,
             out_pending, work)


def slot_reference(dev, s, pending, cfg, out, out_pending,
                   work: StepWork) -> None:
    """Plain version of `kernel_slot`, on any device."""
    _slot_of(primal_reference, dual_reference, row_sums_reference,
             commit_reference, dev, s, pending, cfg, out, out_pending, work)


# ========================================================= plain versions
def primal_reference(dev, s, work: StepWork) -> None:
    """Plain version of pdhg_primal: `_attempt`'s x_new, sigma and
    sentinel bounds, and the column partial sums."""
    eta, omega = s.step_size, s.primal_weight
    tau, sigma = eta / omega, eta * omega
    x_new = torch.clamp(s.x - tau * (dev.c - s.aty), dev.lv, dev.uv)
    dx = x_new - s.x
    work.x_new.copy_(x_new)
    work.sigma.copy_(sigma)
    dxdx, xx = work.sums()[:2]
    dxdx.copy_(_block_sums(dx * dx, work.bx, work.chunk_x))
    xx.copy_(_block_sums(x_new * x_new, work.bx, work.chunk_x))
    if work.fused:
        sent = torch.finfo(s.x.dtype).max / 8.0 / sigma.clamp(min=1.0)
        torch.where(dev.lc_fin, dev.lc0, -sent, out=work.lc0m)
        torch.where(dev.uc_fin, dev.uc0, sent, out=work.uc0m)


def _row_partials(s, ax_new, y_new, work: StepWork) -> None:
    dy = y_new - s.y
    inter, dydy, yy = work.sums()[2:]
    for out, v in ((inter, dy * (ax_new - s.ax)), (dydy, dy * dy),
                   (yy, y_new * y_new)):
        out.copy_(_block_sums(v, work.by, work.chunk_y))


def dual_reference(dev, s, ax_new, work: StepWork):
    """Plain version of pdhg_dual: `_attempt`'s two-sided dual prox into
    work.y_new, and the row partial sums; returns work.y_new."""
    big = torch.finfo(s.x.dtype).max
    sigma = work.sigma
    ax_tilde = 2.0 * ax_new - s.ax
    y_low = torch.where(dev.lc_fin, s.y + sigma * (dev.lc0 - ax_tilde), -big)
    y_high = torch.where(dev.uc_fin, s.y + sigma * (dev.uc0 - ax_tilde), big)
    torch.where(y_low > 0.0, y_low, torch.where(y_high < 0.0, y_high, 0.0),
                out=work.y_new)
    _row_partials(s, ax_new, work.y_new, work)
    return work.y_new


def row_sums_reference(s, ax_new, y_new, work: StepWork) -> None:
    """Plain version of pdhg_row_sums."""
    _row_partials(s, ax_new, y_new, work)


def commit_reference(s, pending, cfg, out, out_pending, work: StepWork,
                     ax_new, y_new, aty_new) -> None:
    """Plain version of pdhg_commit: the partials summed, `_attempt`'s
    step-size arithmetic, `_accept`'s state and `_slot`'s selection."""
    hp = cfg.hp
    dt = s.x.dtype
    dxdx, xx, inter, dydy, yy = (p.sum() for p in work.sums())
    eta, omega = s.step_size, s.primal_weight
    interaction = inter.abs()
    movement = 0.5 * omega * dxdx + 0.5 / omega * dydy
    eta_limit = torch.where(interaction > 0.0, movement / interaction,
                            torch.finfo(dt).max)
    valid = eta <= eta_limit
    k1 = (s.total_attempts + (pending + 2)).to(dt)
    eta_next = torch.minimum(
        (1.0 - k1 ** (-hp.reduction_exponent)) * eta_limit,
        (1.0 + k1 ** (-hp.growth_exponent)) * eta,
    )
    attempts = pending + 1
    commit_ = valid | (attempts >= cfg.max_step_attempts)
    sum_w = s.sum_weights + eta
    frac = eta / sum_w
    new = dict(x=work.x_new, y=y_new, ax=ax_new, aty=aty_new)
    for f, v in new.items():
        torch.where(commit_, v, getattr(s, f), out=getattr(out, f))
        avg = getattr(s, f"avg_{f}")
        torch.where(commit_, avg + frac * (v - avg), avg,
                    out=getattr(out, f"avg_{f}"))
    out.step_size.copy_(eta_next)
    torch.where(commit_, sum_w, s.sum_weights, out=out.sum_weights)
    for f in ("iters_since_restart", "total_steps"):
        torch.where(commit_, getattr(s, f) + 1, getattr(s, f),
                    out=getattr(out, f))
    torch.where(commit_, s.total_attempts + attempts, s.total_attempts,
                out=out.total_attempts)
    torch.where(commit_, s.numerical_error | ~torch.isfinite(xx)
                | ~torch.isfinite(yy), s.numerical_error,
                out=out.numerical_error)
    torch.where(commit_, torch.zeros_like(attempts), attempts,
                out=out_pending)
