"""PDLP: restarted primal-dual hybrid gradient LP solver, over torch tensors.

Counterpart of cuopt_tpu/lp/pdlp.py, which re-implements the reference
PDLP solver (cpp/src/linear_programming/pdlp.cu: run_solver :984,
take_step :1188; pdhg.cu:88-200). Here everything runs eagerly on one
device:

  - A major iteration is `major_iteration` PDHG steps, then termination
    information and the restart decision. All of it stays on the device;
    the host reads ONE packed tensor of scalars per major (the
    reference's termination readback cadence, pdlp.cu:1081).
  - The adaptive step-size loop over attempts (reference
    step_size_strategy/adaptive_step_size_strategy.hpp:35) is a
    predicated attempt (`_slot`): its `valid` flag decides on the device
    whether it commits, and the host runs slots in rounds and reads one
    step count a round (`PingPongMajor`, the reference's
    ping_pong_graph.cuh). On CUDA tensors with no mesh each slot is a
    replay of one of two CUDA graphs, and runs the step's vector and
    scalar work in the hand-written kernels of lp/pdhg_step.py
    (`kernel_slot`) around its products; on the CPU and on every shard
    of a mesh it runs eagerly as `_slot`. lp/batch.py runs its own masked
    loop over the same attempt.
  - On a CUDA float32 BlockBandOp every attempt runs the fused row pass
    (lp/pdhg_fused.py, kernels in csrc/row_pass.cu); otherwise the
    unfused matvec -> dual prox -> rmatvec chain.
  - An attempt (`_attempt`) and the end of a major (`major_tail`) are
    pure tensor code: lp/batch.py runs them under torch.func.vmap over a
    stack of same-shape problems.
  - On a mesh (parallel/sharding.py) the same code runs once per shard
    on the shard's rows: every sum, dot and maximum over a sharded
    vector goes through the shard's packed collectives (`_red`), and
    the step takes the single-exchange `halo_attempt` where the operator
    has a halo extension. Without a mesh each reduction is the plain
    torch call it always was, so the solo path keeps its bits.

Problem form (minimize):  min c^T x  s.t.  l_c <= Ax <= u_c,
l_v <= x <= u_v. The two-sided dual projection is the proximal step of
p(y) = l_c^T y+ - u_c^T y- (see PDLP paper, arXiv:2106.04756).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from cuopt_torch import constants as C
from cuopt_torch.lp.hyper_params import (
    PRESETS,
    PdlpHyperParams,
    RESTART_NONE,
    RESTART_TRUST_REGION,
)
from cuopt_torch.kernels.build import BUILDER
from cuopt_torch.lp import pdhg_step
from cuopt_torch.lp.pdhg_fused import (
    ROW_PASS_ATOMIC, fused_pass_supported, fused_row_pass)
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.parallel.sharding import (
    ShardedProblem,
    gather_state,
    shard_problem_and_state,
    sharded_major,
)
from cuopt_torch.sparse import PermutedOp, build_operator
from cuopt_torch.sparse.ops import halo_attempt, operator_from_arrays
from cuopt_torch.utils.logger import get_logger
from cuopt_torch.utils.timer import Timer
from cuopt_torch.utils.tracing import (
    debug_assert,
    maybe_start_profile,
    trace_scope,
)


# ============================================================== device data
@dataclass
class DeviceProblem:
    """Scaled problem + scales + original data, all on one device."""

    op: object  # scaled operator (R A C)
    # scaled vectors
    c: torch.Tensor
    lv: torch.Tensor
    uv: torch.Tensor
    lc: torch.Tensor
    uc: torch.Tensor
    # finite masks + zero-filled finite bounds (inf-safe arithmetic)
    lv_fin: torch.Tensor
    uv_fin: torch.Tensor
    lc_fin: torch.Tensor
    uc_fin: torch.Tensor
    lv0: torch.Tensor
    uv0: torch.Tensor
    lc0: torch.Tensor
    uc0: torch.Tensor
    # original (unscaled) vectors
    c_orig: torch.Tensor
    lv_orig: torch.Tensor
    uv_orig: torch.Tensor
    lc_orig: torch.Tensor
    uc_orig: torch.Tensor
    lv0_orig: torch.Tensor
    uv0_orig: torch.Tensor
    lc0_orig: torch.Tensor
    uc0_orig: torch.Tensor
    # scaling diagonals: A_scaled = diag(row_scale) A diag(col_scale)
    row_scale: torch.Tensor
    col_scale: torch.Tensor
    offset: torch.Tensor  # objective offset (0-d)
    # bandwidth-reducing permutation absorbed into the problem (None when
    # the operator needed none): the solver runs in permuted space and
    # the host driver un-permutes the solution vectors at extraction
    row_perm: torch.Tensor | None = None   # dev row i = user row rp[i]
    inv_row_perm: torch.Tensor | None = None
    col_perm: torch.Tensor | None = None
    inv_col_perm: torch.Tensor | None = None


@dataclass
class SolverState:
    x: torch.Tensor
    y: torch.Tensor
    ax: torch.Tensor
    aty: torch.Tensor
    step_size: torch.Tensor
    primal_weight: torch.Tensor
    # weighted average (restart-to-average)
    sum_weights: torch.Tensor
    avg_x: torch.Tensor
    avg_y: torch.Tensor
    avg_ax: torch.Tensor
    avg_aty: torch.Tensor
    # restart bookkeeping
    x_last_restart: torch.Tensor
    y_last_restart: torch.Tensor
    last_restart_kkt: torch.Tensor
    last_candidate_kkt: torch.Tensor
    iters_since_restart: torch.Tensor  # int64
    # counters (int64)
    total_steps: torch.Tensor  # accepted PDHG steps
    total_attempts: torch.Tensor  # including step-size rejections
    numerical_error: torch.Tensor  # bool

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StaticCfg:
    hp: PdlpHyperParams
    abs_primal: float
    rel_primal: float
    abs_dual: float
    rel_dual: float
    abs_gap: float
    rel_gap: float
    detect_infeasibility: bool = False
    primal_inf_tol: float = 1e-8
    dual_inf_tol: float = 1e-8
    max_step_attempts: int = 64
    # fused row pass (lp/pdhg_fused.py): "auto" = on for a CUDA float32
    # operator the gate accepts; "on" = also on CPU tensors, through the
    # pass's plain version (tests); "off" = always the unfused chain
    fused_kernel: str = "auto"


# ============================================================ residual math
def _max0(v):
    """max(0, max(v)), 0 for an empty vector (jnp.max(..., initial=0))."""
    if v.numel() == 0:
        return v.new_zeros(())
    return v.amax().clamp(min=0.0)


def _red(dev):
    """The whole-problem reductions of one shard of a mesh
    (parallel/sharding.py ShardReduce: `psum` and `pmax` of local
    partials, each tagged "x" or "y" for the vector space it ran over),
    or None for an unsharded problem, whose partials are already whole."""
    return getattr(dev.op, "red", None)


def _lagrangian_info(c, lv0, uv0, lc0, uc0, lv_fin, uv_fin, lc_fin, uc_fin,
                     offset, x, y, activity, aty, red=None):
    """Primal/dual objectives, residual norms and gap for an iterate.

    Mirrors reference convergence_information.cu (primal residual =
    constraint-bound violation; dual residual = reduced-cost components not
    attributable to finite variable bounds; dual objective = bound terms,
    utils.cuh:140-185)."""
    viol_low = torch.where(lc_fin, (lc0 - activity).clamp(min=0.0), 0.0)
    viol_high = torch.where(uc_fin, (activity - uc0).clamp(min=0.0), 0.0)
    primal_res = viol_low + viol_high

    r = c - aty  # reduced costs
    rp = r.clamp(min=0.0)
    rm = (-r).clamp(min=0.0)
    dual_res = torch.where(lv_fin, 0.0, rp) + torch.where(uv_fin, 0.0, rm)

    cx = torch.dot(c, x)
    yp = y.clamp(min=0.0)
    ym = (-y).clamp(min=0.0)
    dual_y = (torch.where(lc_fin, lc0 * yp, 0.0)
              - torch.where(uc_fin, uc0 * ym, 0.0)).sum()
    dual_x = (torch.where(lv_fin, lv0 * rp, 0.0)
              - torch.where(uv_fin, uv0 * rm, 0.0)).sum()
    pp = (primal_res * primal_res).sum()
    dd = (dual_res * dual_res).sum()
    linf_p, linf_d = _max0(primal_res), _max0(dual_res)
    if red is not None:
        cx, dual_y, dual_x, pp, dd = red.psum(
            [(cx, "x"), (dual_y, "y"), (dual_x, "x"), (pp, "y"), (dd, "x")])
        linf_p, linf_d = red.pmax([(linf_p, "y"), (linf_d, "x")])
    primal_obj = cx + offset
    dual_obj = dual_y + dual_x + offset
    return dict(
        primal_obj=primal_obj,
        dual_obj=dual_obj,
        gap=(primal_obj - dual_obj).abs(),
        l2_primal_res=torch.sqrt(pp),
        l2_dual_res=torch.sqrt(dd),
        linf_primal_res=linf_p,
        linf_dual_res=linf_d,
    )


def _scaled_info(dev: DeviceProblem, x, y, ax, aty):
    return _lagrangian_info(
        dev.c, dev.lv0, dev.uv0, dev.lc0, dev.uc0,
        dev.lv_fin, dev.uv_fin, dev.lc_fin, dev.uc_fin,
        dev.offset, x, y, ax, aty, _red(dev),
    )


def _unscaled_info(dev: DeviceProblem, x, y, ax, aty):
    """Transform scaled iterates to user space and evaluate residuals there.
    x_u = C x, y_u = R y, activity_u = ax / R, (A^T y)_u = aty / C."""
    return _lagrangian_info(
        dev.c_orig, dev.lv0_orig, dev.uv0_orig, dev.lc0_orig, dev.uc0_orig,
        dev.lv_fin, dev.uv_fin, dev.lc_fin, dev.uc_fin,
        dev.offset,
        x * dev.col_scale, y * dev.row_scale,
        ax / dev.row_scale, aty / dev.col_scale, _red(dev),
    )


def _kkt_score(info, omega):
    """KKT score sqrt(w^2 rp^2 + rd^2/w^2 + gap^2) (reference
    pdlp_restart_strategy.cu kernel_compute_kkt_score :367-375)."""
    return torch.sqrt(
        omega * omega * info["l2_primal_res"] ** 2
        + info["l2_dual_res"] ** 2 / (omega * omega)
        + info["gap"] ** 2
    )


# ================================================================ PDHG step
def _use_fused(dev: DeviceProblem, dtype, cfg: StaticCfg) -> bool:
    """Whether the step runs the fused row pass (lp/pdhg_fused.py)."""
    if cfg.fused_kernel == "off":
        return False
    # a shard of a mesh runs the plain products, as cuopt_tpu turns its
    # Pallas pass off under a mesh (pdhg_pallas.py:52-53)
    if getattr(dev.op, "comm", None) is not None:
        return False
    if not fused_pass_supported(dev.op, dtype):
        return False
    if cfg.fused_kernel == "on":
        return True
    return dev.op.row_slabs.is_cuda


def _attempt(dev: DeviceProblem, s: SolverState, cfg: StaticCfg, grad,
             eta, attempts):
    """One attempt of a PDHG step at step size `eta`, the attempt's
    0-based index within the step being `attempts`. Returns (candidate
    iterate dict, valid, next step size). Pure tensor code with no host
    sync, so lp/batch.py runs it under torch.func.vmap."""
    hp = cfg.hp
    omega = s.primal_weight
    dt = s.x.dtype
    big = torch.finfo(dt).max
    tau = eta / omega
    sigma = eta * omega
    x_new = torch.clamp(s.x - tau * grad, dev.lv, dev.uv)
    dx = x_new - s.x
    if _use_fused(dev, dt, cfg):
        # infinite-row sentinel scaled so sigma * sentinel cannot
        # overflow f32 (a 1e30 sentinel times sigma beyond ~3e8 is
        # inf, and a later inf-inf NaN); big/8/sigma keeps the product
        # at ~finfo.max/8, still decisively one-sided
        sent = big / 8.0 / sigma.clamp(min=1.0)
        lc0m = torch.where(dev.lc_fin, dev.lc0, -sent)
        uc0m = torch.where(dev.uc_fin, dev.uc0, sent)
        ax_new, y_new, aty_new, inter_raw, dy_dot = fused_row_pass(
            dev.op, x_new, s.ax, s.y, lc0m, uc0m, sigma)
        interaction = inter_raw.abs()
        movement = 0.5 * omega * torch.dot(dx, dx) + 0.5 / omega * dy_dot
        xx = torch.dot(x_new, x_new)
        yy = torch.dot(y_new, y_new)
    elif getattr(dev.op, "halo_meta", None) is not None:
        # one shard of a mesh, single-exchange attempt (sparse/ops.py
        # halo_attempt): 2 ppermutes + 1 packed psum
        sent = big / 8.0 / sigma.clamp(min=1.0)
        lc0m = torch.where(dev.lc_fin, dev.lc0, -sent)
        uc0m = torch.where(dev.uc_fin, dev.uc0, sent)
        x_new, y_new, ax_new, aty_new, sums = halo_attempt(
            dev.op, s.x, s.aty, dev.c, dev.lv, dev.uv, s.ax, s.y, lc0m,
            uc0m, tau, sigma, omega)
        dxdx, xx, dydy, inter_raw, yy = sums.unbind()
        interaction = inter_raw.abs()
        movement = 0.5 * omega * dxdx + 0.5 / omega * dydy
    else:
        ax_new = dev.op.matvec(x_new)
        ax_tilde = 2.0 * ax_new - s.ax
        # two-sided dual proximal step
        y_low = torch.where(dev.lc_fin,
                            s.y + sigma * (dev.lc0 - ax_tilde), -big)
        y_high = torch.where(dev.uc_fin,
                             s.y + sigma * (dev.uc0 - ax_tilde), big)
        y_new = torch.where(y_low > 0.0, y_low,
                            torch.where(y_high < 0.0, y_high, 0.0))
        aty_new = dev.op.rmatvec(y_new)
        dy = y_new - s.y
        dxdx = (dx * dx).sum()
        xx = (x_new * x_new).sum()
        dydy = (dy * dy).sum()
        inter_raw = (dy * (ax_new - s.ax)).sum()
        yy = (y_new * y_new).sum()
        red = _red(dev)
        if red is not None:
            # the five sums of the step in one packed psum (cuopt_tpu
            # _packed_sums, pdlp.py:227)
            dxdx, xx, dydy, inter_raw, yy = red.psum(
                [(dxdx, "x"), (xx, "x"), (dydy, "y"), (inter_raw, "y"),
                 (yy, "y")])
        interaction = inter_raw.abs()
        movement = 0.5 * omega * dxdx + 0.5 / omega * dydy
    eta_limit = torch.where(interaction > 0.0, movement / interaction, big)
    valid = eta <= eta_limit
    # iteration counter for the growth/reduction schedule: the current
    # attempt's 1-based global index plus one (PDLP counts iterations
    # from 1 at the first adaptive update)
    k1 = (s.total_attempts + (attempts + 2)).to(dt)
    eta_next = torch.minimum(
        (1.0 - k1 ** (-hp.reduction_exponent)) * eta_limit,
        (1.0 + k1 ** (-hp.growth_exponent)) * eta,
    )
    cand = dict(x=x_new, y=y_new, ax=ax_new, aty=aty_new, xx=xx, yy=yy)
    return cand, valid, eta_next


def _accept(s: SolverState, cand, eta, eta_next, attempts) -> SolverState:
    """The state after a step that accepted `cand` at step size `eta`
    after `attempts` attempts."""
    # weighted average update with weight = accepted step size
    sum_w = s.sum_weights + eta
    frac = eta / sum_w

    def upd(avg, new):
        return avg + frac * (new - avg)

    return s.replace(
        x=cand["x"], y=cand["y"], ax=cand["ax"], aty=cand["aty"],
        step_size=eta_next,
        sum_weights=sum_w,
        avg_x=upd(s.avg_x, cand["x"]),
        avg_y=upd(s.avg_y, cand["y"]),
        avg_ax=upd(s.avg_ax, cand["ax"]),
        avg_aty=upd(s.avg_aty, cand["aty"]),
        iters_since_restart=s.iters_since_restart + 1,
        total_steps=s.total_steps + 1,
        total_attempts=s.total_attempts + attempts,
        numerical_error=s.numerical_error | ~torch.isfinite(cand["xx"])
        | ~torch.isfinite(cand["yy"]),
    )


# ========================================================== infeasibility
def _ray_scores(dev: DeviceProblem, x_ray, y_ray):
    """Infeasibility certificates from ray candidates (reference
    termination_strategy/infeasibility_information.cu). Rays are in user
    (unscaled) space. A valid dual ray certifies primal infeasibility
    (max dual ray infeasibility ~ 0, dual ray objective > 0); a valid
    primal ray certifies dual infeasibility (max primal ray
    infeasibility ~ 0, c . x_ray < 0)."""
    eps = 1e-32
    red = _red(dev)
    y_norm = _max0(y_ray.abs())
    x_norm = _max0(x_ray.abs())
    if red is not None:
        y_norm, x_norm = red.pmax([(y_norm, "y"), (x_norm, "x")])
    # --- dual ray ---
    yn = y_ray / (y_norm + eps)
    yp = yn.clamp(min=0.0)
    ym = (-yn).clamp(min=0.0)
    # A^T y = C^-1 (R A C)^T R^-1 y for a user-space y. (cuopt_tpu
    # multiplies by R here, pdlp.py:416, which evaluates A^T R^2 y: on a
    # feasible LP whose row scales are far from 1 the certificate then
    # passes, and infeasibility detection stops the solve as INFEASIBLE.)
    aty_ray = dev.op.rmatvec(y_ray / dev.row_scale) / dev.col_scale / (
        y_norm + eps)
    r = -aty_ray
    rp = r.clamp(min=0.0)
    rm = (-r).clamp(min=0.0)
    maxes = [(_max0(torch.where(dev.lc_fin, 0.0, yp)), "y"),
             (_max0(torch.where(dev.uc_fin, 0.0, ym)), "y"),
             (_max0(torch.where(dev.lv_fin, 0.0, rp)), "x"),
             (_max0(torch.where(dev.uv_fin, 0.0, rm)), "x")]
    sums = [((torch.where(dev.lc_fin, dev.lc0_orig * yp, 0.0)
              - torch.where(dev.uc_fin, dev.uc0_orig * ym, 0.0)).sum(), "y"),
            ((torch.where(dev.lv_fin, dev.lv0_orig * rp, 0.0)
              - torch.where(dev.uv_fin, dev.uv0_orig * rm, 0.0)).sum(), "x")]
    # --- primal ray ---
    xn = x_ray / (x_norm + eps)
    ax_ray = dev.op.matvec(x_ray / dev.col_scale) / dev.row_scale / (
        x_norm + eps)
    both_c = dev.lc_fin & dev.uc_fin
    row_viol = torch.where(
        both_c, ax_ray.abs(),
        torch.where(dev.lc_fin, (-ax_ray).clamp(min=0.0),
                    torch.where(dev.uc_fin, ax_ray.clamp(min=0.0), 0.0)),
    )
    both_v = dev.lv_fin & dev.uv_fin
    var_viol = torch.where(
        both_v, xn.abs(),
        torch.where(dev.lv_fin, (-xn).clamp(min=0.0),
                    torch.where(dev.uv_fin, xn.clamp(min=0.0), 0.0)),
    )
    maxes += [(_max0(row_viol), "y"), (_max0(var_viol), "x")]
    sums.append((torch.dot(dev.c_orig, xn), "x"))
    if red is not None:
        maxes = [(v, sp) for v, (_, sp) in zip(red.pmax(maxes), maxes)]
        sums = [(v, sp) for v, (_, sp) in zip(red.psum(sums), sums)]
    (m_lc, _), (m_uc, _), (m_lv, _), (m_uv, _), (m_row, _), (m_var, _) = maxes
    (obj_y, _), (obj_x, _), (primal_ray_obj, _) = sums
    dual_viol = torch.maximum(torch.maximum(m_lc, m_uc),
                              torch.maximum(m_lv, m_uv))
    dual_ray_obj = obj_y + obj_x
    primal_viol = torch.maximum(m_row, m_var)
    return dict(
        has_dual_ray=y_norm > 0.0,
        max_dual_ray_infeasibility=dual_viol,
        dual_ray_objective=dual_ray_obj,
        has_primal_ray=x_norm > 0.0,
        max_primal_ray_infeasibility=primal_viol,
        primal_ray_objective=primal_ray_obj,
    )


def _infeasibility_flags(dev: DeviceProblem, s: SolverState,
                         cfg: StaticCfg):
    """Evaluate ray candidates: the iterate difference since the last
    restart and the current iterate (divergent iterates align with the
    ray for infeasible problems)."""
    x_cur = s.x * dev.col_scale
    y_cur = s.y * dev.row_scale
    x_diff = (s.x - s.x_last_restart) * dev.col_scale
    y_diff = (s.y - s.y_last_restart) * dev.row_scale
    primal_inf = torch.zeros((), dtype=torch.bool, device=s.x.device)
    dual_inf = torch.zeros_like(primal_inf)
    for xr, yr in ((x_diff, y_diff), (x_cur, y_cur)):
        sc = _ray_scores(dev, xr, yr)
        primal_inf = primal_inf | (
            sc["has_dual_ray"]
            & (sc["max_dual_ray_infeasibility"] <= cfg.primal_inf_tol)
            & (sc["dual_ray_objective"] > 0.0))
        dual_inf = dual_inf | (
            sc["has_primal_ray"]
            & (sc["max_primal_ray_infeasibility"] <= cfg.dual_inf_tol)
            & (sc["primal_ray_objective"] < 0.0))
    return primal_inf, dual_inf


# ====================================================== trust-region gap
_GROW_STEPS = 21  # mu_hi = 16^k from 1 passes the 1e24 cap at k = 20
_BISECT_STEPS = 40


def _localized_gap(dev: DeviceProblem, x, y, ax, aty, omega, xr, yr):
    """Normalized localized duality gap at radius r = ||z - z_ref||_w
    (reference restart_strategy/localized_duality_gap_container.cu; PDLP
    paper trust-region restart).

    Maximizes the linearized gap g^T d over {d : bounds, ||d||_w <= r}
    with a bisection on the trust-region multiplier. Returns g^T d / r.
    All in the scaled space, weights ||z||_w^2 = w||dx||^2 + ||dy||^2/w.
    The bracket search runs a fixed number of masked steps, so the
    result needs no host sync."""
    big = torch.full((), 1e30, dtype=x.dtype, device=x.device)
    eps = 1e-12
    red = _red(dev)

    def xy_sums(px, py):
        # every shard leaves the bracket and the bisection at the same
        # step: they read the same psum'd bits
        if red is None:
            return px, py
        return red.psum([(px, "x"), (py, "y")])

    sx, sy = xy_sums(((x - xr) ** 2).sum(), ((y - yr) ** 2).sum())
    r2 = omega * sx + sy / omega
    r = torch.sqrt(r2)

    # primal: maximize (-(c - A^T y))^T dx, dx in [lv - x, uv - x]
    g_x = aty - dev.c
    lo_x = torch.where(dev.lv_fin, dev.lv0 - x, -big)
    hi_x = torch.where(dev.uv_fin, dev.uv0 - x, big)

    # dual: supergradient of the bound term q(y) - Ax with q by sign(y);
    # at y == 0 pick the feasible direction with positive gradient
    g_up = torch.where(dev.lc_fin, dev.lc0 - ax, -big)  # d_y > 0 uses l_c
    g_dn = torch.where(dev.uc_fin, dev.uc0 - ax, big)   # d_y < 0 uses u_c
    pos = y > eps
    neg = y < -eps
    nonzero = pos | neg
    zero = ~nonzero
    g_y = torch.where(pos, g_up, torch.where(neg, g_dn, 0.0))
    lo_y = torch.where(nonzero, -big, 0.0)
    hi_y = torch.where(nonzero, big, 0.0)
    # at zero: up branch when it gains, else down branch when it gains
    up_gain = zero & dev.lc_fin & (g_up > 0.0)
    dn_gain = zero & ~up_gain & dev.uc_fin & (g_dn < 0.0)
    g_y = torch.where(up_gain, g_up, torch.where(dn_gain, g_dn, g_y))
    hi_y = torch.where(up_gain, big, hi_y)
    lo_y = torch.where(dn_gain, -big, lo_y)

    def d_of_mu(mu):
        dx = torch.clamp(g_x / (2.0 * mu * omega), lo_x, hi_x)
        dy = torch.clamp(g_y * omega / (2.0 * mu), lo_y, hi_y)
        return dx, dy

    def norm_w(dx, dy):
        sx, sy = xy_sums((dx * dx).sum(), (dy * dy).sum())
        return omega * sx + sy / omega

    # bracket: grow mu until the ball constraint holds
    mu_lo = torch.full((), 1e-16, dtype=x.dtype, device=x.device)
    n0 = norm_w(*d_of_mu(mu_lo))
    mu_hi = torch.ones((), dtype=x.dtype, device=x.device)
    n = n0
    for _ in range(_GROW_STEPS):
        grow = (n > r2) & (mu_hi < 1e24)
        n = torch.where(grow, norm_w(*d_of_mu(mu_hi)), n)
        mu_hi = torch.where(grow, mu_hi * 16.0, mu_hi)

    lo, hi = mu_lo, mu_hi
    for _ in range(_BISECT_STEPS):
        mid = torch.sqrt(lo * hi)  # geometric: mu spans many decades
        inside = norm_w(*d_of_mu(mid)) <= r2
        lo, hi = torch.where(inside, lo, mid), torch.where(inside, mid, hi)
    # if even mu_lo keeps us inside the ball, the box binds: use d(mu_lo)
    box_binds = n0 <= r2
    dx, dy = d_of_mu(torch.where(box_binds, mu_lo, hi))
    gx, gy = xy_sums(torch.dot(g_x, dx), torch.dot(g_y, dy))
    gain = gx + gy
    return torch.where(r > 0.0, gain / r.clamp(min=eps), float("inf"))


# ================================================================== restart
def _maybe_restart(dev: DeviceProblem, s: SolverState, cfg: StaticCfg,
                   kkt_cur, kkt_avg):
    """KKT-based restart decision + primal weight update (reference
    pdlp_restart_strategy.cu run_kkt_restart :499-636,
    compute_new_primal_weight_kernel). Both outcomes are selected with
    torch.where, so the decision stays on the device."""
    hp = cfg.hp
    dt = s.x.dtype
    if hp.never_restart_to_average:
        restart_to_avg = torch.zeros((), dtype=torch.bool,
                                     device=s.x.device)
        candidate_kkt = kkt_cur
    else:
        restart_to_avg = kkt_avg < kkt_cur
        candidate_kkt = torch.minimum(kkt_cur, kkt_avg)

    sufficient = candidate_kkt < (
        hp.sufficient_reduction_for_restart * s.last_restart_kkt)
    necessary = (candidate_kkt < hp.necessary_reduction_for_restart
                 * s.last_restart_kkt) & (candidate_kkt > s.last_candidate_kkt)
    if hp.artificial_restart_in_main_loop:
        artificial = s.iters_since_restart.to(dt) >= (
            hp.artificial_restart_threshold * s.total_steps.to(dt))
    else:
        artificial = torch.zeros_like(sufficient)
    do_restart = (sufficient | necessary | artificial) & (
        s.total_steps >= hp.min_iteration_restart)

    cand_x = torch.where(restart_to_avg, s.avg_x, s.x)
    cand_y = torch.where(restart_to_avg, s.avg_y, s.y)
    cand_ax = torch.where(restart_to_avg, s.avg_ax, s.ax)
    cand_aty = torch.where(restart_to_avg, s.avg_aty, s.aty)

    # primal weight update from distances traveled since last restart
    eps_guard = 1e-10
    px = ((cand_x - s.x_last_restart) ** 2).sum()
    py = ((cand_y - s.y_last_restart) ** 2).sum()
    red = _red(dev)
    if red is not None:
        px, py = red.psum([(px, "x"), (py, "y")])
    pdist = torch.sqrt(px)
    ddist = torch.sqrt(py)
    valid_dist = (pdist > eps_guard) & (pdist < 1.0 / eps_guard) & (
        ddist > eps_guard) & (ddist < 1.0 / eps_guard)
    theta = hp.primal_weight_update_smoothing
    new_omega = torch.exp(
        theta * torch.log(torch.where(valid_dist, ddist / pdist, 1.0))
        + (1.0 - theta) * torch.log(s.primal_weight))
    new_omega = torch.where(valid_dist, new_omega, s.primal_weight)

    def pick(a, b):
        return torch.where(do_restart, a, b)

    def cleared(v):
        return torch.where(do_restart, torch.zeros_like(v), v)

    s = s.replace(
        x=pick(cand_x, s.x), y=pick(cand_y, s.y),
        ax=pick(cand_ax, s.ax), aty=pick(cand_aty, s.aty),
        primal_weight=pick(new_omega, s.primal_weight),
        sum_weights=cleared(s.sum_weights),
        avg_x=cleared(s.avg_x), avg_y=cleared(s.avg_y),
        avg_ax=cleared(s.avg_ax), avg_aty=cleared(s.avg_aty),
        x_last_restart=pick(cand_x, s.x_last_restart),
        y_last_restart=pick(cand_y, s.y_last_restart),
        last_restart_kkt=pick(candidate_kkt, s.last_restart_kkt),
        last_candidate_kkt=candidate_kkt,
        iters_since_restart=cleared(s.iters_since_restart),
    )
    return s, do_restart


# ============================================================ major chunk
def major_tail(dev: DeviceProblem, s: SolverState, cfg: StaticCfg):
    """Termination information and the restart after a major's steps.
    Returns (state, report). Pure tensor code with no host sync, so
    lp/batch.py runs it under torch.func.vmap."""
    # termination info in user space, for current and average iterates
    with trace_scope("pdlp_termination"):
        info_cur = _unscaled_info(dev, s.x, s.y, s.ax, s.aty)
        has_avg = s.sum_weights > 0.0
        avg_x = torch.where(has_avg, s.avg_x, s.x)
        avg_y = torch.where(has_avg, s.avg_y, s.y)
        avg_ax = torch.where(has_avg, s.avg_ax, s.ax)
        avg_aty = torch.where(has_avg, s.avg_aty, s.aty)
        info_avg = _unscaled_info(dev, avg_x, avg_y, avg_ax, avg_aty)

        def optimal(info, rhs_norm, c_norm):
            ok_p = info["l2_primal_res"] <= (
                cfg.abs_primal + cfg.rel_primal * rhs_norm)
            ok_d = info["l2_dual_res"] <= (
                cfg.abs_dual + cfg.rel_dual * c_norm)
            ok_g = info["gap"] <= cfg.abs_gap + cfg.rel_gap * (
                info["primal_obj"].abs() + info["dual_obj"].abs())
            return ok_p & ok_d & ok_g

        rhs2 = (torch.maximum(
            torch.where(dev.lc_fin, dev.lc0_orig.abs(), 0.0),
            torch.where(dev.uc_fin, dev.uc0_orig.abs(), 0.0),
        ) ** 2).sum()
        c2 = (dev.c_orig ** 2).sum()
        red = _red(dev)
        if red is not None:
            rhs2, c2 = red.psum([(rhs2, "y"), (c2, "x")])
        rhs_norm = torch.sqrt(rhs2)
        c_norm = torch.sqrt(c2)
        opt_cur = optimal(info_cur, rhs_norm, c_norm)
        opt_avg = optimal(info_avg, rhs_norm, c_norm)

    # restart bookkeeping on the scaled problem
    with trace_scope("pdlp_restart"):
        sc_cur = _scaled_info(dev, s.x, s.y, s.ax, s.aty)
        sc_avg = _scaled_info(dev, avg_x, avg_y, avg_ax, avg_aty)
        kkt_cur = _kkt_score(sc_cur, s.primal_weight)
        kkt_avg = torch.where(has_avg, _kkt_score(sc_avg, s.primal_weight),
                              float("inf"))
        false = torch.zeros((), dtype=torch.bool, device=s.x.device)
        if cfg.detect_infeasibility:
            primal_inf, dual_inf = _infeasibility_flags(dev, s, cfg)
        else:
            primal_inf = dual_inf = false

        if cfg.hp.restart_strategy == RESTART_NONE:
            did_restart = false
        elif cfg.hp.restart_strategy == RESTART_TRUST_REGION:
            # normalized localized duality gap replaces the KKT score as
            # the restart potential (reference run_trust_region_restart)
            tr_cur = _localized_gap(
                dev, s.x, s.y, s.ax, s.aty, s.primal_weight,
                s.x_last_restart, s.y_last_restart)
            tr_avg = torch.where(has_avg, _localized_gap(
                dev, avg_x, avg_y, avg_ax, avg_aty, s.primal_weight,
                s.x_last_restart, s.y_last_restart), float("inf"))
            s, did_restart = _maybe_restart(dev, s, cfg, tr_cur, tr_avg)
        else:
            s, did_restart = _maybe_restart(dev, s, cfg, kkt_cur, kkt_avg)

    report = dict(
        opt_cur=opt_cur, opt_avg=opt_avg,
        numerical_error=s.numerical_error,
        primal_infeasible=primal_inf,
        dual_infeasible=dual_inf,
        did_restart=did_restart,
        kkt_cur=kkt_cur, kkt_avg=kkt_avg,
        # iterates for solution extraction (user space)
        x_cur=s.x * dev.col_scale, y_cur=s.y * dev.row_scale,
        x_avg=avg_x * dev.col_scale, y_avg=avg_y * dev.row_scale,
        reduced_cost_cur=dev.c_orig - s.aty / dev.col_scale,
        reduced_cost_avg=dev.c_orig - avg_aty / dev.col_scale,
        info_cur=info_cur, info_avg=info_avg,
        total_steps=s.total_steps,
        total_attempts=s.total_attempts,
        step_size=s.step_size,
        primal_weight=s.primal_weight,
    )
    return s, report


def make_major_fn(cfg: StaticCfg) -> "PingPongMajor":
    """The major-iteration function for this configuration:
    (dev, state) -> (state, report), a `PingPongMajor`."""
    return PingPongMajor(cfg)


# ============================================================ step driver
# the state's fields a slot writes, `_accept`'s; the others (the primal
# weight and the restart bookkeeping) change only in major_tail. `_slot`
# checks the list against what `_accept` writes.
_SLOT_FIELDS = ("x", "y", "ax", "aty", "step_size", "sum_weights", "avg_x",
                "avg_y", "avg_ax", "avg_aty", "iters_since_restart",
                "total_steps", "total_attempts", "numerical_error")


def _slot(dev: DeviceProblem, s: SolverState, pending, cfg: StaticCfg,
          out: SolverState, out_pending):
    """One attempt of a PDHG step with Malitsky-Pock adaptive step size
    (reference pdlp.cu take_step :1188 + adaptive_step_size_strategy),
    its predicate on the device: `pending` (0-d int64) is the attempt's
    0-based index within its step. The attempt commits when it is valid
    or at the attempt cap: `out` then holds `_accept`'s state and
    `out_pending` 0. Otherwise the iterates and averages stay, the step
    size becomes the next attempt's and `out_pending` is `pending + 1`.
    Writes only `out`'s _SLOT_FIELDS and `out_pending`, with no host sync;
    `out` must share no _SLOT_FIELDS tensor with `s`."""
    eta = s.step_size
    cand, valid, eta_next = _attempt(dev, s, cfg, dev.c - s.aty, eta,
                                     pending)
    attempts = pending + 1
    commit = valid | (attempts >= cfg.max_step_attempts)
    acc = _accept(s, cand, eta, eta_next, attempts)
    written = {f.name for f in dataclasses.fields(acc)
               if getattr(acc, f.name) is not getattr(s, f.name)}
    if written != set(_SLOT_FIELDS):
        raise AssertionError(f"_accept writes {written}, the slot's buffers "
                             f"hold {_SLOT_FIELDS}")
    # torch.where selects bits; a product by 0 would turn inf into NaN
    for f in _SLOT_FIELDS:
        if f != "step_size":
            torch.where(commit, getattr(acc, f), getattr(s, f),
                        out=getattr(out, f))
    out.step_size.copy_(eta_next)  # accepted or not, eta_next comes next
    torch.where(commit, torch.zeros_like(attempts), attempts,
                out=out_pending)


def _solo_on_card(dev, s) -> bool:
    """Whether `s` is on a card and the problem is neither split over a
    mesh nor a shard with a comm: the slots are then CUDA-graph replays
    (`PingPongMajor._graphed`) and run the hand-written step kernels
    (`pdhg_step.kernel_slot`), in the replays and in the eager slots
    alike. A shard's collectives wait on other shards' threads, so a mesh
    runs `_slot` eagerly."""
    return not isinstance(dev, ShardedProblem) and s.x.is_cuda and \
        getattr(dev.op, "comm", None) is None


# each thread's graph-capture stream, by device. A stream that runs a
# cuBLAS call is given a cuBLAS workspace that the process keeps (32 MiB
# on an H100), so a new stream each solve would keep 32 MiB more a solve
# until torch's stream pool wraps around: 1 GiB at 32 streams.
_CAPTURE = threading.local()


def _capture_stream(device) -> torch.cuda.Stream:
    streams = _CAPTURE.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


class PingPongMajor:
    """The major-iteration function of every PDLP solve (`make_major_fn`,
    `PdlpSolver._run`): a major's steps as rounds of `_slot`, then
    `major_tail`. (dev, state) -> (state, report).

    Two buffers hold the state: slot k reads buffer k and writes buffer
    1 - k, so slots alternate (the reference's ping-pong graph,
    ping_pong_graph.cuh, pdhg.cu:191-200). Each slot commits at most one
    step, so with `done` of the major's `quota` steps known, the next
    `quota - done` slots cannot overshoot: the host runs them, then reads
    the count (one int64) and goes on until it is the quota. With a few
    percent of attempts rejected, a major reads two or three counts.

    On CUDA tensors and an operator with no comm (a solo solve on a card,
    `_solo_on_card`) each slot is a replay of one of two CUDA graphs. They
    are captured at the first major, on the thread's capture stream in
    thread-local mode (the MIP's FJ thread replays its own graphs
    meanwhile). The major's first slot runs eagerly on that stream before
    the capture: it loads the kernel libraries, the row pass's plan and
    cuBLAS there, and, a slot being a pure function of its input buffer,
    it gives what a replay of graph 0 would. On the card, eager or
    replayed, a slot is `pdhg_step.kernel_slot`: hand-written kernels
    around the products. On the fused float32 block band it launches
    pdhg_primal, the row pass (and the spill's few torch ops where the
    band spills), pdhg_row_sums and pdhg_commit; on the unfused path
    pdhg_primal, the operator's matvec, pdhg_dual, its rmatvec and
    pdhg_commit. Their sums are taken in one fixed order, so the eager
    slot and the replays give the same bits. Every kernel
    counts its own launches on the device (`Kernel.launches`), so the
    eager slot and each replay count one and the capture none: one an
    attempt. `kernel_slots` counts the slots run that way (the raw
    result's `step_kernel_slots`): all of them on a card, none elsewhere.
    The replays and the eager tail, which runs no row pass, go on one
    stream, so no replayed partials pass overlaps an eager one on the
    operator (`RowPassPlan.counters`). Everywhere else (CPU tensors, a
    shard of a mesh) each slot runs `_slot` eagerly, in the same rounds,
    buffers and reads.

    Given a ShardedProblem and its ShardedState (parallel/sharding.py) it
    runs the major on every shard under run_spmd (`sharded_major`), each
    shard with two buffers of its own and the problem it is handed. The
    shards run the same rounds, since `valid` comes from psum'd sums, the
    same bits on every shard. The report comes whole on the first
    shard's device, with the run's collectives and bytes exchanged.

    The buffers and graphs belong to the problem of the last call: a
    call with another problem allocates new buffers and captures anew.
    A state or report a major returns shares tensors with the buffers,
    which the next major of the same problem overwrites: keep one across
    it only as a copy. Later majors run on the stream the capture's call
    ran on. `slots` and `count_reads` count the slots run and the counts
    read (on a mesh, the first shard's), `kernel_slots` those of the
    slots that ran the step kernels."""

    def __init__(self, cfg: StaticCfg):
        self.cfg = cfg
        self.dev = None  # the problem of the buffers and graphs
        self.bufs = None  # two SolverStates sharing their non-slot fields
        self.pending = None  # each buffer's 0-d int64 attempt index
        self.graphs = None
        self.work = None  # the step kernels' scratch, on a card
        self.slots = 0
        self.kernel_slots = 0
        self.count_reads = 0

    def __call__(self, dev, s):
        if isinstance(dev, ShardedProblem):
            return sharded_major(self._shard_major, dev, s)
        return major_tail(dev, self.steps(dev, s), self.cfg)

    def steps(self, dev: DeviceProblem, s: SolverState) -> SolverState:
        """A major's PDHG steps from `s`: the state major_tail starts
        from, one of the buffers."""
        quota = self.cfg.hp.major_iteration
        with trace_scope("pdlp_pdhg_steps"):
            if dev is not self.dev:
                self._allocate(dev, s)
            else:
                self._load(s)
            start = self.bufs[0].total_steps.clone()
            slots0 = self.slots
            cur, ahead = 0, 0  # ahead: slots run since the last count
            if self.graphs is None and self._graphed(dev, s):
                with trace_scope("pdlp_graph_capture"):
                    self._capture()
                cur, ahead = 1, 1
            done = 0
            while True:
                n = quota - done - ahead
                for _ in range(n):
                    self._replay(cur)
                    cur ^= 1
                self.slots += n
                with trace_scope("pdlp_step_sync"):
                    done = int(self.bufs[cur].total_steps - start)
                self.count_reads += 1
                if done == quota:
                    break
                ahead = 0
            if self.work is not None:
                self.kernel_slots += self.slots - slots0
            debug_assert(self.bufs[cur].step_size > 0.0,
                         "PDHG step size must stay positive")
        return self.bufs[cur]

    def _shard_major(self, dev, s):
        """One shard's major, in its run_spmd thread: a driver of its own,
        whose counts the first shard reports."""
        lane = PingPongMajor(self.cfg)
        out = lane(dev, s)
        if dev.op.comm.rank == 0:
            self.slots += lane.slots
            self.kernel_slots += lane.kernel_slots
            self.count_reads += lane.count_reads
        return out

    @staticmethod
    def _graphed(dev, s) -> bool:
        """Whether the slots are CUDA-graph replays (`_solo_on_card`)."""
        return _solo_on_card(dev, s)

    def _allocate(self, dev, s):
        self.dev, self.graphs = dev, None
        b0 = s.replace(**{f.name: getattr(s, f.name).clone()
                          for f in dataclasses.fields(s)})
        b1 = b0.replace(**{f: torch.empty_like(getattr(b0, f))
                           for f in _SLOT_FIELDS})
        self.bufs = (b0, b1)
        self.work = pdhg_step.step_work(
            dev, s, _use_fused(dev, s.x.dtype, self.cfg)) \
            if _solo_on_card(dev, s) else None
        self.pending = tuple(torch.zeros((), dtype=torch.int64,
                                         device=s.x.device)
                             for _ in (0, 1))

    def _load(self, s):
        """`s` (a major's start) into buffer 0, whose non-slot fields are
        buffer 1's too."""
        b0 = self.bufs[0]
        for f in dataclasses.fields(s):
            getattr(b0, f.name).copy_(getattr(s, f.name))
        self.pending[0].zero_()

    def _run_slot(self, k):
        args = (self.dev, self.bufs[k], self.pending[k], self.cfg,
                self.bufs[1 - k], self.pending[1 - k])
        if self.work is None:
            _slot(*args)
        else:
            pdhg_step.kernel_slot(*args, self.work)

    def _replay(self, k):
        if self.graphs is None:
            self._run_slot(k)
        else:
            self.graphs[k].replay()

    def _capture(self):
        device = self.bufs[0].x.device
        stream = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._run_slot(0)  # the major's first slot, and the warm-up
            graphs = []
            for k in (0, 1):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=graphs[0].pool() if graphs else None,
                                capture_error_mode="thread_local")
                self._run_slot(k)
                g.capture_end()
                graphs.append(g)
        stream.wait_stream(side)
        self.graphs = graphs
        self.slots += 1


# ============================================================== scaling
def compute_scaling(op, lc_fin, uc_fin, lc0, uc0, hp: PdlpHyperParams,
                    dtype):
    """Ruiz L-inf equilibration + Pock-Chambolle alpha scaling (reference
    initial_scaling_strategy/initial_scaling.cuh:32, ruiz :85,
    pock_chambolle :86). Returns (scaled_op, row_scale, col_scale)."""
    n, m = op.shape
    dev = lc0.device
    row_scale = torch.ones(n, dtype=dtype, device=dev)
    col_scale = torch.ones(m, dtype=dtype, device=dev)
    cur = op
    if hp.do_ruiz_scaling:
        for _ in range(hp.l_inf_ruiz_iterations):
            rmax = cur.row_abs_max()
            cmax = cur.col_abs_max()
            r = torch.where(rmax > 0, 1.0 / torch.sqrt(rmax), 1.0)
            c = torch.where(cmax > 0, 1.0 / torch.sqrt(cmax), 1.0)
            cur = cur.rescale(r, c)
            row_scale = row_scale * r
            col_scale = col_scale * c
    if hp.do_pock_chambolle_scaling:
        alpha = hp.alpha_pock_chambolle
        rsum = cur.row_abs_reduce(2.0 - alpha)
        csum = cur.col_abs_reduce(alpha)
        r = torch.where(rsum > 0, 1.0 / torch.sqrt(rsum), 1.0)
        c = torch.where(csum > 0, 1.0 / torch.sqrt(csum), 1.0)
        cur = cur.rescale(r, c)
        row_scale = row_scale * r
        col_scale = col_scale * c
    return cur, row_scale, col_scale


_TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def build_device_problem(prob, hp: PdlpHyperParams, dtype,
                         operator_kind: str = "auto",
                         device="cuda") -> DeviceProblem:
    """Host CSR problem -> scaled problem on `device`.

    Cached per problem OBJECT under `_cuopt_torch_device_cache` (a name of
    this package's own, so a problem seen by both packages never returns
    the other's device problem). The key is (dtype, operator_kind,
    device, scaling knobs) and a digest of the objective and the bounds,
    so a caller that changes those in place (the feasibility pump moves
    its distance rows' bounds every iteration) gets a fresh build."""
    device = torch.device(device)
    key = (str(dtype), operator_kind, str(device), hp.do_ruiz_scaling,
           hp.l_inf_ruiz_iterations, hp.do_pock_chambolle_scaling,
           hp.alpha_pock_chambolle, _vectors_digest(prob))
    cache = getattr(prob, "_cuopt_torch_device_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    dev = _build_device_problem_uncached(prob, hp, dtype, operator_kind,
                                         device)
    prob._cuopt_torch_device_cache = (key, dev)
    return dev


def cached_device_problem(prob):
    """The device problem last built for `prob`, or None."""
    cache = getattr(prob, "_cuopt_torch_device_cache", None)
    return None if cache is None else cache[1]


def _vectors_digest(prob) -> str:
    """A digest of the objective, its offset and sense, and every bound."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((prob.maximize, float(prob.objective_offset))).encode())
    for v in (prob.objective_coefficients, prob.variable_lower_bounds,
              prob.variable_upper_bounds, prob.constraint_lower_bounds,
              prob.constraint_upper_bounds):
        h.update(np.ascontiguousarray(v, np.float64).data)
    return h.hexdigest()


def _finite_parts(dev_vectors: dict) -> dict:
    """Finite masks and zero-filled copies of the user-space bounds."""
    out = {}
    for k in ("lv", "uv", "lc", "uc"):
        v = dev_vectors[f"{k}_orig"]
        fin = torch.isfinite(v)
        out[f"{k}_fin"] = fin
        out[f"{k}0_orig"] = torch.where(fin, v, 0.0)
    return out


def _build_device_problem_uncached(prob, hp, dtype, operator_kind, device):
    n, m = prob.n_constraints, prob.n_variables
    sign = -1.0 if prob.maximize else 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    with trace_scope("device_upload"):
        v = dict(
            c_orig=t(sign * prob.objective_coefficients),
            lv_orig=t(prob.variable_lower_bounds),
            uv_orig=t(prob.variable_upper_bounds),
            lc_orig=t(prob.constraint_lower_bounds),
            uc_orig=t(prob.constraint_upper_bounds),
        )
        offset = t(sign * prob.objective_offset)

    op0 = build_operator(prob.offsets, prob.indices, prob.values, n, m,
                         dtype=dtype, kind=operator_kind, device=device)
    perms = dict(row_perm=None, inv_row_perm=None, col_perm=None,
                 inv_col_perm=None)
    if isinstance(op0, PermutedOp):
        # absorb the bandwidth-reducing permutation into the problem:
        # one-time gathers here; the hot loop then runs un-gathered on
        # the banded inner operator
        perms = dict(row_perm=op0.row_perm, inv_row_perm=op0.inv_row_perm,
                     col_perm=op0.col_perm, inv_col_perm=op0.inv_col_perm)
        op0 = op0.inner
        for k in ("c_orig", "lv_orig", "uv_orig"):
            v[k] = v[k][perms["col_perm"]]
        for k in ("lc_orig", "uc_orig"):
            v[k] = v[k][perms["row_perm"]]
    v.update(_finite_parts(v))

    with trace_scope("pdlp_scaling"):
        op, row_scale, col_scale = compute_scaling(
            op0, v["lc_fin"], v["uc_fin"], v["lc0_orig"], v["uc0_orig"],
            hp, dtype)
    # scaled vectors: c' = C c; l_c' = R l_c; l_v' = l_v / C
    c = v["c_orig"] * col_scale
    lc = v["lc_orig"] * row_scale
    uc = v["uc_orig"] * row_scale
    lv = v["lv_orig"] / col_scale
    uv = v["uv_orig"] / col_scale
    return DeviceProblem(
        op=op, c=c, lv=lv, uv=uv, lc=lc, uc=uc,
        lv0=torch.where(v["lv_fin"], lv, 0.0),
        uv0=torch.where(v["uv_fin"], uv, 0.0),
        lc0=torch.where(v["lc_fin"], lc, 0.0),
        uc0=torch.where(v["uc_fin"], uc, 0.0),
        row_scale=row_scale, col_scale=col_scale, offset=offset,
        **v, **perms,
    )


def device_problem_from_arrays(arrays: dict, device) -> DeviceProblem:
    """A DeviceProblem from the fields of another implementation's device
    problem given as numpy arrays (and Python values): arrays["op"] is the
    operator in the form `sparse.ops.operator_from_arrays` takes, the
    other fields are named as in DeviceProblem. Float arrays keep their
    dtype, boolean masks stay boolean, permutations become int64."""
    kw = {}
    for f in dataclasses.fields(DeviceProblem):
        a = arrays.get(f.name)
        if f.name == "op":
            kw["op"] = operator_from_arrays(a, device)
        elif a is None:
            kw[f.name] = None
        else:
            a = np.array(a)  # a writable copy
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            kw[f.name] = torch.as_tensor(a, device=device)
    return DeviceProblem(**kw)


def state_from_arrays(arrays: dict, device) -> SolverState:
    """A SolverState from fields given as numpy arrays (or scalars): the
    counters become int64 tensors, numerical_error a boolean one, every
    other field keeps its float dtype."""
    kw = {}
    for f in dataclasses.fields(SolverState):
        a = np.array(arrays[f.name])  # a writable copy
        if f.name in ("iters_since_restart", "total_steps",
                      "total_attempts"):
            a = a.astype(np.int64)
        elif f.name == "numerical_error":
            a = a.astype(bool)
        kw[f.name] = torch.as_tensor(a, device=device)
    return SolverState(**kw)


def initial_state(dev: DeviceProblem, hp: PdlpHyperParams, dtype,
                  x0=None, y0=None) -> SolverState:
    """Initial iterates, step size and primal weight (reference
    pdlp.cu compute_initial_step_size / compute_initial_primal_weight:
    eta0 = scaling / max|A|; omega0 = importance * ||c||/||b_combined||,
    both on the scaled problem for the default Stable2 config). x0 / y0
    are optional user-space starting points (settings
    initial_primal_solution / initial_dual_solution)."""
    n, m = dev.op.shape
    device = dev.c.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    if x0 is None:
        x = torch.zeros(m, dtype=dtype, device=device)
        if hp.project_initial_primal:
            x = torch.clamp(x, dev.lv, dev.uv)
    else:
        x = t(x0)
        if dev.col_perm is not None:  # user space -> permuted space
            x = x[dev.col_perm]
        x = x / dev.col_scale
    if y0 is None:
        y = torch.zeros(n, dtype=dtype, device=device)
    else:
        y = t(y0)
        if dev.row_perm is not None:
            y = y[dev.row_perm]
        y = y / dev.row_scale
    ax = dev.op.matvec(x)
    aty = dev.op.rmatvec(y)

    abs_max = dev.op.abs_max()
    eta0 = torch.where(abs_max > 0.0,
                       hp.initial_step_size_scaling / abs_max,
                       hp.initial_step_size_scaling)
    combined = torch.maximum(
        torch.where(dev.lc_fin, dev.lc0.abs(), 0.0),
        torch.where(dev.uc_fin, dev.uc0.abs(), 0.0),
    )
    b_norm = torch.sqrt(hp.initial_primal_weight_b_scaling
                        * (combined ** 2).sum())
    c_norm = torch.sqrt(hp.initial_primal_weight_c_scaling
                        * (dev.c ** 2).sum())
    omega0 = torch.where((b_norm > 0.0) & (c_norm > 0.0),
                         hp.primal_importance * c_norm / b_norm,
                         hp.primal_importance)

    def zero_i():
        return torch.zeros((), dtype=torch.int64, device=device)

    def inf():
        return torch.full((), float("inf"), dtype=dtype, device=device)

    return SolverState(
        x=x, y=y, ax=ax, aty=aty,
        step_size=eta0.to(dtype),
        primal_weight=omega0.to(dtype),
        sum_weights=torch.zeros((), dtype=dtype, device=device),
        avg_x=torch.zeros_like(x), avg_y=torch.zeros_like(y),
        avg_ax=torch.zeros_like(ax), avg_aty=torch.zeros_like(aty),
        x_last_restart=x, y_last_restart=y,
        last_restart_kkt=inf(), last_candidate_kkt=inf(),
        iters_since_restart=zero_i(),
        total_steps=zero_i(), total_attempts=zero_i(),
        numerical_error=torch.zeros((), dtype=torch.bool, device=device),
    )


def _host_activity(prob, x):
    """A @ x on host (per-constraint residual checks)."""
    act = np.zeros(prob.n_constraints)
    rows = np.repeat(np.arange(prob.n_constraints, dtype=np.int64),
                     np.diff(prob.offsets))
    np.add.at(act, rows, prob.values * x[prob.indices])
    return act


def _np(t):
    return t.detach().cpu().numpy()


def _stopped() -> dict:
    """The raw result of a run that `stop` ended before its first major."""
    return {"status": C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT,
            "iterations": 0, "attempts": 0}


# per-major scalars read back in ONE transfer (see PdlpSolver.run)
_SCALAR_KEYS = ("opt_cur", "opt_avg", "numerical_error", "total_steps",
                "total_attempts", "primal_infeasible", "dual_infeasible",
                "did_restart")
_INFO_KEYS = ("primal_obj", "dual_obj", "gap", "l2_primal_res",
              "l2_dual_res")


# ============================================================== host driver
class PdlpSolver:
    """Host driver: builds the device problem, runs major iterations,
    checks time/iteration limits between them (reference pdlp.cu
    run_solver :984). Runs on `device` (default "cuda"; a missing card
    raises, nothing falls back to the CPU). With a `mesh`
    (parallel/sharding.py) the problem is built and scaled on `device`,
    then split over the mesh's shards, and every major runs sharded."""

    def __init__(self, prob, settings: PDLPSolverSettings, device="cuda",
                 mesh=None):
        self.prob = prob
        self.settings = settings
        self.device = torch.device(device)
        self.mesh = mesh
        self.hp = PRESETS[settings.pdlp_solver_mode]
        # large instances check termination every ~160 steps instead of
        # 40, as cuopt_tpu does (pdlp.py:981-984), so that both packages
        # take the same major cadence
        if prob.nnz >= 5_000_000 and self.hp.major_iteration < 160:
            self.hp = dataclasses.replace(self.hp, major_iteration=160)
        if settings.dtype not in _TORCH_DTYPES:
            raise ValueError(f"unknown dtype {settings.dtype!r}")
        self.dtype = _TORCH_DTYPES[settings.dtype]
        t = settings.tolerances
        self.cfg = StaticCfg(
            hp=self.hp,
            abs_primal=t.absolute_primal_tolerance,
            rel_primal=t.relative_primal_tolerance,
            abs_dual=t.absolute_dual_tolerance,
            rel_dual=t.relative_dual_tolerance,
            abs_gap=t.absolute_gap_tolerance,
            rel_gap=t.relative_gap_tolerance,
            detect_infeasibility=settings.detect_infeasibility,
            primal_inf_tol=t.primal_infeasible_tolerance,
            dual_inf_tol=t.dual_infeasible_tolerance,
        )
        self.log = get_logger()

    def run(self, timer: Timer | None = None, stop=None):
        """Solve; returns the raw solution dict. `stop`, when given, is a
        predicate checked before the device problem is built, once the
        CUDA kernels are loaded, and between majors, where the time limit
        is: once it returns True the run ends with status
        CONCURRENT_LIMIT (the concurrent race's halt,
        dual_simplex/concurrent.py); stopped before the first major, the
        result holds only the status and 0 iterations."""
        if stop is not None and stop():
            return _stopped()
        maybe_start_profile()
        with trace_scope("pdlp_run"):
            return self._run(timer or Timer(self.settings.time_limit), stop)

    def _run(self, timer: Timer, stop):
        settings = self.settings
        prob = self.prob
        t_run0 = time.perf_counter()
        with trace_scope("pdlp_build"):
            dev = build_device_problem(prob, self.hp, self.dtype,
                                       settings.operator_kind, self.device)
        build_s = time.perf_counter() - t_run0
        if settings.warm_start_data is not None:
            from cuopt_torch.lp.warm_start import restore_state

            state = restore_state(settings.warm_start_data, dev, self.dtype)
        else:
            state = initial_state(dev, self.hp, self.dtype,
                                  settings.initial_primal_solution,
                                  settings.initial_dual_solution)
        run_dev = dev
        if self.mesh is not None:
            run_dev, state = shard_problem_and_state(dev, state, self.mesh)
        if stop is not None and self.device.type == "cuda":
            # nvcc on a cold start
            if _use_fused(dev, self.dtype, self.cfg):
                BUILDER.library(ROW_PASS_ATOMIC.source)
            if _solo_on_card(run_dev, state):
                BUILDER.library(pdhg_step.PDHG_COMMIT.source)
            if stop():
                return _stopped()
        major_fn = make_major_fn(self.cfg)
        status = C.CUOPT_TERIMINATION_STATUS_NO_TERMINATION
        report = None
        use_avg = False
        it = attempts = restarts = 0
        inf_streak = unb_streak = 0
        best_primal = None  # (obj, x) under save_best_primal_so_far
        # strict: first detection terminates; non-strict: require two
        # consecutive majors agreeing (reference pdlp.cu:718-723)
        needed_streak = 1 if settings.strict_infeasibility else 2
        self.log.info(
            f"PDLP: {prob.n_constraints} rows, {prob.n_variables} cols, "
            f"{prob.nnz} nnz, operator={type(dev.op).__name__}, "
            f"dtype={settings.dtype}, device={self.device}, "
            f"fused={_use_fused(dev, self.dtype, self.cfg)}"
            + ("" if self.mesh is None else f", mesh={self.mesh}"))
        lo = prob.constraint_lower_bounds
        hi = prob.constraint_upper_bounds
        b_abs = np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                           np.abs(np.where(np.isfinite(hi), hi, 0.0)))
        rhs_norm = float(np.sqrt(np.sum(b_abs ** 2)))
        t = settings.tolerances
        t_first_major = None
        while True:
            state, report = major_fn(run_dev, state)
            # ONE device->host transfer for all per-major scalars
            with trace_scope("pdlp_major_readback"):
                packed = _np(torch.stack(
                    [report[k].to(torch.float64) for k in _SCALAR_KEYS]
                    + [report["info_cur"][k].to(torch.float64)
                       for k in _INFO_KEYS]))
            (f_opt_cur, f_opt_avg, f_num, f_steps, f_attempts, f_pinf,
             f_dinf, f_restart, v_pobj, v_dobj, v_gap, v_rp, v_rd) = packed
            opt_cur, opt_avg = bool(f_opt_cur), bool(f_opt_avg)
            numerical = bool(f_num)
            it, attempts = int(f_steps), int(f_attempts)
            restarts += bool(f_restart)
            if t_first_major is None:
                t_first_major = time.perf_counter() - t_run0
                it0, attempts0 = it, attempts
            self.log.debug(
                f"  {it:>8d}  obj {v_pobj:+.8e}  dual {v_dobj:+.8e}  "
                f"gap {v_gap:.2e}  |rp| {v_rp:.2e}  |rd| {v_rd:.2e}")
            if settings.per_constraint_residual and (opt_cur or opt_avg):
                # strengthen termination: every constraint's violation must
                # meet abs + rel * |b_i| (reference per_constraint_residual,
                # solver_settings.hpp:186)
                limit = t.absolute_primal_tolerance + \
                    t.relative_primal_tolerance * b_abs
                for flag, which in ((opt_cur, "cur"), (opt_avg, "avg")):
                    if not flag:
                        continue
                    xx = _np(report[f"x_{which}"])
                    if dev.inv_col_perm is not None:
                        xx = xx[_np(dev.inv_col_perm)]
                    act = _host_activity(prob, xx)
                    vio = np.maximum(
                        np.where(np.isfinite(lo), lo - act, 0.0),
                        np.where(np.isfinite(hi), act - hi, 0.0))
                    if np.any(vio > limit):
                        if which == "cur":
                            opt_cur = False
                        else:
                            opt_avg = False
            if settings.save_best_primal_so_far or \
                    settings.first_primal_feasible:
                ok_p = v_rp <= (t.absolute_primal_tolerance
                                + t.relative_primal_tolerance * rhs_norm)
                if ok_p:
                    obj_c = float(v_pobj)
                    if best_primal is None or obj_c < best_primal[0]:
                        best_primal = (obj_c, _np(report["x_cur"]))
                    if settings.first_primal_feasible:
                        status = C.CUOPT_TERIMINATION_STATUS_PRIMAL_FEASIBLE
                        break
            if opt_cur or opt_avg:
                status = C.CUOPT_TERIMINATION_STATUS_OPTIMAL
                use_avg = opt_avg and not opt_cur
                break
            if numerical:
                status = C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR
                break
            if settings.detect_infeasibility:
                inf_streak = inf_streak + 1 if bool(f_pinf) else 0
                unb_streak = unb_streak + 1 if bool(f_dinf) else 0
                if inf_streak >= needed_streak:
                    status = C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
                    break
                if unb_streak >= needed_streak:
                    status = C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
                    break
            if it >= settings.iteration_limit:
                status = C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
                break
            if timer.expired():
                status = C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT
                break
            if stop is not None and stop():
                status = C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
                break
        with trace_scope("pdlp_answer"):
            which = "avg" if use_avg else "cur"
            info = {k: float(v) for k, v in report[f"info_{which}"].items()}
            sol = {
                "status": status,
                "iterations": it,
                "attempts": attempts,
                # majors whose tail restarted the iterates
                "restarts": restarts,
                "solve_time": timer.elapsed(),
                "primal_solution": _np(report[f"x_{which}"]),
                "dual_solution": _np(report[f"y_{which}"]),
                "reduced_cost": _np(report[f"reduced_cost_{which}"]),
                "primal_objective": info["primal_obj"],
                "dual_objective": info["dual_obj"],
                "gap": info["gap"],
                "l2_primal_residual": info["l2_primal_res"],
                "l2_dual_residual": info["l2_dual_res"],
                "linf_primal_residual": info["linf_primal_res"],
                "linf_dual_residual": info["linf_dual_res"],
                # time to the first major's return = problem build + the first
                # major (kernel build included); the iteration loop is the rest
                "compile_s": round(t_first_major, 4),
                # the device problem's build alone, inside compile_s
                "build_s": round(build_s, 4),
                "solve_loop_s": round(
                    max(time.perf_counter() - t_run0 - t_first_major, 0.0), 4),
                "loop_steps": it - it0,
                "loop_attempts": attempts - attempts0,
                # the step driver's slots (one an attempt) and count reads
                "graph_slots": major_fn.slots,
                "graph_count_reads": major_fn.count_reads,
                # of those slots, the ones run by the step kernels
                "step_kernel_slots": major_fn.kernel_slots,
            }
            if settings.save_best_primal_so_far and best_primal is not None \
                    and best_primal[0] < sol["primal_objective"]:
                sol["primal_solution"] = best_primal[1]
                sol["primal_objective"] = best_primal[0]
            # solution vectors live in permuted space when the operator was
            # bandwidth-reordered: gather back to user order (the warm-start
            # data stays in permuted space: it is restored against the same
            # deterministic permutation of the same matrix)
            if dev.inv_col_perm is not None:
                inv_cp = _np(dev.inv_col_perm)
                inv_rp = _np(dev.inv_row_perm)
                sol["primal_solution"] = sol["primal_solution"][inv_cp]
                sol["dual_solution"] = sol["dual_solution"][inv_rp]
                sol["reduced_cost"] = sol["reduced_cost"][inv_cp]
            # undo the minimize transform for maximize problems
            if prob.maximize:
                sol["primal_objective"] = -sol["primal_objective"]
                sol["dual_objective"] = -sol["dual_objective"]
                sol["dual_solution"] = -sol["dual_solution"]
                sol["reduced_cost"] = -sol["reduced_cost"]
        if self.mesh is not None:
            state = gather_state(state)
        # the full internal state for re-solves (reference pdlp.cu:470-488),
        # captured lazily: it copies ten vectors off the device and most
        # solves never use it (Solution.get_pdlp_warm_start_data). The
        # closure holds the state and the two scale vectors, not the slabs.
        scales = SimpleNamespace(row_scale=dev.row_scale,
                                 col_scale=dev.col_scale)

        def _lazy_warm_start(scales=scales, state=state):
            from cuopt_torch.lp.warm_start import capture_warm_start

            return capture_warm_start(scales, state)

        sol["warm_start_data_fn"] = _lazy_warm_start
        return sol
