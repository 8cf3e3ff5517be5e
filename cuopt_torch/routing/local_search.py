"""Massively-parallel local search move evaluation (PyTorch, on `device`).

The port's counterpart of cuopt_tpu/routing/local_search.py, itself a
re-design of the reference move-candidate machinery
(cpp/src/routing/local_search/local_search.cuh:102-160: CROSS/2-opt/
relocate kernels over move_candidates/): ALL candidate moves are scored
as dense tensors in one call —

  - relocate: every (order position) x (insertion slot) pair,
  - swap (CROSS): every inter-route position pair,
  - 2-opt: every intra-route segment reversal (symmetric matrices,
    no time windows),
  - 2-opt* (tail exchange, the reference's CROSS-exchange over route
    tails): every (cut position in r1) x (cut position in r2) pair for
    compatible vehicles,
  - Or-opt: every length-2 consecutive segment x (insertion slot) pair
    (the reference's sliding-window segment moves),

with O(1) feasibility per candidate from forward departure times and
backward latest-arrival slacks (the reference's forward/backward
dimension cumulations, route/route.cuh). The host applies the best moves
and re-invokes; each evaluator returns tensors on the problem's device
and the caller reads them back once (`to_host`).

Where the port differs from cuopt_tpu in form, not in result:
  - eager PyTorch, no jit: the forward/backward time scans
    (`jax.lax.scan`) are Python loops over the L + 2 route positions, a
    few launches each;
  - `_pair_costs` is the raw index gather that cuopt_tpu runs off the
    TPU; the one-hot matmul it uses on the TPU's MXU is not ported;
  - the per-family top-k breaks ties by flat index (lowest first), as
    `jax.lax.top_k` does, by a stable sort (`_topk_smallest`):
    `torch.topk` makes no promise among equal values;
  - float32 values and int64 indices throughout (cuopt_tpu's int32
    indices become int64 under its x64 switch anyway).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

BIG = 1e12
_F32 = torch.float32
_I64 = torch.int64
_EXACT_F32 = 1 << 24  # ids packed as float32 are exact below this

# device -> host reads of evaluator results (to_host), for the smoke's
# "readbacks per round"
readbacks = 0


def to_host(t) -> np.ndarray:
    """The one device -> host read of an evaluator's result."""
    global readbacks
    readbacks += 1
    return t.detach().cpu().numpy()


@dataclass
class LsProblem:
    order_loc: torch.Tensor  # (n_serve,)
    e: torch.Tensor  # tw early
    l: torch.Tensor  # tw late  # noqa: E741
    s: torch.Tensor  # service
    demand: torch.Tensor  # (ndim, n_serve)
    capacity: torch.Tensor  # (ndim, F)
    veh_ti: torch.Tensor  # (F,) type index
    veh_start: torch.Tensor
    veh_return: torch.Tensor
    veh_tw_early: torch.Tensor
    veh_tw_late: torch.Tensor
    veh_fixed: torch.Tensor
    cost_mats: torch.Tensor  # (T, n_loc, n_loc)
    time_mats: torch.Tensor
    movable: torch.Tensor  # (n_serve,) bool: not PD-paired
    allowed: torch.Tensor  # (n_serve, F) bool
    skip_first: torch.Tensor  # (F,) bool
    drop_return: torch.Tensor  # (F,) bool
    # per-vehicle max route (arc) cost, BIG where unconstrained: scored
    # as a move-tensor dimension so the device top-k is not mostly
    # discarded by the host recheck on constrained instances (reference
    # carries these as route dimensions, route/route.cuh:29)
    veh_max_cost: torch.Tensor  # (F,)
    # per-order prize (0 where none); prize orders are optional, so LS
    # scores drop moves (prize < removal saving) in-tensor (reference
    # prize-collection move families, local_search.cuh:102-160)
    prize: torch.Tensor  # (n_serve,)
    # static: these choose code paths
    has_tw: bool
    allow_2opt: bool
    has_max_cost: bool = False
    has_prize: bool = False
    # pickup-delivery pairs: moves are held to the load carried after
    # each stop, not the route's (net) total; pair_next[o] is the
    # delivery of pickup o, -1 for every other order
    has_pairs: bool = False
    pair_next: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.e.device


# the per-vehicle fields, with the axis that indexes the vehicle
VEHICLE_FIELDS = {
    "capacity": 1, "veh_ti": 0, "veh_start": 0, "veh_return": 0,
    "veh_tw_early": 0, "veh_tw_late": 0, "veh_fixed": 0,
    "veh_max_cost": 0, "skip_first": 0, "drop_return": 0, "allowed": 1,
}


def build_ls_problem(prob, dtype=_F32, device="cuda") -> LsProblem:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "routing local search on 'cuda' needs a CUDA card; pass "
            "device='cpu' to run it on the CPU")
    sym = np.allclose(prob.cost_mats, np.swapaxes(prob.cost_mats, 1, 2))
    has_tw = bool(
        np.any(np.isfinite(prob.tw_late))
        or np.any(prob.service > 0)
        or np.any(np.isfinite(prob.veh_tw_late))
    )
    movable = np.ones(prob.n_serve, bool)
    if prob.pd_partner is not None:
        movable &= prob.pd_partner < 0
    allowed = prob.allowed_vehicles if prob.allowed_vehicles is not None \
        else np.ones((prob.n_serve, prob.n_fleet), bool)
    ti = np.array([prob.type_index[int(t)] for t in prob.veh_type])

    def clip(a):
        return np.where(np.isfinite(a), a, BIG)

    # Max route DURATION folds into the vehicle return deadline: the
    # evaluator's forward pass departs at veh_tw_early, so
    # "return by start + max_time" is exact within the device model
    # (the host recheck stays authoritative for delayed starts).
    tw_late_eff = np.minimum(
        clip(prob.veh_tw_late),
        np.where(np.isfinite(prob.veh_max_time),
                 prob.veh_tw_early + prob.veh_max_time, BIG),
    )
    has_tw = has_tw or bool(np.any(np.isfinite(prob.veh_max_time)))
    has_max_cost = bool(np.any(np.isfinite(prob.veh_max_cost)))
    has_pairs = prob.pd_partner is not None and \
        bool(np.any(prob.pd_partner >= 0))

    def val(a):  # rounded to `dtype` on the host, then moved
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).to(
            device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return LsProblem(
        order_loc=idx(prob.order_loc),
        e=val(prob.tw_early),
        l=val(clip(prob.tw_late)),
        s=val(prob.service),
        demand=val(prob.demand),
        capacity=val(clip(prob.capacity)),
        veh_ti=idx(ti),
        veh_start=idx(prob.veh_start),
        veh_return=idx(prob.veh_return),
        veh_tw_early=val(prob.veh_tw_early),
        veh_tw_late=val(tw_late_eff),
        veh_fixed=val(prob.veh_fixed_cost),
        cost_mats=val(prob.cost_mats),
        time_mats=val(prob.time_mats),
        movable=flag(movable),
        allowed=flag(allowed),
        skip_first=flag(prob.skip_first),
        drop_return=flag(prob.drop_return),
        veh_max_cost=val(clip(prob.veh_max_cost)),
        prize=val(prob.prizes if prob.prizes is not None
                  else np.zeros(prob.n_serve)),
        has_tw=has_tw,
        allow_2opt=bool(sym) and not has_tw,
        has_max_cost=has_max_cost,
        has_prize=prob.prizes is not None,
        has_pairs=has_pairs,
        pair_next=idx(np.where(prob.pd_sign > 0, prob.pd_partner, -1))
        if has_pairs else None,
    )


def _ids(p: LsProblem, a) -> torch.Tensor:
    """Route/candidate ids as int64 on the problem's device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=p.device, dtype=_I64)
    return torch.as_tensor(np.asarray(a, np.int64), device=p.device)


def _arange(n, like):
    return torch.arange(n, device=like.device)


def _route_tensors(p: LsProblem, R, lens):
    """Augmented per-route tensors: locations, departures, slacks, loads.

    R: (F, L) serve-order ids, -1 padded. Positions 1..len hold orders;
    position 0 is the vehicle start, position len+1 the return. With
    pickup-delivery pairs the last tensor is the load carried after each
    position, (ndim, F, L) (padding repeats the route's total); None
    without pairs.
    """
    F, L = R.shape
    dtype = p.e.dtype
    valid = R >= 0  # (F, L)
    Rc = torch.where(valid, R, 0)
    locs_mid = torch.where(valid, p.order_loc[Rc], p.veh_return[:, None])
    locs = torch.cat(
        [p.veh_start[:, None], locs_mid, p.veh_return[:, None]], dim=1
    )  # (F, L+2)
    zero = torch.zeros((F, 1), dtype=dtype, device=R.device)
    e_aug = torch.cat(
        [p.veh_tw_early[:, None], torch.where(valid, p.e[Rc], 0.0), zero],
        dim=1,
    )
    l_aug = torch.cat(
        [torch.full((F, 1), BIG, dtype=dtype, device=R.device),
         torch.where(valid, p.l[Rc], BIG),
         p.veh_tw_late[:, None]], dim=1,
    )
    s_aug = torch.cat(
        [zero, torch.where(valid, p.s[Rc], 0.0), zero], dim=1
    )
    ti = p.veh_ti  # (F,)
    # NOTE: cost/time matrices stay (T, n_loc, n_loc) and every lookup
    # indexes by TYPE (ti[f]) — materializing per-vehicle copies
    # (p.cost_mats[ti] -> (F, n, n)) was a 27 GB broadcast at 4,000
    # orders in cuopt_tpu
    # arc times between consecutive augmented positions
    t_arc = p.time_mats[ti[:, None], locs[:, :-1], locs[:, 1:]]
    # forward pass: arrival/departure, one step per position
    dep_prev = p.veh_tw_early
    arrs, deps = [p.veh_tw_early], [dep_prev]
    for j in range(L + 1):
        a = torch.maximum(dep_prev + t_arc[:, j], e_aug[:, j + 1])
        dep_prev = a + s_aug[:, j + 1]
        arrs.append(a)
        deps.append(dep_prev)
    arr = torch.stack(arrs, dim=1)  # (F, L+2) arrival at each position
    dep = torch.stack(deps, dim=1)

    # backward pass: latest feasible arrival
    lat_next = l_aug[:, -1]
    lats = [lat_next]
    for j in range(L, -1, -1):
        lat_next = torch.minimum(
            l_aug[:, j], lat_next - t_arc[:, j] - s_aug[:, j])
        lats.append(lat_next)
    lat = torch.stack(lats[::-1], dim=1)

    dem_pos = torch.where(valid[None], p.demand[:, Rc], 0.0)
    load = dem_pos.sum(dim=2)  # (ndim, F)
    pre_load = torch.cumsum(dem_pos, dim=2) if p.has_pairs else None
    return locs, arr, dep, lat, load, ti, valid, pre_load


def _carried(pre_load):
    """(P, S), each (ndim, F, L+1), from _route_tensors' carried load:
    P[j] the load after the first j orders (P[0] = 0), S[j] the largest
    of P[j:], the peak a change of load from slot j on shifts. A
    feasible route has every P within the capacity, so a move that adds
    demand d at slot j keeps the route feasible when S[j] + d does."""
    ndim, F, _ = pre_load.shape
    P = torch.cat([torch.zeros((ndim, F, 1), dtype=pre_load.dtype,
                               device=pre_load.device), pre_load], dim=2)
    S = torch.flip(torch.cummax(torch.flip(P, [2]), dim=2).values, [2])
    return P, S


def _pair_costs(mats, ti, row_loc, u, transpose=False):
    """mats[ti[f], a, b] looked up at (row_loc[f, j], u) for every u: a
    direct element gather (cuopt_tpu's off-TPU form).

    `mats` is the (T, n_loc, n_loc) per-TYPE matrix — lookups index by
    vehicle type so no (F, n_loc, n_loc) copy ever materializes."""
    if transpose:
        return mats[ti[:, None, None], u[None, None, :], row_loc[:, :, None]]
    return mats[ti[:, None, None], row_loc[:, :, None], u[None, None, :]]


def _suffix_all(bad, dim):
    """True where no `bad` entry lies at or after this index along dim."""
    c = torch.flip(torch.cumsum(torch.flip(bad.to(_I64), [dim]), dim),
                   [dim])
    return c == 0


def _move_scores(p: LsProblem, R, lens):
    """Score all candidate moves; returns the five dense score tensors
    (relocate, swap, 2-opt, 2-opt*, or-opt2), masked-invalid = BIG."""
    F, L = R.shape
    locs, arr, dep, lat, load, ti, valid, pre_load = _route_tensors(
        p, R, lens)
    cmat, tmat = p.cost_mats, p.time_mats  # (T, n, n), type-indexed
    Rc = torch.where(valid, R, 0)
    fvec = _arange(F, R)
    # the load a change from slot j (relocate, insertion) or from
    # position i (swap, removal) on adds to: the route's total without
    # pairs, the peak carried load from there on with them
    if pre_load is None:
        peak_slot = peak_after = load[:, :, None]  # (ndim, F, 1)
    else:
        carried, peak_slot = _carried(pre_load)    # (ndim, F, L+1)
        peak_after = peak_slot[:, :, 1:]           # (ndim, F, L)

    # per-route current arc cost, for max-route-cost move dimensions
    if p.has_max_cost:
        pos_arc = _arange(L + 1, R)
        c_arc = cmat[ti[:, None], locs[:, :-1], locs[:, 1:]]
        c_arc = torch.where(pos_arc[None] <= lens[:, None], c_arc, 0.0)
        c_arc = torch.where((lens > 0)[:, None], c_arc, 0.0)  # (F, L+1)
        ccost = c_arc.sum(dim=1)                               # (F,)
        pre_c = torch.cat(
            [torch.zeros((F, 1), dtype=c_arc.dtype, device=R.device),
             torch.cumsum(c_arc, dim=1)[:, :L]], dim=1,
        )                                                      # (F, L+1)
        tail_int = ccost[:, None] - pre_c - c_arc              # (F, L+1)

    # ---- relocate: u at (r1, i) -> insert at slot (r2, j) ----
    # removal gain for each position i (1-based augmented index i+1)
    ar = fvec[:, None]
    pos = _arange(L, R)
    prev_loc = locs[ar, pos]          # predecessor of order at i
    u_loc = locs[ar, pos + 1]
    next_loc = locs[ar, pos + 2]
    c_r1 = cmat[ti[ar], prev_loc, u_loc] + cmat[ti[ar], u_loc, next_loc] - \
        cmat[ti[ar], prev_loc, next_loc]  # (F, L) removal saving
    u_ids = Rc  # (F, L)
    u_dem = p.demand[:, u_ids]  # (ndim, F, L)
    u_movable = valid & p.movable[u_ids]

    # insertion cost of order u into slot (r2, j): between aug j and j+1
    slot = _arange(L + 1, R)
    q_loc = locs[:, :L + 1]       # (F, L+1) slot predecessor location
    qn_loc = locs[:, 1:L + 2]     # slot successor location
    # ins_cost[r2, j, u] = c2(q_j, loc_u) + c2(loc_u, q_{j+1}) - c2(q_j,q_{j+1})
    u_loc_flat = p.order_loc[Rc].reshape(-1)  # (F*L,)
    cA = _pair_costs(cmat, ti, q_loc, u_loc_flat).reshape(F, L + 1, F, L)
    cB = _pair_costs(cmat, ti, qn_loc, u_loc_flat,
                     transpose=True).reshape(F, L + 1, F, L)
    cC = cmat[ti[:, None], q_loc, qn_loc][:, :, None, None]
    ins_cost = cA + cB - cC  # (F2, L+1, F1, L)

    reloc_delta = ins_cost - c_r1[None, None, :, :]

    # feasibility
    slot_valid = slot[None, :] <= lens[:, None]  # (F2, L+1)
    cap_ok = torch.all(
        (peak_slot[:, :, :, None, None] + u_dem[:, None, None, :, :])
        <= p.capacity[:, :, None, None, None] + 1e-6, dim=0,
    )  # (F2, 1 or L+1, F1, L)
    if pre_load is not None:
        # the donor's load after u's position drops by u's demand
        cap_ok = cap_ok & torch.all(
            peak_after - u_dem <= p.capacity[:, :, None] + 1e-6, dim=0)
    allowed_ok = p.allowed[Rc].permute(2, 0, 1)  # (F2, F1, L)
    if p.has_tw:
        tA = _pair_costs(tmat, ti, q_loc, u_loc_flat).reshape(
            F, L + 1, F, L)
        tB = _pair_costs(tmat, ti, qn_loc, u_loc_flat,
                         transpose=True).reshape(F, L + 1, F, L)
        dep_slot = dep[:, :L + 1]  # (F2, L+1) departure at slot pred
        arr_u = torch.maximum(
            dep_slot[:, :, None, None] + tA, p.e[Rc][None, None, :, :])
        ok_u = arr_u <= p.l[Rc][None, None, :, :] + 1e-6
        lat_next = lat[:, 1:L + 2]  # (F2, L+1) latest arrival at slot succ
        ok_next = (
            arr_u + p.s[Rc][None, None, :, :] + tB
            <= lat_next[:, :, None, None] + 1e-6
        )
        tw_ok = ok_u & ok_next
    else:
        tw_ok = torch.ones_like(reloc_delta, dtype=torch.bool)

    same_route = fvec[:, None, None, None] == fvec[None, None, :, None]
    reloc_mask = (
        slot_valid[:, :, None, None]
        & u_movable[None, None, :, :]
        & cap_ok
        & allowed_ok[:, None, :, :]
        & tw_ok
        & ~same_route
        # receiving route must still fit in the padded width L
        & (lens[:, None, None, None] + 1 <= L)
    )
    if p.has_max_cost:
        # receiving route's new arc cost within its cap (donor only
        # loses cost); axes (F2, L+1, F1, L)
        reloc_mask = reloc_mask & (
            ccost[:, None, None, None] + ins_cost
            <= p.veh_max_cost[:, None, None, None] + 1e-6
        )
    # fixed-cost effects: opening r2, closing r1
    open2 = torch.where(lens == 0, p.veh_fixed, 0.0)
    close1 = torch.where(lens == 1, p.veh_fixed, 0.0)
    reloc_delta = reloc_delta + open2[:, None, None, None] - \
        close1[None, None, :, None]
    reloc_score = torch.where(reloc_mask, reloc_delta, BIG)

    # ---- swap: u at (r1,i) <-> w at (r2,k), r1 < r2 ----
    # replacing u by w at (r1, i):
    # delta1 = c1(prev,w)+c1(w,next)-c1(prev,u)-c1(u,next)
    d_in = (
        _pair_costs(cmat, ti, prev_loc, u_loc_flat).reshape(F, L, F, L)
        + _pair_costs(cmat, ti, next_loc, u_loc_flat,
                      transpose=True).reshape(F, L, F, L)
        - (cmat[ti[ar], prev_loc, u_loc]
           + cmat[ti[ar], u_loc, next_loc])[:, :, None, None]
    )  # (F1, L_i, F2, L_k): cost change in r1 when w replaces u
    swap_delta = d_in + d_in.permute(2, 3, 0, 1)

    dem_u = p.demand[:, Rc]  # (ndim, F, L)
    cap_ok_sw = torch.all(
        (peak_after[:, :, :, None, None] - dem_u[:, :, :, None, None]
         + dem_u[:, None, None, :, :])
        <= p.capacity[:, :, None, None, None] + 1e-6, dim=0,
    )  # (F1, L_i, F2, L_k) load1 - u + w
    cap_ok_sw2 = cap_ok_sw.permute(2, 3, 0, 1)
    # allowed: w (at r2,k) must be allowed on r1, u (at r1,i) on r2.
    # T1[t, f, l] = order at (f, l) allowed on vehicle t
    T1 = p.allowed[Rc].permute(2, 0, 1)
    allowed_full = (
        T1[:, None, :, :]                        # (F1, 1, F2, Lk)
        & T1.permute(1, 2, 0)[:, :, :, None]     # (F1, Li, F2, 1)
    )

    if p.has_tw:
        tw_in = torch.maximum(
            dep[:, :L][:, :, None, None]
            + _pair_costs(tmat, ti, prev_loc, u_loc_flat).reshape(
                F, L, F, L),
            p.e[Rc][None, None],
        )  # arrival of w at (r1,i)
        ok_w = tw_in <= p.l[Rc][None, None] + 1e-6
        ok_wn = (
            tw_in + p.s[Rc][None, None]
            + _pair_costs(tmat, ti, next_loc, u_loc_flat,
                          transpose=True).reshape(F, L, F, L)
            <= lat[:, 2:L + 2][:, :, None, None] + 1e-6
        )
        tw_ok1 = ok_w & ok_wn  # (F1, L_i, F2, L_k)
        tw_ok_sw = tw_ok1 & tw_ok1.permute(2, 3, 0, 1)
    else:
        tw_ok_sw = torch.ones_like(swap_delta, dtype=torch.bool)

    movable2 = valid & p.movable[Rc]
    r1_idx = fvec[:, None, None, None]
    r2_idx = fvec[None, None, :, None]
    swap_mask = (
        movable2[:, :, None, None]
        & movable2[None, None, :, :]
        & (r1_idx != r2_idx)
        & cap_ok_sw
        & cap_ok_sw2
        & allowed_full
        & tw_ok_sw
    )
    if p.has_max_cost:
        ok1 = (ccost[:, None, None, None] + d_in
               <= p.veh_max_cost[:, None, None, None] + 1e-6)
        swap_mask = swap_mask & ok1 & ok1.permute(2, 3, 0, 1)
    swap_score = torch.where(swap_mask, swap_delta, BIG)

    # ---- 2-opt intra-route (symmetric, no TW): reverse segment [i..k] ----
    if p.allow_2opt:
        i_idx = _arange(L, R)[None, :, None]
        k_idx = _arange(L, R)[None, None, :]
        fv = fvec[:, None, None]
        pi_prev = locs[fv, i_idx]      # loc before i
        pi = locs[fv, i_idx + 1]
        pk = locs[fv, k_idx + 1]
        pk_next = locs[fv, k_idx + 2]
        tv = ti[:, None, None]
        two_delta = (
            cmat[tv, pi_prev, pk]
            + cmat[tv, pi, pk_next]
            - cmat[tv, pi_prev, pi]
            - cmat[tv, pk, pk_next]
        )
        two_mask = (
            (i_idx < k_idx)
            & (k_idx < lens[:, None, None])
            & valid[:, :, None] & valid[:, None, :]
        )
        if pre_load is not None:
            # reversed, orders k..i are taken in turn: the peak inside
            # is carried[i] + carried[k+1] - min(carried[i..k])
            t_idx = _arange(L, R)
            low = torch.where(
                t_idx[None, None, None, :] >= i_idx[None],
                carried[:, :, None, :L], BIG)        # (ndim, F, L_i, L_t)
            low = torch.cummin(low, dim=3).values    # min over [i..k]
            two_mask = two_mask & torch.all(
                carried[:, :, :L, None] + carried[:, :, None, 1:] - low
                <= p.capacity[:, :, None, None] + 1e-6, dim=0)
        two_score = torch.where(two_mask, two_delta, BIG)
    else:
        two_score = torch.full((F, 1, 1), BIG, dtype=reloc_score.dtype,
                               device=R.device)

    # ---- 2-opt* (inter-route tail exchange; reference CROSS-exchange,
    # local_search/vrp tail kernels): cut r1 after i kept orders and r2
    # after k kept orders, swap tails. Restricted to "compatible"
    # vehicle pairs (same type matrix, same return location, same
    # shift-end) so the tail's internal arc costs/times are unchanged.
    cut = _arange(L + 1, R)                       # kept-order count
    u_cut = locs[:, :L + 1]                       # (F, L+1) last kept loc
    v_succ = locs[:, 1:L + 2]                     # (F, L+1) first tail loc
    dep_cut = dep[:, :L + 1]                      # departure at cut point
    lat_succ = lat[:, 1:L + 2]                    # latest arrival at succ
    # suffix demand per cut: sum of demands of orders at list idx >= i
    dem_pos = torch.where(valid[None], p.demand[:, Rc], 0.0)  # (ndim,F,L)
    suf_dem = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(dem_pos, [2]), dim=2), [2]),
         torch.zeros((dem_pos.shape[0], F, 1), dtype=dem_pos.dtype,
                     device=R.device)], dim=2,
    )  # (ndim, F, L+1)
    pre_dem = load[:, :, None] - suf_dem          # (ndim, F, L+1)
    # suffix movable / suffix-allowed-on-vehicle
    mov_pos = torch.where(valid, p.movable[Rc], True)  # (F, L)
    suf_mov = torch.cat(
        [_suffix_all(~mov_pos, 1),
         torch.ones((F, 1), dtype=torch.bool, device=R.device)], dim=1,
    )  # (F, L+1): all orders at idx >= i movable
    alw_pos = torch.where(valid[:, :, None], p.allowed[Rc], True)  # (F,L,F2)
    suf_alw = torch.cat(
        [_suffix_all(~alw_pos, 1),
         torch.ones((F, 1, F), dtype=torch.bool, device=R.device)], dim=1,
    )  # (F, L+1, F2): all tail orders of F allowed on vehicle F2

    f1 = fvec[:, None, None, None]
    f2 = fvec[None, None, :, None]
    i_c = cut[None, :, None, None]
    k_c = cut[None, None, None, :]
    # new route sizes after the exchange
    n1_new = i_c + (lens[None, None, :, None] - k_c)
    n2_new = k_c + (lens[:, None, None, None] - i_c)
    # Two new cross arcs c_{f1}(u1_i, v2_{k+1}) + c_{f2}(u2_k, v1_{i+1})
    # minus the two old ones — except that an EMPTY route traverses no
    # start->return arc in the exact host model (route_cost charges 0), so
    # the fictitious arc of a route that is empty before (lens==0) or
    # after (n_new==0) the exchange is zeroed rather than priced.
    v_flat = v_succ.reshape(-1)
    cross_a = _pair_costs(cmat, ti, u_cut, v_flat).reshape(
        F, L + 1, F, L + 1
    )  # [f, i, f', k] = c_f(u_cut[f,i], v_succ[f',k])
    new1 = torch.where(n1_new == 0, 0.0, cross_a)
    new2 = torch.where(n2_new == 0, 0.0, cross_a.permute(2, 3, 0, 1))
    old1 = torch.where(
        lens[:, None, None, None] == 0, 0.0,
        cmat[ti[f1], u_cut[:, :, None, None], v_succ[:, :, None, None]],
    )
    old2 = torch.where(
        lens[None, None, :, None] == 0, 0.0,
        cmat[ti[f2], u_cut[None, None], v_succ[None, None]],
    )
    ts_delta = new1 + new2 - old1 - old2  # (F1, L+1, F2, L+1)
    # fixed-cost change from routes opening/closing
    was1 = lens[:, None, None, None] > 0
    was2 = lens[None, None, :, None] > 0
    dt = ts_delta.dtype
    ts_delta = (
        ts_delta
        + p.veh_fixed[:, None, None, None]
        * ((n1_new > 0).to(dt) - was1.to(dt))
        + p.veh_fixed[None, None, :, None]
        * ((n2_new > 0).to(dt) - was2.to(dt))
    )
    compat = (
        (p.veh_ti[:, None] == p.veh_ti[None, :])
        & (p.veh_return[:, None] == p.veh_return[None, :])
        & (p.veh_tw_late[:, None] == p.veh_tw_late[None, :])
        # skip_first/drop_return change which terminal arcs are priced:
        # the cancellation of tail-internal terms is only valid when both
        # vehicles price their terminal arcs identically
        & (p.skip_first[:, None] == p.skip_first[None, :])
        & (p.drop_return[:, None] == p.drop_return[None, :])
    )  # (F1, F2)
    # the received tail adds its demand to the kept head's load; with
    # pairs, its peak rise over its first stop
    tail_rise = suf_dem if pre_load is None else peak_slot - carried
    cap1_ok = torch.all(
        pre_dem[:, :, :, None, None] + tail_rise[:, None, None, :, :]
        <= p.capacity[:, :, None, None, None] + 1e-6, dim=0,
    )  # (F1, L+1, F2, L+1)
    cap2_ok = cap1_ok.permute(2, 3, 0, 1)
    if p.has_tw:
        t_cross1 = _pair_costs(tmat, ti, u_cut, v_flat).reshape(
            F, L + 1, F, L + 1)
        t_cross2 = t_cross1.permute(2, 3, 0, 1)
        tw1_ok = (dep_cut[:, :, None, None] + t_cross1
                  <= lat_succ[None, None] + 1e-6)
        tw2_ok = (dep_cut[None, None] + t_cross2
                  <= lat_succ[:, :, None, None] + 1e-6)
        ts_tw_ok = tw1_ok & tw2_ok
    else:
        ts_tw_ok = torch.ones_like(ts_delta, dtype=torch.bool)
    cut1_valid = cut[None, :] <= lens[:, None]    # (F, L+1)
    # allowed: tail of r2 (idx >= k) on vehicle r1, and tail of r1 on r2
    alw_tail2_on1 = suf_alw[fvec[None, None, :, None], k_c,
                            fvec[:, None, None, None]]
    alw_tail1_on2 = suf_alw[fvec[:, None, None, None], i_c,
                            fvec[None, None, :, None]]
    ts_mask = (
        compat[:, None, :, None]
        & (f1 != f2)
        & cut1_valid[:, :, None, None]
        & cut1_valid[None, None]
        & suf_mov[:, :, None, None]
        & suf_mov[None, None]
        & alw_tail2_on1
        & alw_tail1_on2
        & cap1_ok & cap2_ok & ts_tw_ok
        # both resulting routes must fit in the padded width L
        & (n1_new <= L) & (n2_new <= L)
    )
    if p.has_max_cost:
        # new arc cost of each route: kept prefix + new cross arc +
        # internal cost of the received tail (tail arcs are identical
        # across compat vehicles)
        cost1_new = (pre_c[:, :, None, None] + new1
                     + tail_int[None, None, :, :])
        cost2_new = (pre_c[None, None, :, :] + new2
                     + tail_int[:, :, None, None])
        ts_mask = ts_mask & (
            (cost1_new <= p.veh_max_cost[:, None, None, None] + 1e-6)
            & (cost2_new <= p.veh_max_cost[None, None, :, None] + 1e-6)
        )
    # exchanges that leave the cost as it is score 0: two empty tails
    # (both routes unchanged), and two whole routes swapped between
    # vehicles of one start and fixed cost. float32 rounds new1 + new2 -
    # old1 - old2 there to as low as -2e-6, below the local search's
    # -1e-7, so each was applied as an improving move (cuopt_tpu keeps
    # the rounding)
    same = (p.veh_start[:, None] == p.veh_start[None, :]) & \
        (p.veh_fixed[:, None] == p.veh_fixed[None, :])       # (F1, F2)
    no_op = ((i_c == lens[:, None, None, None])
             & (k_c == lens[None, None, :, None])) | \
        ((i_c == 0) & (k_c == 0) & same[:, None, :, None])
    ts_score = torch.where(ts_mask, torch.where(no_op, 0.0, ts_delta), BIG)

    # ---- Or-opt: move the 2-segment (i, i+1) of r1 into slot (r2, j) ----
    seg_ok = valid & torch.cat(
        [valid[:, 1:], torch.zeros((F, 1), dtype=torch.bool,
                                   device=R.device)], dim=1
    )  # positions i with a valid successor i+1
    uA = locs[ar, pos + 1]                        # (F, L) first seg loc
    uB = locs[ar, torch.clamp(pos + 2, max=L + 1)]   # second seg loc
    uNext = locs[ar, torch.clamp(pos + 3, max=L + 1)]  # successor
    rem_save = (
        cmat[ti[ar], prev_loc, uA] + cmat[ti[ar], uA, uB]
        + cmat[ti[ar], uB, uNext] - cmat[ti[ar], prev_loc, uNext]
    )  # (F1, L)
    idsA = Rc
    idsB_safe = torch.where(seg_ok, torch.roll(Rc, -1, dims=1), idsA)
    locA = p.order_loc[idsA]
    locB = p.order_loc[idsB_safe]
    # locA == u_loc_flat, so oA reuses the relocate cA tensor
    oA = cA
    # oI[f2, j, f1, i] = c_{f2}(locA[f1,i], locB[f1,i]): a per-(f2, u)
    # element gather broadcast over j
    oI = cmat[ti[:, None, None], locA[None], locB[None]][:, None]
    oB = _pair_costs(cmat, ti, qn_loc, locB.reshape(-1),
                     transpose=True).reshape(F, L + 1, F, L)
    oro_delta = oA + oI + oB - cC - rem_save[None, None]
    seg_dem = p.demand[:, idsA] + torch.where(
        seg_ok[None], p.demand[:, idsB_safe], 0.0
    )  # (ndim, F1, L)
    oro_cap_ok = torch.all(
        (peak_slot[:, :, :, None, None] + seg_dem[:, None, None, :, :])
        <= p.capacity[:, :, None, None, None] + 1e-6, dim=0,
    )  # (F2, 1 or L+1, F1, L)
    seg_movable = seg_ok & p.movable[idsA] & p.movable[idsB_safe]
    if pre_load is not None:
        # an adjacent pickup and its delivery move as one segment: the
        # pair relocate. Its load rides between the two stops only, so
        # the receiving route must carry the slot's load plus the
        # pickup's there, and the rest of the route by the segment's net
        oro_cap_ok = oro_cap_ok & torch.all(
            carried[:, :, :, None, None]
            + p.demand[:, idsA][:, None, None, :, :]
            <= p.capacity[:, :, None, None, None] + 1e-6, dim=0)
        # the donor's load after the segment drops by its net demand
        after_seg = torch.cat([peak_slot[:, :, 2:], peak_slot[:, :, -1:]],
                              dim=2)                     # (ndim, F1, L)
        oro_cap_ok = oro_cap_ok & torch.all(
            after_seg - seg_dem <= p.capacity[:, :, None] + 1e-6, dim=0)
        seg_movable = seg_movable | (
            seg_ok & (p.pair_next[idsA] == idsB_safe))
    alw_seg = p.allowed[idsA] & p.allowed[idsB_safe]  # (F1, L, F2)
    alw_seg_t = alw_seg.permute(2, 0, 1)              # (F2, F1, L)
    if p.has_tw:
        tI_ = tmat[ti[:, None, None], locA[None], locB[None]][:, None]
        tB_ = _pair_costs(tmat, ti, qn_loc, locB.reshape(-1),
                          transpose=True).reshape(F, L + 1, F, L)
        eA = p.e[idsA][None, None]
        lA = p.l[idsA][None, None]
        sA = p.s[idsA][None, None]
        eB = p.e[idsB_safe][None, None]
        lB = p.l[idsB_safe][None, None]
        sB = p.s[idsB_safe][None, None]
        # tA: identical index structure (locA == u_loc_flat)
        arr_A = torch.maximum(dep_slot[:, :, None, None] + tA, eA)
        ok_A = arr_A <= lA + 1e-6
        arr_B = torch.maximum(arr_A + sA + tI_, eB)
        ok_B = arr_B <= lB + 1e-6
        ok_N = arr_B + sB + tB_ <= lat_next[:, :, None, None] + 1e-6
        oro_tw_ok = ok_A & ok_B & ok_N
    else:
        oro_tw_ok = torch.ones_like(oro_delta, dtype=torch.bool)
    oro_mask = (
        slot_valid[:, :, None, None]
        & seg_movable[None, None]
        & oro_cap_ok
        & alw_seg_t[:, None]
        & oro_tw_ok
        & ~same_route
        # receiving route gains 2 orders; must fit in padded width L
        & (lens[:, None, None, None] + 2 <= L)
    )
    if p.has_max_cost:
        oro_mask = oro_mask & (
            ccost[:, None, None, None] + (oA + oI + oB - cC)
            <= p.veh_max_cost[:, None, None, None] + 1e-6
        )
    close1_seg = torch.where(lens == 2, p.veh_fixed, 0.0)
    oro_delta = oro_delta + open2[:, None, None, None] - \
        close1_seg[None, None, :, None]
    oro_score = torch.where(oro_mask, oro_delta, BIG)
    return reloc_score, swap_score, two_score, ts_score, oro_score


def evaluate_moves(p: LsProblem, R, lens):
    """Score all moves; return (delta, kind, (a, b, c, d))."""
    R, lens = _ids(p, R), _ids(p, lens)
    scores = _move_scores(p, R, lens)
    bests = [torch.min(s) for s in scores]
    r_best, s_best, t_best, ts_best, o_best = bests
    best = torch.minimum(
        torch.minimum(torch.minimum(r_best, s_best), t_best),
        torch.minimum(ts_best, o_best),
    )
    # argmin returns the first minimal index, as jnp.argmin does
    r_arg, s_arg, t_arg, ts_arg, o_arg = (
        torch.unravel_index(torch.argmin(s), s.shape) for s in scores)
    kind = torch.where(
        best == r_best, 0,
        torch.where(
            best == s_best, 1,
            torch.where(best == t_best, 2,
                        torch.where(best == ts_best, 3, 4)),
        ),
    )
    # unified move encoding:
    #  relocate: (r2, slot j, r1, i)
    #  swap:     (r1, i, r2, k)
    #  2opt:     (r, i, r, k)
    #  2opt*:    (r1, cut i, r2, cut k)
    #  or-opt2:  (r2, slot j, r1, i)
    enc = torch.stack([
        torch.stack(list(r_arg)),
        torch.stack(list(s_arg)),
        torch.stack([t_arg[0], t_arg[1], t_arg[0], t_arg[2]]),
        torch.stack(list(ts_arg)),
        torch.stack(list(o_arg)),
    ])  # (5, 4)
    return best, kind, enc[kind]


def _insertion_scores(p: LsProblem, R, lens, cand):
    F, L = R.shape
    locs, arr, dep, lat, load, ti, valid, pre_load = _route_tensors(
        p, R, lens)
    cmat, tmat = p.cost_mats, p.time_mats  # (T, n, n), type-indexed
    u_loc = p.order_loc[cand]                # (P,)
    slot = _arange(L + 1, R)
    q_loc = locs[:, :L + 1]                  # (F, L+1)
    qn_loc = locs[:, 1:L + 2]
    cA = _pair_costs(cmat, ti, q_loc, u_loc).permute(2, 0, 1)  # (P,F,L+1)
    cB = _pair_costs(cmat, ti, qn_loc, u_loc, transpose=True).permute(
        2, 0, 1)
    cC = cmat[ti[:, None], q_loc, qn_loc][None]
    delta = cA + cB - cC                     # (P, F, L+1)
    # opening an empty route pays its fixed cost
    delta = delta + torch.where(lens == 0, p.veh_fixed, 0.0)[None, :, None]

    slot_ok = slot[None, :] <= lens[:, None]           # (F, L+1)
    # the route's total, or with pairs its peak carried load from the slot
    peak_slot = load[:, :, None] if pre_load is None \
        else _carried(pre_load)[1]
    cap_ok = torch.all(
        peak_slot[:, None] + p.demand[:, cand][:, :, None, None]
        <= p.capacity[:, None, :, None] + 1e-6, dim=0,
    )  # (P, F, 1 or L+1)
    fit_ok = (lens + 1 <= L)[None, :]                  # (1, F)
    allowed_ok = p.allowed[cand]                       # (P, F)
    if p.has_tw:
        tA = _pair_costs(tmat, ti, q_loc, u_loc).permute(2, 0, 1)
        tB = _pair_costs(tmat, ti, qn_loc, u_loc, transpose=True).permute(
            2, 0, 1)
        dep_slot = dep[:, :L + 1]
        arr_u = torch.maximum(dep_slot[None] + tA, p.e[cand][:, None, None])
        ok_u = arr_u <= p.l[cand][:, None, None] + 1e-6
        lat_next = lat[:, 1:L + 2]
        ok_n = arr_u + p.s[cand][:, None, None] + tB <= \
            lat_next[None] + 1e-6
        tw_ok = ok_u & ok_n
    else:
        tw_ok = torch.ones_like(delta, dtype=torch.bool)
    mask = (
        slot_ok[None]
        & cap_ok
        & (allowed_ok & fit_ok)[:, :, None]
        & tw_ok
    )
    if p.has_max_cost:
        pos_arc = _arange(L + 1, R)
        c_arc = cmat[ti[:, None], locs[:, :-1], locs[:, 1:]]
        c_arc = torch.where(pos_arc[None] <= lens[:, None], c_arc, 0.0)
        c_arc = torch.where((lens > 0)[:, None], c_arc, 0.0)
        ccost = c_arc.sum(dim=1)
        mask = mask & (
            ccost[None, :, None] + (cA + cB - cC)
            <= p.veh_max_cost[None, :, None] + 1e-6
        )
    return torch.where(mask, delta, BIG)


def evaluate_insertions(p: LsProblem, R, lens, cand_ids):
    """Score inserting each candidate order into every slot of every
    route: returns (P, F, L+1) delta-cost tensor, BIG where infeasible.

    This is the device-batched insertion scoring used by large-instance
    construction and the GES insertion step (reference scores insertions
    with GPU kernels inside guided_ejection_search.cuh:81; here one
    program covers all (candidate, route, slot) triples with O(1) TW
    feasibility from the forward/backward route cumulations)."""
    return _insertion_scores(p, _ids(p, R), _ids(p, lens), _ids(p, cand_ids))


def evaluate_insertions_best(p: LsProblem, R, lens, cand_ids, cand_mask):
    """Per-candidate best insertion, reduced ON DEVICE: returns one
    packed (P, 3) float32 tensor (best_delta, best_route, best_slot), so
    that the host reads three P-vectors once instead of the (P, F, L+1)
    score tensor. Construction calls this once per round with cand_ids
    PADDED to a fixed bucket (cand_mask False on padding)."""
    scores = evaluate_insertions(p, R, lens, cand_ids)
    P, F, L1 = scores.shape
    assert F < _EXACT_F32 and L1 < _EXACT_F32  # ids exact in float32
    flat = scores.reshape(P, F * L1)
    idx = torch.argmin(flat, dim=1)  # first minimum, as jnp.argmin
    best = torch.gather(flat, 1, idx[:, None])[:, 0]
    mask = torch.as_tensor(np.asarray(cand_mask, bool), device=p.device)
    best = torch.where(mask, best, BIG)
    return torch.stack(
        [best.to(_F32), (idx // L1).to(_F32), (idx % L1).to(_F32)], dim=1)


def _topk_smallest(flat, kf):
    """The kf smallest entries of the 1-D `flat`, ties broken by the
    lower index, as `jax.lax.top_k(-flat, kf)` does (`torch.topk` makes
    no promise among equal values): a stable sort. Returns (values,
    indices)."""
    vals, idx = torch.sort(flat, stable=True)
    return vals[:kf], idx[:kf]


def evaluate_moves_topk(p: LsProblem, R, lens, kf: int = 8):
    """Top-kf moves per family in one device program.

    The reference executes whole move SETS per GPU iteration
    (local_search/move_candidates/): candidates are generated in bulk and
    a maximal non-conflicting subset is applied. Here the device returns
    the kf best candidates of each family; the host greedily applies all
    that touch disjoint routes, so one device round-trip commits many
    moves instead of one.

    Returns one packed (5*kf, 6) float32 tensor: delta, kind and the
    4-int move encoding per row; padded / invalid entries have
    delta >= BIG.
    """
    R, lens = _ids(p, R), _ids(p, lens)
    F, L = R.shape
    assert F < _EXACT_F32 and L + 1 < _EXACT_F32  # ids exact in float32
    scores = _move_scores(p, R, lens)
    rows = []
    for kind_id, score in enumerate(scores):
        # pad with kf BIG entries, as cuopt_tpu does, so that a family
        # with fewer than kf candidates still yields kf rows
        padded = torch.cat([score.reshape(-1),
                            torch.full((kf,), BIG, dtype=score.dtype,
                                       device=score.device)])
        val, idx = _topk_smallest(padded, kf)
        idx = torch.clamp(idx, max=max(score.numel() - 1, 0))
        args = torch.unravel_index(idx, score.shape)
        if kind_id == 2:
            mv = torch.stack([args[0], args[1], args[0], args[2]], dim=1)
        else:
            mv = torch.stack(list(args), dim=1)
        rows.append(torch.cat(
            [val[:, None], torch.full((kf, 1), kind_id, dtype=_F32,
                                      device=val.device),
             mv.to(_F32)], dim=1))
    # ONE packed array: the host fetches the whole candidate set at once
    return torch.cat(rows)


def evaluate_cycle_gains(p: LsProblem, R, lens):
    """Best single-order relocation gain between every ordered route pair.

    Returns (gain (F, F), pos (F, F), slot (F, F)): gain[r1, r2] = best
    delta of moving ONE order of r1 into r2, with r2's capacity relaxed
    by its smallest movable demand (in an exchange CYCLE every route also
    loses an order; the host re-checks the assembled cycle exactly).
    This is the analogue of the reference cycle finder's per-pair
    relocation gains (local_search/cycle_finder/cycle_finder.cu: device
    hash maps of best moves); the negative-cycle search over the (F, F)
    matrix runs on host (F is small).
    """
    R, lens = _ids(p, R), _ids(p, lens)
    F, L = R.shape
    locs, arr, dep, lat, load, ti, valid, pre_load = _route_tensors(
        p, R, lens)
    cmat, tmat = p.cost_mats, p.time_mats  # (T, n, n), type-indexed
    Rc = torch.where(valid, R, 0)
    fvec = _arange(F, R)
    ar = fvec[:, None]
    pos = _arange(L, R)
    prev_loc = locs[ar, pos]
    u_loc = locs[ar, pos + 1]
    next_loc = locs[ar, pos + 2]
    c_rem = cmat[ti[ar], prev_loc, u_loc] + cmat[ti[ar], u_loc, next_loc] - \
        cmat[ti[ar], prev_loc, next_loc]          # (F1, L) removal saving
    u_loc_flat = p.order_loc[Rc]
    q_loc = locs[:, :L + 1]
    qn_loc = locs[:, 1:L + 2]
    tv = ti[:, None, None, None]
    cA = cmat[tv, q_loc[:, :, None, None], u_loc_flat[None, None]]
    cB = cmat[tv, u_loc_flat[None, None], qn_loc[:, :, None, None]]
    cC = cmat[ti[:, None], q_loc, qn_loc][:, :, None, None]
    ins = cA + cB - cC                        # (F2, L+1, F1, L)
    delta = ins - c_rem[None, None]

    u_movable = valid & p.movable[Rc]
    u_dem = p.demand[:, Rc]                   # (ndim, F1, L)
    # r2's smallest movable demand (it loses one order in the cycle)
    dem_mov = torch.where(u_movable[None], u_dem, float("inf"))
    min_out = torch.amin(dem_mov, dim=2)      # (ndim, F2)
    min_out = torch.where(torch.isfinite(min_out), min_out, 0.0)
    # r2's load from the slot on: its total, or with pairs its peak
    # carried load from the slot on
    peak_slot = load[:, :, None] if pre_load is None \
        else _carried(pre_load)[1]
    cap_ok = torch.all(
        peak_slot[:, :, :, None, None] - min_out[:, :, None, None, None]
        + u_dem[:, None, None]
        <= p.capacity[:, :, None, None, None] + 1e-6, dim=0,
    )                                         # (F2, 1 or L+1, F1, L)
    allowed_ok = p.allowed[Rc].permute(2, 0, 1)
    slot_ok = _arange(L + 1, R)[None, :] <= lens[:, None]
    if p.has_tw:
        tA = tmat[tv, q_loc[:, :, None, None], u_loc_flat[None, None]]
        tB = tmat[tv, u_loc_flat[None, None], qn_loc[:, :, None, None]]
        dep_slot = dep[:, :L + 1]
        arr_u = torch.maximum(
            dep_slot[:, :, None, None] + tA, p.e[Rc][None, None])
        ok_u = arr_u <= p.l[Rc][None, None] + 1e-6
        ok_n = arr_u + p.s[Rc][None, None] + tB <= \
            lat[:, 1:L + 2][:, :, None, None] + 1e-6
        tw_ok = ok_u & ok_n
    else:
        tw_ok = torch.ones_like(delta, dtype=torch.bool)
    same = fvec[:, None, None, None] == fvec[None, None, :, None]
    mask = (
        slot_ok[:, :, None, None]
        & u_movable[None, None]
        & cap_ok
        & allowed_ok[:, None]
        & tw_ok
        & ~same
        & (lens[:, None, None, None] + 1 <= L)
    )
    score = torch.where(mask, delta, BIG)     # (F2, L+1, F1, L)
    # reduce to per-(r1 -> r2) best move
    flat = score.permute(2, 0, 1, 3).reshape(F, F, -1)  # (F1, F2, (L+1)L)
    best = torch.amin(flat, dim=2)
    argb = torch.argmin(flat, dim=2)  # the first minimum, as jnp.argmin
    return best, argb % L, argb // L


def evaluate_vehicle_reassign(p: LsProblem, R, lens):
    """Cost + feasibility of serving route r's order SEQUENCE with every
    vehicle v (reference HVRP regret kernels, local_search/hvrp/): one
    (F_veh, F_route, L) forward time pass under each vehicle's matrices.

    Returns (cost (F2, F1), feasible (F2, F1)); infeasible = BIG cost.
    The host-side regret selection reassigns routes to cheaper vehicles.
    """
    R, lens = _ids(p, R), _ids(p, lens)
    F, L = R.shape
    dtype = p.e.dtype
    dev = R.device
    valid = R >= 0
    Rc = torch.where(valid, R, 0)
    # order locations per route position; terminal locs PER VEHICLE v2
    locs_mid = p.order_loc[Rc]                     # (F1, L)
    ti = p.veh_ti
    v2 = ti[:, None, None]                         # type per vehicle
    start2 = p.veh_start[:, None, None]            # (F2, 1, 1)
    ret2 = p.veh_return[:, None, None]
    # augmented location sequence under vehicle v2: (F2, F1, L+2)
    locs = torch.cat([
        start2.expand(F, F, 1),
        torch.where(valid, locs_mid, p.veh_return[0])[None].expand(F, F, L),
        ret2.expand(F, F, 1),
    ], dim=2)
    # pad positions use the vehicle's return loc so padded arcs cost 0
    pos_valid = torch.cat([
        torch.ones((F, F, 1), dtype=torch.bool, device=dev),
        valid[None].expand(F, F, L),
        torch.ones((F, F, 1), dtype=torch.bool, device=dev),
    ], dim=2)
    locs = torch.where(pos_valid, locs, ret2)
    t_arc = p.time_mats[v2, locs[:, :, :-1], locs[:, :, 1:]]
    c_arc = p.cost_mats[v2, locs[:, :, :-1], locs[:, :, 1:]]  # (F2,F1,L+1)
    zero = torch.zeros((F, F, 1), dtype=dtype, device=dev)
    e_aug = torch.cat([
        torch.where(valid, p.e[Rc], 0.0)[None].expand(F, F, L), zero], dim=2)
    l_aug = torch.cat([
        torch.where(valid, p.l[Rc], BIG)[None].expand(F, F, L),
        p.veh_tw_late[:, None, None].expand(F, F, 1)], dim=2)
    s_aug = torch.cat([
        torch.where(valid, p.s[Rc], 0.0)[None].expand(F, F, L), zero], dim=2)

    dep_prev = p.veh_tw_early[:, None].expand(F, F)
    ok = torch.ones((F, F), dtype=torch.bool, device=dev)
    for j in range(L + 1):
        a = torch.maximum(dep_prev + t_arc[:, :, j], e_aug[:, :, j])
        ok = ok & (a <= l_aug[:, :, j] + 1e-6)
        dep_prev = a + s_aug[:, :, j]
    cost = c_arc.sum(dim=2)
    # capacity + order-vehicle match + fixed cost
    dem_pos = torch.where(valid[None], p.demand[:, Rc], 0.0)
    # the route's total, or with pairs its peak carried load
    load = dem_pos.sum(dim=2) if not p.has_pairs \
        else torch.cumsum(dem_pos, dim=2).amax(dim=2)
    cap_ok = torch.all(load[:, None, :] <= p.capacity[:, :, None] + 1e-6,
                       dim=0)                     # (F2, F1)
    alw = torch.where(valid[:, :, None], p.allowed[Rc], True)
    alw_ok = torch.all(alw, dim=1).permute(1, 0)  # (F2, F1)
    nonempty = (lens > 0)[None, :]
    cost = cost + torch.where(nonempty, p.veh_fixed[:, None], 0.0)
    feasible = ok & cap_ok & alw_ok & nonempty
    return torch.where(feasible, cost, BIG), feasible


def subset_ls_problem(p: LsProblem, idx) -> LsProblem:
    """Route-subset view: gather every per-vehicle field at `idx` so the
    all-pairs evaluators run on a GROUP of routes (the large-instance
    tiling — all-pairs tensors are O((F*L)^2) and stop fitting around
    2-4k orders; the reference tiles move generation over neighborhoods
    instead, local_search.cuh:102). Order-space fields are unchanged, so
    move encodings index into the subset and map back through `idx`.
    With a 2-D `idx` (tiles, group) each per-vehicle field gains a tile
    axis at its vehicle axis (see VEHICLE_FIELDS)."""
    idx = _ids(p, idx)
    return dataclasses.replace(p, **{
        name: getattr(p, name)[idx] if axis == 0
        else getattr(p, name)[:, idx]
        for name, axis in VEHICLE_FIELDS.items()})


def evaluate_prize_drops(p: LsProblem, R, lens):
    """(F, L) net objective change of dropping each served order:
    prize[u] - (removal arc saving + any fixed-cost close). Negative =
    improving for the prize objective (cost - collected prizes); BIG
    where invalid. The reference scores order drop/pickup inside its LS
    candidate tensors (local_search.cuh:102-160 prize collection)."""
    R, lens = _ids(p, R), _ids(p, lens)
    F, L = R.shape
    locs, arr, dep, lat, load, ti, valid, pre_load = _route_tensors(
        p, R, lens)
    cmat = p.cost_mats
    Rc = torch.where(valid, R, 0)
    ar = _arange(F, R)[:, None]
    pos = _arange(L, R)
    prev_loc = locs[ar, pos]
    u_loc = locs[ar, pos + 1]
    next_loc = locs[ar, pos + 2]
    saving = (
        cmat[ti[ar], prev_loc, u_loc]
        + cmat[ti[ar], u_loc, next_loc]
        - cmat[ti[ar], prev_loc, next_loc]
    )
    close = torch.where(lens == 1, p.veh_fixed, 0.0)
    delta = p.prize[Rc] - saving - close[:, None]
    mask = valid & p.movable[Rc]
    return torch.where(mask, delta, BIG)
