"""Routing solve orchestration.

Mirrors reference routing::solve (cpp/src/routing/solve.cu:30 ->
solver.cu:68 -> ges_solver.cu compute_ges_solution :51): validate, build
problem, construct initial solution, improve with parallel local search,
diversify with ruin-&-recreate restarts until the time limit, return the
best feasible assignment.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cuopt_torch.routing.assignment import (
    Assignment,
    Objective,
    RouteTable,
    SolutionStatus,
)
from cuopt_torch.routing.construction import (
    cheapest_insertion,
    greedy_reinsert,
)
from cuopt_torch.routing.internal import build_problem
from cuopt_torch.routing.settings import SolverSettings, default_time_limit
from cuopt_torch.utils.errors import ValidationError
from cuopt_torch.utils.logger import get_logger
from cuopt_torch.utils.timer import Timer


def _routes_to_arrays(prob, routes, L_pad):
    """(F, L_pad) route matrix (-1 padded) and lengths, on the host: the
    evaluators move them to the problem's device."""
    F = prob.n_fleet
    R = np.full((F, L_pad), -1, np.int64)
    lens = np.zeros(F, np.int64)
    for v, r in routes.items():
        R[v, : len(r)] = r
        lens[v] = len(r)
    return R, lens


def _apply_move(routes, kind, mv):
    kind = int(kind)
    a, b, c, d = (int(x) for x in mv)
    if kind == 0:  # relocate: (r2, slot j, r1, i)
        r2, j, r1, i = a, b, c, d
        u = routes[r1].pop(i)
        routes[r2].insert(j, u)
    elif kind == 1:  # swap: (r1, i, r2, k)
        r1, i, r2, k = a, b, c, d
        routes[r1][i], routes[r2][k] = routes[r2][k], routes[r1][i]
    elif kind == 2:  # 2-opt: (r, i, r, k) reverse positions i..k
        r, i, _, k = a, b, c, d
        routes[r][i:k + 1] = reversed(routes[r][i:k + 1])
    elif kind == 3:  # 2-opt*: (r1, cut i, r2, cut k) exchange tails
        r1, i, r2, k = a, b, c, d
        tail1, tail2 = routes[r1][i:], routes[r2][k:]
        routes[r1] = routes[r1][:i] + tail2
        routes[r2] = routes[r2][:k] + tail1
    else:  # or-opt2: (r2, slot j, r1, i) move segment (i, i+1)
        r2, j, r1, i = a, b, c, d
        seg = routes[r1][i:i + 2]
        del routes[r1][i:i + 2]
        routes[r2][j:j] = seg
    return routes


def _needs_exact_recheck(prob) -> bool:
    """The device move evaluator scores TW/capacity/match constraints
    (with pickup-delivery pairs, the load carried after each stop) but
    not breaks, per-vehicle max cost/time, skip-first/drop-return arc
    pricing, cross-route precedence, or pickup-before-delivery inside a
    route (a 2-opt reversal over a pair); those need a host re-check of
    each applied move. (cuopt_tpu leaves pairs out of the check, and
    returns such reversed routes as SUCCESS.)"""
    import numpy as np

    pd = prob.pd_partner is not None and bool(np.any(prob.pd_partner >= 0))
    return pd or bool(prob.breaks) or bool(prob.precedence) or bool(
        np.any(np.isfinite(prob.veh_max_cost))
        or np.any(np.isfinite(prob.veh_max_time))
        or np.any(prob.skip_first)
        or np.any(prob.drop_return)
    )


def _pad_len(routes, headroom=4) -> int:
    """Padded route width: +headroom, rounded up to a multiple of 8 (so
    that cuopt_tpu's jit recompiles are rare; the port keeps the widths,
    and with them cuopt_tpu's moves)."""
    longest = max((len(r) for r in routes.values()), default=1)
    return max(8, ((longest + headroom + 7) // 8) * 8)


_LS_GROUP = 64  # routes per all-pairs evaluation tile at scale


def _grouped_moves(prob, lsp, R, lens, round_no, group=_LS_GROUP,
                   before_read=None):
    """Large-fleet tiling: the all-pairs move tensors are O((F*L)^2) and
    stop fitting around 2-4k orders, so the fleet is partitioned into
    balanced groups of `group` NEARBY routes (centroids projected on a
    per-round random direction, sorted, chunked — nearby routes land in
    the same tile, and the rotating direction varies the pairings every
    round) and the unchanged evaluator runs over all tiles at once, under
    torch.func.vmap with each per-vehicle field of the problem gathered
    with a tile axis. The reference tiles its move generation over
    neighborhoods the same way (local_search/move_candidates/). Returns
    the concatenated candidate rows with route indices mapped back to
    fleet space, read back in one transfer (`before_read`, when given, is
    called just before it)."""
    from torch.func import vmap

    from cuopt_torch.routing.local_search import (
        VEHICLE_FIELDS,
        evaluate_moves_topk,
        subset_ls_problem,
        to_host,
    )

    F = R.shape[0]
    # R and lens are host arrays: the tiling needs no device read
    R = np.asarray(R)
    lens = np.asarray(lens)
    rng = np.random.default_rng(1009 * (round_no + 1))
    cost = np.asarray(prob.cost_mats[0])
    # 2-D landmark embedding of every location (works without
    # coordinates: distances to two random landmarks triangulate)
    n_loc = cost.shape[0]
    l1, l2 = rng.integers(0, n_loc, 2)
    emb = np.stack([cost[l1], cost[l2]], axis=1)  # (n_loc, 2)
    Rc = np.where(R >= 0, R, 0)
    loc_emb = emb[prob.order_loc[Rc]]             # (F, L, 2)
    mask = (R >= 0)[:, :, None]
    cents = np.where(
        lens[:, None] > 0,
        (loc_emb * mask).sum(axis=1) / np.maximum(lens[:, None], 1),
        emb[prob.veh_start],
    )
    d = rng.normal(size=2)
    order = np.argsort(cents @ d, kind="stable").astype(np.int64)
    pad = (-F) % group
    if pad:
        order = np.concatenate([order, order[:pad]])
    # ALL tiles in ONE vmapped evaluation and one readback
    idx_mat = np.stack([
        np.sort(order[g0:g0 + group])
        for g0 in range(0, len(order), group)
    ])  # (n_tiles, group)
    tiles = subset_ls_problem(lsp, idx_mat)
    fields = {k: getattr(tiles, k) for k in VEHICLE_FIELDS}

    def one_tile(fields, R_t, lens_t):
        sub = dataclasses.replace(tiles, **fields)
        return evaluate_moves_topk(sub, R_t, lens_t)

    dev = lsp.device
    out = vmap(one_tile, in_dims=(VEHICLE_FIELDS, 0, 0))(
        fields, torch.as_tensor(R[idx_mat], device=dev),
        torch.as_tensor(lens[idx_mat], device=dev))
    if before_read is not None:
        before_read()
    packed = to_host(out)  # (n_tiles, K, 6)
    # move encodings carry route indices at mv[0] and mv[2]
    # (packed columns 2 and 4) for every family
    for t in range(packed.shape[0]):
        packed[t, :, 2] = idx_mat[t][packed[t, :, 2].astype(np.int64)]
        packed[t, :, 4] = idx_mat[t][packed[t, :, 4].astype(np.int64)]
    return packed.reshape(-1, packed.shape[-1])


def _prize_pass(prob, lsp, routes, unserved, rng=None):
    """In-LS prize moves (reference prize-collection candidates,
    local_search.cuh:102-160): device-scored DROPS (order's prize is
    below its removal saving) and PICKUPS of unserved orders (best
    insertion cost below the prize) applied with exact host
    verification. Mutates `routes` and `unserved`; returns True when
    the net objective improved."""
    from cuopt_torch.routing.local_search import (
        BIG,
        evaluate_insertions_best,
        evaluate_prize_drops,
        to_host,
    )

    improved = False
    L_pad = _pad_len(routes)
    R, lens = _routes_to_arrays(prob, routes, L_pad)
    drops = to_host(evaluate_prize_drops(lsp, R, lens))
    for f in range(drops.shape[0]):
        i = int(np.argmin(drops[f]))
        r = routes.get(f) or []
        if drops[f, i] < -1e-9 and i < len(r):
            o = r[i]
            cand = r[:i] + r[i + 1:]
            saving = prob.route_cost(f, r) - prob.route_cost(f, cand)
            if float(prob.prizes[o]) < saving - 1e-9:
                routes[f] = cand
                unserved.append(o)
                improved = True
    if unserved:
        L_pad = max(_pad_len(routes), L_pad)
        R, lens = _routes_to_arrays(prob, routes, L_pad)
        P0 = max(8, 1 << max(0, (len(unserved) - 1)).bit_length())
        cand = np.zeros(P0, np.int32)
        cand[: len(unserved)] = unserved
        cmask = np.zeros(P0, bool)
        cmask[: len(unserved)] = True
        packed = to_host(evaluate_insertions_best(
            lsp, R, lens, cand, cmask
        ))
        used: set[int] = set()
        still = []
        for pi, o in enumerate(list(unserved)):
            bd, v, j = (float(packed[pi, 0]), int(packed[pi, 1]),
                        int(packed[pi, 2]))
            take = False
            if bd < BIG / 2 and v not in used and \
                    bd < float(prob.prizes[o]) - 1e-9:
                r = routes.get(v) or []
                cand_r = r[:j] + [o] + r[j:]
                delta = prob.route_cost(v, cand_r) - prob.route_cost(v, r)
                if delta < float(prob.prizes[o]) - 1e-9 and \
                        prob.route_feasible(v, cand_r):
                    routes[v] = cand_r
                    used.add(v)
                    improved = True
                    take = True
            if not take:
                still.append(o)
        unserved[:] = still
    return improved


def _local_search(prob, lsp, routes, timer, max_rounds=10_000,
                  unserved=None, round_stats=None):
    """Batched local search: one device call scores the top-k candidates
    of every move family; the host applies ALL improving candidates that
    touch disjoint routes (the reference executes whole move sets per GPU
    iteration, local_search/move_candidates/). Moves that fail the exact
    host model (breaks, max cost/time, terminal-arc flags) are skipped
    individually, never aborting the search. On prize instances, each
    round also applies device-scored drop/pickup moves when `unserved`
    (a mutable list) is supplied. `round_stats`, when given, is a dict whose
    "rounds", "eval_s" (host wall of the move evaluation, readback
    included) and, on a CUDA problem, "eval_device_ms" (CUDA events
    around it) grow with every round."""
    from cuopt_torch.routing.local_search import (
        evaluate_moves_topk,
        to_host,
    )

    exact = _needs_exact_recheck(prob)
    # generous fixed headroom, kept from cuopt_tpu, where every L_pad
    # growth recompiled the evaluator
    L_pad = _pad_len(routes, headroom=12)
    timed = round_stats is not None and lsp.device.type == "cuda"
    grouped = prob.n_fleet > int(1.5 * _LS_GROUP)
    import os as _os
    import time as _time

    _dbg = _os.environ.get("CUOPT_LS_DEBUG")
    for round_no in range(max_rounds):
        if timer.expired():
            break
        _t0 = _time.perf_counter()
        L_pad = max(L_pad, _pad_len(routes))
        R, lens = _routes_to_arrays(prob, routes, L_pad)
        ev0 = ev1 = None
        if timed:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        if grouped:
            packed = _grouped_moves(prob, lsp, R, lens, round_no,
                                    before_read=ev1.record if timed else None)
        else:
            out = evaluate_moves_topk(lsp, R, lens)
            if timed:
                ev1.record()
            packed = to_host(out)
        _t1 = _time.perf_counter()
        if round_stats is not None:
            rs = round_stats
            rs["rounds"] = rs.get("rounds", 0) + 1
            rs["eval_s"] = rs.get("eval_s", 0.0) + (_t1 - _t0)
            if timed:  # the readback synchronised: both events are done
                rs["eval_device_ms"] = rs.get("eval_device_ms", 0.0) + \
                    ev0.elapsed_time(ev1)
        deltas = packed[:, 0]
        kinds = packed[:, 1].astype(np.int32)
        mvs = packed[:, 2:6].astype(np.int32)
        order = np.argsort(deltas, kind="stable")
        touched: set[int] = set()
        applied = 0
        for c in order:
            if deltas[c] >= -1e-7:
                break
            mv = mvs[c]
            va, vb = int(mv[0]), int(mv[2])
            if va in touched or vb in touched:
                continue
            cand = _apply_move(
                {v: list(r) for v, r in routes.items()}, kinds[c], mv
            )
            if exact:
                # survival instrumentation: with max cost/time scored
                # in the move tensors, most device proposals must now
                # pass the exact recheck (reference carries these as
                # O(1) route dimensions, route/route.cuh:29)
                stats = getattr(prob, "_ls_recheck_stats", None)
                if stats is None:
                    stats = prob._ls_recheck_stats = [0, 0]
                stats[0] += 1
                base = sum(
                    prob.route_cost(v, routes[v]) for v in {va, vb}
                )
                new = sum(
                    prob.route_cost(v, cand[v]) for v in {va, vb}
                )
                if new >= base - 1e-9 or not all(
                    prob.route_feasible(v, cand[v]) for v in {va, vb}
                ):
                    continue  # skip this move, keep scanning candidates
                stats[1] += 1
                if prob.precedence:
                    from cuopt_torch.routing.internal import precedence_ok

                    if not precedence_ok(prob, cand):
                        continue
            routes = cand
            touched.update((va, vb))
            applied += 1
        if _dbg:
            print(f"[round] eval {_t1 - _t0:.2f}s apply "
                  f"{_time.perf_counter() - _t1:.2f}s "
                  f"applied={applied}", flush=True)
        if unserved is not None and prob.prizes is not None and \
                not timer.expired():
            if _prize_pass(prob, lsp, routes, unserved):
                applied += 1
        if applied == 0:
            # pairwise families exhausted: try multi-route exchange
            # cycles (reference cycle_finder.cu) and HVRP vehicle
            # reassignment (local_search/hvrp) before giving up
            from cuopt_torch.routing.cycle_finder import (
                cycle_search,
                hvrp_reassign,
            )

            if timer.expired():
                break
            kept = {v: list(r) for v, r in routes.items()}
            if grouped:
                # cycle/HVRP tensors are all-pairs over the WHOLE fleet
                # (O((F*L)^2)) — out of budget at large F
                improved = imp2 = False
            else:
                routes, improved = cycle_search(prob, lsp, routes)
                routes, imp2 = hvrp_reassign(prob, lsp, routes)
            routes, imp3 = _pdp_pair_improve(prob, routes, timer)
            improved = improved or imp2 or imp3
            if prob.precedence and improved:
                from cuopt_torch.routing.internal import precedence_ok

                if not precedence_ok(prob, routes):
                    # these moves do not check precedence: keep the routes
                    # from before them (cuopt_tpu returns the broken ones)
                    routes = kept
                    break
            if not improved:
                break
    return routes


def _pdp_pair_improve(prob, routes, timer, max_rounds=6):
    """Paired relocate polish for pickup-delivery instances.

    The device move families exclude PD-paired orders (a pickup or
    delivery cannot move alone), so without this pass PDP instances got
    construction + GES only. Each (pickup, delivery) unit is removed
    from its route and re-inserted at its globally best feasible
    position — same or another route, pickup before delivery by
    construction (reference: dedicated PDP solver template with paired
    relocations, cpp/src/routing/solver.cu:85-86 and the CROSS move
    families, local_search/local_search.cuh:102-160)."""
    if prob.pd_partner is None:
        return routes, False
    pickups = [o for o in range(prob.n_serve)
               if prob.pd_partner[o] >= 0 and prob.pd_sign[o] > 0]
    if not pickups:
        return routes, False
    from cuopt_torch.routing.ges import feasible_insertions

    improved_any = False
    for _ in range(max_rounds):
        improved = False
        for p in pickups:
            if timer.expired():
                return routes, improved_any
            d = int(prob.pd_partner[p])
            va = next((v for v, r in routes.items() if p in r), None)
            if va is None:
                continue
            r_old = routes[va]
            r_rm = [o for o in r_old if o not in (p, d)]
            gain = prob.route_cost(va, r_old) - (
                prob.route_cost(va, r_rm) if r_rm else 0.0
            )
            trial = dict(routes)
            trial[va] = r_rm
            cands = feasible_insertions(prob, trial, p)
            if not cands:
                continue
            delta, vb, cand = min(cands, key=lambda t: t[0])
            if delta - gain < -1e-7:
                trial[vb] = cand
                if prob.precedence:
                    from cuopt_torch.routing.internal import (
                        precedence_ok,
                    )

                    if not precedence_ok(prob, trial):
                        continue
                routes = trial
                improved = improved_any = True
        if not improved:
            break
    return routes, improved_any


def _enforce_precedence(prob, routes, unassigned, rng, max_rounds=10):
    """Repair cross-route precedence violations: pull each violating
    order (and its PD partner) out, greedily reinsert (typically at a
    later position/route), re-check; orders that cannot be scheduled
    after their predecessors end up unassigned (reference
    data_model_view.hpp:359-368)."""
    from cuopt_torch.routing.construction import greedy_reinsert
    from cuopt_torch.routing.internal import (
        order_arrival_times,
        precedence_ok,
    )

    if not prob.precedence:
        return routes, unassigned

    def pull_violators(routes):
        arr = order_arrival_times(prob, routes)
        violators = []
        for o, preds in prob.precedence:
            if arr[o] == -math.inf:
                continue
            for p in preds:
                if arr[int(p)] == -math.inf or \
                        arr[int(p)] > arr[o] + 1e-9:
                    violators.append(o)
                    break
        pulled = set(violators)
        if prob.pd_partner is not None:
            for o in violators:
                pr = int(prob.pd_partner[o])
                if pr >= 0:
                    pulled.add(pr)
        return {v: [o for o in r if o not in pulled]
                for v, r in routes.items()}, pulled

    unassigned = list(unassigned)
    for round_no in range(max_rounds):
        if precedence_ok(prob, routes):
            return routes, unassigned
        routes, pulled = pull_violators(routes)
        if not pulled:
            return routes, unassigned
        if round_no < max_rounds - 1:
            routes, left = greedy_reinsert(
                prob, routes, sorted(pulled), rng
            )
            # deterministic fallback for anything greedy insertion could
            # not place: append at the end of the route holding the
            # latest predecessor (arrivals only grow along a route), then
            # any other route end
            left = _append_after_predecessors(prob, routes, left)
            unassigned.extend(left)
        else:
            unassigned.extend(sorted(pulled))
    # the last round pulls without reinserting, and a pulled order's
    # served successors lose their predecessor: pull them as well until
    # every link holds (cuopt_tpu returns them served)
    while not precedence_ok(prob, routes):
        routes, pulled = pull_violators(routes)
        unassigned.extend(sorted(pulled))
    return routes, sorted(set(unassigned))


def _reinsert_successors(prob, routes, unassigned, timer):
    """Serve the unserved orders that precedence left out once their
    predecessors are served: greedy_reinsert without noise puts each at
    its cheapest position that route_feasible and insert_precedence_ok
    allow, in precedence-depth order, a pickup with its delivery, an order
    with an unserved predecessor left out, a prize order only below its
    prize. The local search and GES only move served orders, and
    construction places a successor before they run, so without this an
    order that had no slot then stays out after a slot opens (cuopt_tpu
    leaves it out). The scans are kept on the problem across calls
    (greedy_reinsert's memo), and the step stops when `timer` expires.
    Returns (routes, unassigned), the routes a new dict."""
    from cuopt_torch.routing.construction import greedy_reinsert

    if not prob.precedence or not unassigned:
        return routes, unassigned
    memo = getattr(prob, "_reinsert_memo", None)
    if memo is None:
        memo = prob._reinsert_memo = {}
    routes, _ = greedy_reinsert(
        prob, {v: list(r) for v, r in routes.items()},
        [int(o) for o in unassigned], noise=0.0, timer=timer,
        prize_bound=True, memo=memo)
    served = {o for r in routes.values() for o in r}
    return routes, [int(o) for o in unassigned if int(o) not in served]


def _append_after_predecessors(prob, routes, left):
    from cuopt_torch.routing.internal import (
        insert_precedence_ok,
        order_arrival_times,
    )

    still = []
    for o in left:
        if prob.pd_partner is not None and int(prob.pd_partner[o]) >= 0:
            still.append(o)  # PD pairs: leave to greedy machinery
            continue
        arr = order_arrival_times(prob, routes)
        preds = next(
            (ps for oo, ps in prob.precedence if int(oo) == int(o)), ()
        )
        pred_routes = [
            v for v, r in routes.items()
            if any(int(p) in r for p in preds)
        ]
        placed = False
        for v in pred_routes + [
            v for v in routes if v not in pred_routes
        ]:
            if prob.allowed_vehicles is not None and not (
                prob.allowed_vehicles[o, v]
            ):
                continue
            cand = routes[v] + [int(o)]
            if prob.route_feasible(v, cand) and \
                    insert_precedence_ok(prob, arr, v, cand):
                routes[v] = cand
                placed = True
                break
        if not placed:
            still.append(o)
    return still


def Solve(data_model, solver_settings: SolverSettings | None = None,
          device="cuda"):
    """Solve the routing problem. Device work (move, insertion and cycle
    scoring) runs on `device`: "cuda" unless the caller passes "cpu";
    without a card a "cuda" solve raises."""
    settings = solver_settings or SolverSettings()
    log = get_logger()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a routing solve on 'cuda' needs a CUDA card; pass "
            "device='cpu' to solve on the CPU")
    try:
        data_model.validate()
        prob = build_problem(data_model)
    except ValidationError as exc:
        return Assignment(
            0, 0.0, {}, RouteTable(),
            status=SolutionStatus.FAIL.value,
            message=str(exc), error_status=1, error_message=str(exc),
        )
    tl = settings.time_limit if settings.time_limit is not None else \
        default_time_limit(prob.n_serve, prob.n_fleet)
    timer = Timer(tl)
    rng = np.random.default_rng(settings.seed)

    if prob.n_serve == 0:
        return Assignment(
            0, 0.0, {}, RouteTable(),
            status=SolutionStatus.EMPTY.value, message="no orders to serve",
        )

    from cuopt_torch.routing.local_search import build_ls_problem

    lsp = build_ls_problem(prob, device=device)
    prob._lsp_cache = lsp  # shared by GES / reinsertion device scoring
    routes = None
    unassigned: list[int] = []
    if data_model.initial_solutions:
        routes, unassigned = _seed_from_initial(
            prob, data_model.initial_solutions[0], rng
        )
    if routes is None:
        from cuopt_torch.routing.construction import (
            _batched_ok,
            batched_construction,
        )

        if _batched_ok(prob, prob.n_serve):
            prob._lsp_cache = lsp
            routes, unassigned = batched_construction(prob, lsp)
        else:
            routes, unassigned = cheapest_insertion(prob)
    routes, unassigned = _enforce_precedence(prob, routes, unassigned,
                                             rng)
    routes = _local_search(prob, lsp, routes, timer,
                           unserved=unassigned)
    routes, unassigned = _reinsert_successors(prob, routes, unassigned,
                                              timer)

    from cuopt_torch.routing.diversity import (
        RoutingPopulation,
        ox_single_route,
        prize_filter,
        ruin_recreate,
        srex,
    )
    from cuopt_torch.routing.ges import minimize_routes

    # GES route minimization runs unconditionally as the route-count-first
    # phase (reference ges_solver.cu:51 compute_ges_solution); the
    # population keeps the pre-GES solution too, so a cost-focused
    # objective can still win with more routes.
    pre_ges = {v: list(r) for v, r in routes.items()}
    routes = minimize_routes(
        prob, routes, timer, rng,
        budget_s=0.25 * max(timer.remaining(), 0.0),
        target=data_model.min_vehicles or 0,
    )
    routes, unassigned = _enforce_precedence(prob, routes, unassigned,
                                             rng)
    routes = _local_search(prob, lsp, routes, timer,
                           unserved=unassigned)
    routes, unassigned = _reinsert_successors(prob, routes, unassigned,
                                              timer)

    if prob.prizes is not None:
        routes, unassigned = prize_filter(prob, routes, unassigned)

    pop = RoutingPopulation(n_islands=2 if prob.n_serve >= 50 else 1)
    pop.add(prob, pre_ges, unassigned)
    pop.add(prob, routes, unassigned)

    # evolutionary diversity loop: recombine / mutate, polish with the
    # device local search, manage the population (reference
    # diversity/diverse_solver.hpp:151 main loop)
    from cuopt_torch.routing.eax import eax, eax_applicable

    eax_ok = eax_applicable(prob)
    # intermediate best-result dumps (reference solver_settings.hpp:97
    # dump_best_results(interval, file)): write the incumbent's routes
    # every `interval` seconds while the diversity loop runs
    import time as _time

    dump_path = settings.best_results_file_path
    dump_interval = settings.best_results_interval or 0.0
    last_dump = _time.monotonic()
    if dump_path:
        _dump_best(prob, pop.best, dump_path)
    while not timer.expired() and prob.n_serve > 1:
        pa, pb = pop.parents(rng)
        op = rng.random()
        child = None
        if eax_ok and op < 0.30 and pa is not pb:
            # EAX: the reference's strongest recombiner
            # (crossovers/eax_recombiner.hpp)
            child = eax(prob, pa, pb, rng)
        if child is None and op < 0.40 and pa is not pb and \
                len(pop.members) >= 3:
            # set-covering over several members' route pools
            from cuopt_torch.routing.diversity import set_covering_child

            sample = [pop.members[int(i)] for i in rng.choice(
                len(pop.members), size=min(4, len(pop.members)),
                replace=False,
            )]
            child = set_covering_child(prob, sample, rng)
        if child is None and op < 0.50 and pa is not pb:
            child = srex(prob, pa, pb, rng)
        elif child is None and op < 0.60:
            ox = ox_single_route(prob, pa, pb, rng)
            if ox is not None:
                child = ox
        if child is None:
            child = ruin_recreate(prob, pa, rng)
        routes, un2 = child
        routes, un2 = _enforce_precedence(prob, routes, un2, rng)
        routes = _local_search(prob, lsp, routes, timer, unserved=un2)
        routes, un2 = _reinsert_successors(prob, routes, un2, timer)
        if prob.prizes is not None:
            routes, un2 = prize_filter(prob, routes, un2)
        pop.add(prob, routes, un2)
        if rng.random() < 0.05:
            pop.migrate(prob)  # ring migration between islands
        if dump_path and dump_interval and \
                _time.monotonic() - last_dump >= dump_interval:
            _dump_best(prob, pop.best, dump_path)
            last_dump = _time.monotonic()

    best = pop.best
    if dump_path:
        _dump_best(prob, best, dump_path)
    # every member went through the step when it was made, unless the
    # timer cut it short: a last pass, with a twentieth of the limit
    best_routes, best_unassigned = _reinsert_successors(
        prob, best["routes"], best["unassigned"], Timer(0.05 * tl))

    if data_model.min_vehicles:
        best_routes = _enforce_min_vehicles(
            prob, best_routes, data_model.min_vehicles
        )

    return _build_assignment(
        prob, best_routes, best_unassigned, timer, data_model
    )


def _seed_from_initial(prob, initial, rng):
    """Build a starting solution from DataModel.add_initial_solutions
    (reference data_model_view.hpp:109; format mirrors the Python wrapper
    vehicle_routing.py add_initial_solutions: per-segment vehicle ids,
    flat node list, node types, segment offsets). Unknown / infeasible
    leftovers are reinserted greedily."""
    from cuopt_torch.routing.construction import greedy_reinsert

    vehicle_ids, nodes, types, offsets = initial
    vehicle_ids = [int(v) for v in np.asarray(vehicle_ids).ravel()]
    nodes = [int(x) for x in np.asarray(nodes).ravel()]
    types = [str(t) for t in types]
    offsets = [int(x) for x in np.asarray(offsets).ravel()]
    orig_to_serve = {int(o): i for i, o in enumerate(prob.serve_orders)}
    routes = {v: [] for v in range(prob.n_fleet)}
    placed = set()
    for k, v in enumerate(vehicle_ids):
        if v < 0 or v >= prob.n_fleet or k + 1 >= len(offsets):
            continue
        seg = range(offsets[k], min(offsets[k + 1], len(nodes)))
        r = []
        for idx in seg:
            t = types[idx].lower() if idx < len(types) else "delivery"
            if t in ("depot", "break"):
                continue
            o = orig_to_serve.get(nodes[idx])
            if o is not None and o not in placed:
                r.append(o)
                placed.add(o)
        routes[v] = r
    # drop infeasible seeds back into the pool
    leftovers = [o for o in range(prob.n_serve) if o not in placed]
    for v in range(prob.n_fleet):
        if routes[v] and not prob.route_feasible(v, routes[v]):
            leftovers.extend(routes[v])
            routes[v] = []
    routes, unassigned = greedy_reinsert(prob, routes, leftovers, rng)
    return routes, unassigned


def _enforce_min_vehicles(prob, routes, min_vehicles):
    """Split routes until at least min_vehicles are used (reference
    set_min_vehicles, data_model_view.hpp; the reference treats it as a
    hard fleet-size floor)."""
    routes = {v: list(r) for v, r in routes.items()}
    used = [v for v, r in routes.items() if r]
    empty = [v for v, r in routes.items() if not r]
    target = min(min_vehicles, prob.n_fleet)
    while len(used) < target and empty:
        # split the longest route's tail onto an empty vehicle
        donor = max(used, key=lambda v: len(routes[v]), default=None)
        if donor is None or len(routes[donor]) < 2:
            break
        moved = False
        for recv in list(empty):
            tail = routes[donor][len(routes[donor]) // 2:]
            head = routes[donor][: len(routes[donor]) // 2]
            # keep PD pairs together: pull partners into the tail
            if prob.pd_partner is not None:
                tail_set = set(tail)
                for o in list(tail):
                    pr = int(prob.pd_partner[o])
                    if pr >= 0 and pr not in tail_set:
                        head = [x for x in head if x != pr]
                        tail = [pr] + tail
                        tail_set.add(pr)
            if prob.route_feasible(recv, tail) and \
                    prob.route_feasible(donor, head):
                routes[donor] = head
                routes[recv] = tail
                used.append(recv)
                empty.remove(recv)
                moved = True
                break
        if not moved:
            break
    return routes


def _build_assignment(prob, routes, unassigned, timer, dm):
    rows = []
    used = 0
    total_cost = 0.0
    total_time = 0.0
    raw_cost = 0.0
    raw_fixed_total = 0.0
    route_sizes = []
    route_service = []
    for v in range(prob.n_fleet):
        r = routes.get(v, [])
        if not r:
            continue
        used += 1
        plan = prob.route_plan(v, r)
        cost = plan["cost"]
        arr = plan["arrivals"]
        total_cost += cost
        route_sizes.append(len(r))
        route_service.append(float(np.sum(prob.service[r])))
        # raw (unweighted) cost over the actual visit sequence,
        # reference Objective.COST semantics
        ti = prob.type_index[int(prob.veh_type[v])]
        seq = []
        if not prob.skip_first[v]:
            seq.append(int(prob.veh_start[v]))
        ev = sorted(
            [(float(a), int(prob.order_loc[o])) for o, a in zip(r, arr)]
            + [(float(b["start"]), int(b["location"]))
               for b in plan["breaks"]]
        )
        seq.extend(loc for _, loc in ev)
        if not prob.drop_return[v]:
            seq.append(int(prob.veh_return[v]))
        raw_cost += float(sum(
            prob.raw_cost_mats[ti, a, b] for a, b in zip(seq, seq[1:])
        ))
        raw_fixed_total += float(prob.raw_fixed_cost[v])
        start_time = prob.veh_tw_early[v]
        if not prob.skip_first[v]:
            rows.append((
                0, float(start_time), v, int(prob.veh_start[v]), "Depot",
            ))
        order_rows = [
            (int(prob.serve_orders[o]), float(a), v,
             int(prob.order_loc[o]), "Delivery"
             if prob.pd_sign is None or prob.pd_sign[o] <= 0 else "Pickup")
            for o, a in zip(r, arr)
        ]
        break_rows = [
            (0, b["start"], v, b["location"], "Break")
            for b in plan["breaks"]
        ]
        rows.extend(sorted(
            order_rows + break_rows, key=lambda t: t[1]
        ))
        end = plan["end_time"]
        if not prob.drop_return[v]:
            rows.append((
                0, float(end), v, int(prob.veh_return[v]), "Depot",
            ))
        total_time += float(end - start_time)
    table = RouteTable(rows)
    if unassigned and prob.prizes is None:
        status = SolutionStatus.FAIL.value
        message = f"{len(unassigned)} orders could not be served"
    elif not rows:
        status = SolutionStatus.EMPTY.value
        message = "empty solution"
    else:
        status = SolutionStatus.SUCCESS.value
        message = ""
    # per-objective values in RAW units (reference assignment objective
    # breakdown; the optimized scalar is the weight-blended sum)
    weights = prob.objective_weights or {Objective.COST: 1.0}
    objective_values = {Objective.COST: float(raw_cost)}
    if Objective.TRAVEL_TIME in weights:
        objective_values[Objective.TRAVEL_TIME] = float(total_time)
    if Objective.VEHICLE_FIXED_COST in weights or raw_fixed_total:
        objective_values[Objective.VEHICLE_FIXED_COST] = \
            float(raw_fixed_total)
    if Objective.VARIANCE_ROUTE_SIZE in weights and route_sizes:
        mean = np.mean(route_sizes)
        objective_values[Objective.VARIANCE_ROUTE_SIZE] = float(
            np.sum((np.asarray(route_sizes) - mean) ** 2)
        )
    if Objective.VARIANCE_ROUTE_SERVICE_TIME in weights and route_service:
        mean = np.mean(route_service)
        objective_values[Objective.VARIANCE_ROUTE_SERVICE_TIME] = float(
            np.sum((np.asarray(route_service) - mean) ** 2)
        )
    if prob.prizes is not None and unassigned:
        # report in RAW prize units (prob.prizes carries the search
        # weighting; dm holds the user values)
        raw_prizes = dm.order_prizes if dm.order_prizes is not None \
            else prob.prizes
        objective_values[Objective.PRIZE] = float(-np.sum(
            raw_prizes[prob.serve_orders[list(unassigned)]]
        ))
    eff_weights = dict(weights)
    # fixed costs ride with COST unless explicitly weighted (matches
    # build_problem's blending)
    eff_weights.setdefault(
        Objective.VEHICLE_FIXED_COST,
        1.0 if Objective.COST in weights else 0.0,
    )
    eff_weights.setdefault(
        Objective.PRIZE, 1.0 if Objective.COST in weights else 0.0,
    )
    total_objective = float(sum(
        w * objective_values.get(o, 0.0)
        for o, w in eff_weights.items()
    ))
    return Assignment(
        used, total_objective, objective_values, table,
        status=status, message=message,
        undeliverable_orders=[
            int(prob.serve_orders[o]) for o in unassigned
        ],
    )


def _dump_best(prob, best, path):
    """Write the current best solution as JSON (routes in original order
    ids) — the reference dumps intermediate best assignments to the
    configured file on an interval (solver_settings.hpp:97)."""
    import json

    try:
        routes = {
            int(v): [int(prob.serve_orders[o]) for o in r]
            for v, r in best["routes"].items() if r
        }
        payload = {
            "cost": float(prob.solution_cost(best["routes"])),
            "num_vehicles": len(routes),
            "routes": routes,
            "unassigned": [
                int(prob.serve_orders[o]) for o in best["unassigned"]
            ],
        }
        with open(path, "w") as fh:
            json.dump(payload, fh)
    except Exception:  # noqa: BLE001 — dumps must never kill the solve
        pass
