"""Initial solution construction: cheapest feasible insertion.

Plays the role of the reference GES route construction seed
(cpp/src/routing/ges/guided_ejection_search.cuh builds from an ejection
pool); here a deterministic cheapest-insertion pass (optionally randomized
for restarts) produces the starting solution for the local search.
"""

from __future__ import annotations

import numpy as np

from cuopt_torch.routing.internal import (
    RoutingProblem,
    insert_precedence_ok,
    order_arrival_times,
    precedence_depth,
)


def cheapest_insertion(
    prob: RoutingProblem, rng: np.random.Generator | None = None,
    noise: float = 0.0,
) -> tuple[dict[int, list[int]], list[int]]:
    """Insert orders one by one at the cheapest feasible position.

    Returns (routes: vehicle -> [serve-order idx]), unassigned orders.
    Pickup-delivery pairs are inserted as (pickup, delivery) units.
    """
    rng = rng or np.random.default_rng(0)
    routes: dict[int, list[int]] = {v: [] for v in range(prob.n_fleet)}
    # order processing sequence: precedence depth first (predecessors
    # before successors), then the orders with the fewest vehicles
    # allowed, then earliest time window, then demand. cuopt_tpu has no
    # allowed-vehicle key: an order pinned to a vehicle that cheaper
    # orders had filled first stayed unassigned (a re-routed model's
    # dummy pickups). Without pins both take the same sequence.
    n_allowed = np.full(prob.n_serve, prob.n_fleet) \
        if prob.allowed_vehicles is None \
        else prob.allowed_vehicles.sum(axis=1)
    keys = np.lexsort((
        -prob.demand.sum(axis=0), prob.tw_early, n_allowed,
        precedence_depth(prob),
    ))
    pending = [int(o) for o in keys]
    handled = set()
    unassigned: list[int] = []
    prec = bool(prob.precedence)

    for o in pending:
        arr = order_arrival_times(prob, routes) if prec else None
        if o in handled:
            continue
        partner = -1
        if prob.pd_partner is not None and prob.pd_partner[o] >= 0:
            if prob.pd_sign[o] < 0:  # delivery: wait for its pickup
                continue
            partner = int(prob.pd_partner[o])
        best = None
        for v in range(prob.n_fleet):
            r = routes[v]
            if prob.allowed_vehicles is not None and not (
                prob.allowed_vehicles[o, v]
            ):
                continue
            base = prob.route_cost(v, r) if r else 0.0
            for i in range(len(r) + 1):
                cand = r[:i] + [o] + r[i:]
                if partner >= 0:
                    for j in range(i + 1, len(cand) + 1):
                        cand2 = cand[:j] + [partner] + cand[j:]
                        if prob.route_feasible(v, cand2) and (
                            not prec
                            or insert_precedence_ok(prob, arr, v, cand2)
                        ):
                            delta = prob.route_cost(v, cand2) - base
                            if noise:
                                delta *= 1.0 + noise * rng.uniform(-1, 1)
                            if best is None or delta < best[0]:
                                best = (delta, v, cand2)
                else:
                    if prob.route_feasible(v, cand) and (
                        not prec
                        or insert_precedence_ok(prob, arr, v, cand)
                    ):
                        delta = prob.route_cost(v, cand) - base
                        if noise:
                            delta *= 1.0 + noise * rng.uniform(-1, 1)
                        if best is None or delta < best[0]:
                            best = (delta, v, cand)
        if best is None:
            unassigned.append(o)
            if partner >= 0:
                unassigned.append(partner)
                handled.add(partner)
        else:
            routes[best[1]] = best[2]
            handled.add(o)
            if partner >= 0:
                handled.add(partner)
        handled.add(o)
    return routes, unassigned


def greedy_reinsert(prob, routes, removed, rng=None, noise=0.1):
    """Reinsert removed orders (ruin & recreate step). With precedence
    constraints, insertion positions are filtered so the resulting
    arrival times respect every affected pair (precedence by
    construction, not post-hoc repair)."""
    rng = rng or np.random.default_rng(0)
    unassigned = []
    prec = bool(prob.precedence)
    if prec:
        depth = precedence_depth(prob)
        removed = sorted(removed, key=lambda o: (depth[int(o)], int(o)))
    for o in removed:
        arr = order_arrival_times(prob, routes) if prec else None
        partner = -1
        if prob.pd_partner is not None and prob.pd_partner[o] >= 0 and \
                prob.pd_sign[o] > 0:
            partner = int(prob.pd_partner[o])
        elif prob.pd_partner is not None and prob.pd_sign[o] < 0:
            continue  # inserted with its pickup
        best = None
        for v in range(prob.n_fleet):
            if prob.allowed_vehicles is not None and not (
                prob.allowed_vehicles[o, v]
            ):
                continue
            r = routes[v]
            base = prob.route_cost(v, r) if r else 0.0
            for i in range(len(r) + 1):
                cand = r[:i] + [o] + r[i:]
                if partner >= 0:
                    for j in range(i + 1, len(cand) + 1):
                        cand2 = cand[:j] + [partner] + cand[j:]
                        if prob.route_feasible(v, cand2) and (
                            not prec
                            or insert_precedence_ok(prob, arr, v, cand2)
                        ):
                            delta = prob.route_cost(v, cand2) - base
                            delta *= 1.0 + noise * rng.uniform(-1, 1)
                            if best is None or delta < best[0]:
                                best = (delta, v, cand2)
                else:
                    if prob.route_feasible(v, cand) and (
                        not prec
                        or insert_precedence_ok(prob, arr, v, cand)
                    ):
                        delta = prob.route_cost(v, cand) - base
                        delta *= 1.0 + noise * rng.uniform(-1, 1)
                        if best is None or delta < best[0]:
                            best = (delta, v, cand)
        if best is None:
            unassigned.append(o)
            if partner >= 0:
                unassigned.append(partner)
        else:
            routes[best[1]] = best[2]
    return routes, unassigned


def batched_construction(prob, lsp, routes=None, pending=None, rng=None,
                         noise=0.0, exact_check=None):
    """Device-batched parallel cheapest insertion for large instances.

    One device call (local_search.evaluate_insertions) scores ALL
    (pending order, route, slot) triples; the host then applies the best
    insertion per route per round (insertions into distinct routes leave
    each other's score tensors valid), so construction costs
    O(n_serve / n_fleet) device rounds instead of O(n_serve * n_fleet *
    L^2) host loops. This is cuopt_tpu's answer to the reference's
    GPU-kernel insertion scoring (ges/guided_ejection_search.cuh:81).

    Not used when PD pairs or precedence are present (those need the
    paired/ordered host path in cheapest_insertion).
    """
    import numpy as np

    from cuopt_torch.routing.local_search import (
        BIG,
        evaluate_insertions_best,
        to_host,
    )

    rng = rng or np.random.default_rng(0)
    routes = {v: list(r) for v, r in (routes or {}).items()}
    for v in range(prob.n_fleet):
        routes.setdefault(v, [])
    if pending is None:
        pending = list(range(prob.n_serve))
    pending = [int(o) for o in pending]
    if exact_check is None:
        exact_check = bool(prob.breaks) or bool(
            np.any(np.isfinite(prob.veh_max_cost))
            or np.any(np.isfinite(prob.veh_max_time))
            or np.any(prob.skip_first)
            or np.any(prob.drop_return)
        )

    def to_arrays(L_pad):
        R = np.full((prob.n_fleet, L_pad), -1, np.int64)
        lens = np.zeros(prob.n_fleet, np.int64)
        for v, r in routes.items():
            R[v, : len(r)] = r
            lens[v] = len(r)
        return R, lens

    def pad_for(extra):
        longest = max((len(r) for r in routes.values()), default=1)
        return max(8, ((longest + extra + 7) // 8) * 8)

    # fixed candidate bucket and route width, kept from cuopt_tpu (where
    # a fresh shape meant a fresh XLA compile): the same shapes keep the
    # port's moves cuopt_tpu's
    P0 = max(8, 1 << max(0, (len(pending) - 1)).bit_length())
    # presize the route width for the WHOLE construction. Expected final
    # length = orders per vehicle + slack; pad_for still wins if routes
    # are longer.
    exp_len = -(-(len(pending) + sum(len(r) for r in routes.values()))
                // max(prob.n_fleet, 1))
    L_min = max(8, ((exp_len + 8 + 7) // 8) * 8)
    unassigned: list[int] = []
    while pending:
        L_pad = max(pad_for(4), L_min)
        R, lens = to_arrays(L_pad)
        P = len(pending)
        cand = np.zeros(P0, np.int32)
        cand[:P] = pending
        cmask = np.zeros(P0, bool)
        cmask[:P] = True
        packed = to_host(evaluate_insertions_best(
            lsp, R, lens, cand, cmask
        ))
        bd = packed[:P, 0].copy()
        bv = packed[:P, 1].astype(np.int32)
        bs = packed[:P, 2].astype(np.int32)
        if noise:
            bd = bd * (1.0 + noise * rng.uniform(-1, 1, P))
        order = np.argsort(bd, kind="stable")
        used: set[int] = set()
        placed: set[int] = set()
        progress = False
        for pi in order:
            if bd[pi] >= BIG / 2:
                continue
            o = pending[pi]
            # a route already used this round has stale scores; defer
            # the order to the next round
            v, j = int(bv[pi]), int(bs[pi])
            if v in used:
                continue
            cand_r = routes[v][:j] + [o] + routes[v][j:]
            if exact_check and not prob.route_feasible(v, cand_r):
                continue
            routes[v] = cand_r
            used.add(v)
            placed.add(o)
            progress = True
        still: list[int] = []
        for pi, o in enumerate(pending):
            if o in placed:
                continue
            if bd[pi] >= BIG / 2:
                # no feasible slot anywhere; insertions never create
                # feasibility, so the order is undeliverable
                unassigned.append(o)
            else:
                still.append(o)
        pending = still
        if not progress:
            unassigned.extend(pending)
            break
    return routes, unassigned


def _batched_ok(prob, n_removed: int) -> bool:
    if prob.precedence:
        return False
    if prob.pd_partner is not None and (prob.pd_partner >= 0).any():
        return False
    # only worth a device program beyond this work size
    return n_removed * prob.n_fleet >= 2000


def smart_reinsert(prob, routes, removed, rng=None, noise=0.1):
    """greedy_reinsert with a device-batched fast path for large
    unconstrained instances (see batched_construction)."""
    if not _batched_ok(prob, len(removed)):
        return greedy_reinsert(prob, routes, removed, rng, noise)
    lsp = getattr(prob, "_lsp_cache", None)
    if lsp is None:
        from cuopt_torch.routing.local_search import build_ls_problem

        lsp = build_ls_problem(prob)
        prob._lsp_cache = lsp
    return batched_construction(prob, lsp, routes=routes,
                                pending=removed, rng=rng, noise=noise)
