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


_SCAN_MEMO_MAX = 20_000  # scans a memo keeps before it starts over


def _precedence_links(prob):
    """{order: the orders it shares a precedence link with}."""
    links: dict[int, set[int]] = {}
    for o, preds in prob.precedence:
        for p in preds:
            links.setdefault(int(o), set()).add(int(p))
            links.setdefault(int(p), set()).add(int(o))
    return links


def _feasible_positions(prob, v, r, unit, arr, links, memo):
    """Every position of `unit` (an order, or a pickup and its delivery)
    in route r of vehicle v that route_feasible and, with precedence,
    insert_precedence_ok allow, in scan order: (cost change, i, j), the
    unit's first order at i and its delivery at j of the route with the
    first inserted (j None for a single order). The scan reads the route
    and, through the precedence check, the arrivals of the orders linked
    to it on other routes: `memo` keeps it under exactly those."""
    key = None
    if memo is not None:
        ext = ()
        if arr is not None:
            inside = set(r) | set(unit)
            ext = tuple((x, arr[x]) for x in sorted(
                {x for y in inside for x in links.get(y, ())} - inside))
        key = (unit, v, tuple(r), ext)
        if key in memo:
            return memo[key]
    out = []
    base = prob.route_cost(v, r) if r else 0.0
    for i in range(len(r) + 1):
        cand = r[:i] + [unit[0]] + r[i:]
        for j in ([None] if len(unit) == 1 else
                  range(i + 1, len(cand) + 1)):
            c = cand if j is None else cand[:j] + [unit[1]] + cand[j:]
            if prob.route_feasible(v, c) and (
                arr is None or insert_precedence_ok(prob, arr, v, c)
            ):
                out.append((prob.route_cost(v, c) - base, i, j))
    if key is not None:
        if len(memo) >= _SCAN_MEMO_MAX:
            memo.clear()
        memo[key] = out
    return out


def greedy_reinsert(prob, routes, removed, rng=None, noise=0.1, timer=None,
                    prize_bound=False, memo=None):
    """Reinsert removed orders (the ruin & recreate step, and the search's
    repair of the orders precedence left out), each at its cheapest
    feasible position, a pickup with its delivery. With precedence
    constraints, orders go in precedence-depth order; insertion positions
    are filtered so the resulting arrival times respect every affected
    pair (precedence by construction, not post-hoc repair), and an order
    whose predecessor is not served stays out (insert_precedence_ok
    passes over an unserved predecessor, which precedence_ok rejects).
    prize_bound: a prize order goes in only below its prize. timer: the
    orders left when it expires stay out. memo: a dict kept across calls
    on one problem, so that an order is scanned again only where its
    route or the arrivals its check reads changed. Returns (routes,
    orders left out)."""
    rng = rng or np.random.default_rng(0)
    unassigned = []
    prec = bool(prob.precedence)
    links = preds = served = None
    if prec:
        depth = precedence_depth(prob)
        removed = sorted(removed, key=lambda o: (depth[int(o)], int(o)))
        links = _precedence_links(prob)
        preds = {int(o): [int(p) for p in ps] for o, ps in prob.precedence}
        served = {o for r in routes.values() for o in r}
    for o in removed:
        partner = -1
        if prob.pd_partner is not None and prob.pd_partner[o] >= 0 and \
                prob.pd_sign[o] > 0:
            partner = int(prob.pd_partner[o])
        elif prob.pd_partner is not None and prob.pd_sign[o] < 0:
            continue  # inserted with its pickup
        unit = (o,) if partner < 0 else (o, partner)
        if (timer is not None and timer.expired()) or (prec and any(
                p not in served and p not in unit
                for u in unit for p in preds.get(u, ()))):
            unassigned.extend(unit)
            continue
        arr = order_arrival_times(prob, routes) if prec else None
        best = None
        for v in range(prob.n_fleet):
            if prob.allowed_vehicles is not None and not (
                prob.allowed_vehicles[o, v]
            ):
                continue
            r = routes.get(v, [])
            for delta, i, j in _feasible_positions(prob, v, r, unit, arr,
                                                   links, memo):
                delta *= 1.0 + noise * rng.uniform(-1, 1)
                if best is None or delta < best[0]:
                    best = (delta, v, i, j)
        if best is not None and prize_bound and prob.prizes is not None \
                and best[0] >= sum(prob.prizes[u] for u in unit) - 1e-9:
            best = None
        if best is None:
            unassigned.extend(unit)
        else:
            _, v, i, j = best
            r = list(routes.get(v, []))
            r.insert(i, o)
            if j is not None:
                r.insert(j, partner)
            routes[v] = r
            if prec:
                served.update(unit)
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
