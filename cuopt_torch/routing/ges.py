"""Guided Ejection Search: route-count minimization.

Counterpart of the reference GES route minimization
(cpp/src/routing/ges/guided_ejection_search.cuh:81 — ejection pool +
lexicographic k-ejection search with squeeze and perturbation, after
Nagata & Bräysy). The control flow is inherently sequential (one ejection
pool, penalty counters), so it runs on host like the reference's CPU
driver, with vectorized feasibility checks through the exact route model
(internal.py route_feasible covers time windows, capacities, breaks,
max cost/time, vehicle-order match, pickup-delivery precedence).

Algorithm (reference config: k_max <= 6, here k_max = 4 with pair
ejections):
  1. pick the route with the fewest orders, move its orders into the
     ejection pool (EP)
  2. while EP is non-empty and within budget:
       - pop an order; try a feasible insertion anywhere -> done
       - else find the insertion whose required ejection set has minimal
         penalty sum p[] (k = 1 or 2 consecutive); eject those into EP,
         bump p[order]
       - else perturb the partial solution with random feasible
         relocations (squeeze analogue)
  3. success (EP empty) -> one fewer route; else restore and stop.
"""

from __future__ import annotations

import numpy as np


def _pair_unit(prob, o):
    """(pickup, delivery) tuple for PD orders, else (o,)."""
    if prob.pd_partner is not None and prob.pd_partner[o] >= 0:
        if prob.pd_sign[o] > 0:
            return (o, int(prob.pd_partner[o]))
        return (int(prob.pd_partner[o]), o)
    return (o,)


def _device_insertion_prefilter(prob, routes, o, exclude, top_k=16):
    """Device-scored insertion candidates for one order: one device call
    ranks ALL (route, slot) positions (local_search.evaluate_insertions —
    cuopt_tpu's analogue of the reference's GPU insertion-scoring kernels,
    guided_ejection_search.cuh:81); the host exact-verifies only the
    top-k. Returns a list of (delta, v, new_route) or None when the
    device path does not apply."""
    if prob.pd_partner is not None and prob.pd_partner[o] >= 0:
        return None
    if prob.precedence or prob.breaks:
        return None
    if np.any(prob.skip_first) or np.any(prob.drop_return):
        # terminal-arc pricing flags are not in the device evaluator;
        # those instances need the exact host scan. (Per-vehicle max
        # cost/time ARE scored in the move tensors now — the host
        # exact-verifies the top-k either way.)
        return None
    lsp = getattr(prob, "_lsp_cache", None)
    if lsp is None or prob.n_serve * prob.n_fleet < 2000:
        return None
    from cuopt_torch.routing.local_search import (
        BIG,
        evaluate_insertions,
        to_host,
    )

    longest = max((len(r) for r in routes.values()), default=1)
    L_pad = max(8, ((longest + 4 + 7) // 8) * 8)
    F = prob.n_fleet
    R = np.full((F, L_pad), -1, np.int32)
    lens = np.zeros(F, np.int32)
    for v, r in routes.items():
        R[v, : len(r)] = r
        lens[v] = len(r)
    scores = to_host(evaluate_insertions(
        lsp, R, lens, np.asarray([o], np.int64),
    ))[0]  # (F, L+1)
    for v in exclude:
        scores[v, :] = BIG
    flat = scores.reshape(-1)
    order = np.argsort(flat)[:top_k]
    out = []
    for k in order:
        if flat[k] >= BIG / 2:
            break
        v, j = divmod(int(k), scores.shape[1])
        cand = routes[v][:j] + [int(o)] + routes[v][j:]
        if prob.route_feasible(v, cand):
            out.append((float(flat[k]), v, cand))
    return out


def feasible_insertions(prob, routes, o, exclude=(), max_cands=64):
    """All feasible (delta_cost, vehicle, new_route) insertions of order o
    (with its PD partner when paired). Bounded by max_cands per call.
    Large unconstrained instances use a device-scored prefilter."""
    pre = _device_insertion_prefilter(prob, routes, o, exclude)
    if pre is not None and pre:
        return pre[:max_cands]
    if pre is not None and not pre:
        return []
    unit = _pair_unit(prob, o)
    out = []
    for v in range(prob.n_fleet):
        if v in exclude:
            continue
        if prob.allowed_vehicles is not None and not all(
            prob.allowed_vehicles[u, v] for u in unit
        ):
            continue
        r = routes[v]
        if any(u in r for u in unit):
            continue
        base = prob.route_cost(v, r) if r else 0.0
        for i in range(len(r) + 1):
            cand = r[:i] + [unit[0]] + r[i:]
            if len(unit) == 2:
                for j in range(i + 1, len(cand) + 1):
                    cand2 = cand[:j] + [unit[1]] + cand[j:]
                    if prob.route_feasible(v, cand2):
                        out.append(
                            (prob.route_cost(v, cand2) - base, v, cand2)
                        )
                        if len(out) >= max_cands:
                            return out
            else:
                if prob.route_feasible(v, cand):
                    out.append((prob.route_cost(v, cand) - base, v, cand))
                    if len(out) >= max_cands:
                        return out
    return out


def _try_insert_after_eject(prob, v, r, eject_pos, unit, p_sum, best,
                            penalties):
    """Remove the positions in `eject_pos` from route r, try inserting
    `unit`; returns an improved best tuple or the old one."""
    keep = [w for i, w in enumerate(r) if i not in eject_pos]
    ejected = [r[i] for i in sorted(eject_pos)]
    for i in range(len(keep) + 1):
        cand = keep[:i] + [unit[0]] + keep[i:]
        if len(unit) == 2:
            for j in range(i + 1, len(cand) + 1):
                cand2 = cand[:j] + [unit[1]] + cand[j:]
                if prob.route_feasible(v, cand2):
                    return (p_sum, v, cand2, ejected)
        else:
            if prob.route_feasible(v, cand):
                return (p_sum, v, cand, ejected)
    return best


def _ejection_insertions(prob, routes, o, penalties, exclude=(),
                         k_max=4, nc_k_max=3, nc_pool=10):
    """Insertions of o that require ejecting orders, scored by ejected
    penalty sum (lexicographic ejection search, reference
    ges/lexicographic_search/ explores NON-consecutive subsets to
    k <= 6). Two phases per route:
      1. consecutive windows of 1..k_max orders (cheap scan);
      2. lexicographic NON-consecutive subsets (size 2..nc_k_max) of
         the `nc_pool` cheapest-penalty positions, pruned by the
         running best penalty sum — the route-minimization workhorse
         the consecutive-only r04 search was missing (VERDICT #7).
    Returns the best (p_sum, v, new_route, ejected) or None."""
    from itertools import combinations

    unit = _pair_unit(prob, o)
    best = None
    for v in range(prob.n_fleet):
        if v in exclude:
            continue
        if prob.allowed_vehicles is not None and not all(
            prob.allowed_vehicles[u, v] for u in unit
        ):
            continue
        r = routes[v]
        if not r or any(u in r for u in unit):
            continue
        n = len(r)

        def pd_closed(ej_set):
            # PD orders must be ejected with their partner
            for w in ej_set:
                for u in _pair_unit(prob, w):
                    if u in r and u not in ej_set:
                        return False
            return True

        for e0 in range(n):
            for k in range(1, min(k_max, n - e0) + 1):
                ejected = r[e0:e0 + k]
                if not pd_closed(set(ejected)):
                    continue
                p_sum = sum(penalties[w] for w in ejected)
                if best is not None and p_sum >= best[0]:
                    continue
                cand = _try_insert_after_eject(
                    prob, v, r, set(range(e0, e0 + k)), unit, p_sum,
                    best, penalties,
                )
                if cand is not best:
                    best = cand
        # non-consecutive subsets over the cheapest-penalty positions
        if nc_k_max >= 2 and n >= 3:
            order_by_p = sorted(
                range(n), key=lambda i: penalties[r[i]]
            )[:nc_pool]
            for k in range(2, min(nc_k_max, len(order_by_p)) + 1):
                for subset in combinations(order_by_p, k):
                    pos = set(subset)
                    # consecutive subsets were covered in phase 1
                    lo, hi = min(pos), max(pos)
                    if hi - lo + 1 == k:
                        continue
                    p_sum = sum(penalties[r[i]] for i in pos)
                    if best is not None and p_sum >= best[0]:
                        continue
                    if not pd_closed({r[i] for i in pos}):
                        continue
                    cand = _try_insert_after_eject(
                        prob, v, r, pos, unit, p_sum, best, penalties,
                    )
                    if cand is not best:
                        best = cand
    return best


def _perturb(prob, routes, rng, n_moves=8, exclude=()):
    """Random feasible relocations (squeeze/perturbation analogue,
    reference ges/squeeze.cu + random perturbation)."""
    vehicles = [v for v in routes if v not in exclude and routes[v]]
    for _ in range(n_moves):
        if not vehicles:
            return
        v1 = int(rng.choice(vehicles))
        if not routes[v1]:
            continue
        o = routes[v1][int(rng.integers(len(routes[v1])))]
        unit = _pair_unit(prob, o)
        trial = {v: list(r) for v, r in routes.items()}
        trial[v1] = [x for x in trial[v1] if x not in unit]
        cands = feasible_insertions(prob, trial, unit[0],
                                    exclude=tuple(exclude) + (v1,),
                                    max_cands=8)
        if cands:
            _, v2, new_r = cands[int(rng.integers(len(cands)))]
            routes[v1] = trial[v1]
            routes[v2] = new_r


def minimize_routes(prob, routes, timer, rng, budget_s=None,
                    max_steps_per_route=200, target=0):
    """Iteratively try to empty the smallest route via ejection search.

    Returns the (possibly) improved routes dict. Never leaves orders
    unserved: on failure the eliminated route is restored.
    """
    routes = {v: list(r) for v, r in routes.items()}
    deadline = None
    if budget_s is not None:
        deadline = timer.elapsed() + budget_s

    def out_of_time():
        if timer.expired():
            return True
        return deadline is not None and timer.elapsed() > deadline

    while not out_of_time():
        nonempty = [v for v, r in routes.items() if r]
        if len(nonempty) <= max(1, target):
            break
        victim = min(nonempty, key=lambda v: len(routes[v]))
        saved = {v: list(r) for v, r in routes.items()}
        pool = list(routes[victim])
        routes[victim] = []
        penalties = np.ones(prob.n_serve)
        steps = 0
        success = True
        while pool:
            if out_of_time() or steps > max_steps_per_route:
                success = False
                break
            steps += 1
            o = pool.pop()
            unit = _pair_unit(prob, o)
            if len(unit) == 2 and unit[0] != o:
                # always handle the pickup; skip if partner also pooled
                if unit[0] in pool:
                    pool.remove(unit[0])
                o = unit[0]
            cands = feasible_insertions(prob, routes, o,
                                        exclude=(victim,))
            if cands:
                cands.sort(key=lambda t: t[0])
                pick = cands[int(rng.integers(min(3, len(cands))))]
                routes[pick[1]] = pick[2]
                continue
            penalties[o] += 1.0
            ej = _ejection_insertions(prob, routes, o, penalties,
                                      exclude=(victim,))
            if ej is not None:
                _, v, new_r, ejected = ej
                routes[v] = new_r
                for w in ejected:
                    wu = _pair_unit(prob, w)
                    if wu[0] not in pool:
                        pool.append(wu[0])
                _perturb(prob, routes, rng, n_moves=4, exclude=(victim,))
            else:
                # no ejection insertion either: put back and perturb
                pool.append(o)
                _perturb(prob, routes, rng, n_moves=8, exclude=(victim,))
                if steps > max_steps_per_route // 2 and len(pool) > 1:
                    success = False
                    break
        if not success or pool:
            return saved
        # the attempt must NET a route: perturbation may have opened an
        # empty vehicle while reinserting (seen as 9 -> 10 "minimized"
        # counts); keep the elimination only when the count went down
        if sum(1 for r in routes.values() if r) >= \
                sum(1 for r in saved.values() if r):
            routes = saved
            break
    return routes
