"""Edge Assembly Crossover (EAX) for route populations.

Reference: cpp/src/routing/crossovers/{eax_recombiner.hpp, ab_cycle.hpp,
optimal_eax_cycles.cu} — the reference's strongest VRP recombiner
(Nagata's EAX): take the symmetric difference of the two parents' edge
sets, decompose it into AB-cycles (alternating parent-A / parent-B
edges), flip a selected E-set of cycles inside parent A, then repair the
resulting subtours back into depot routes.

Host implementation (graph surgery is sequential and tiny); the
offspring is polished by the device local search like every other child
(routing/solver.py diversity loop). Gated to homogeneous fleets with a
common depot — the classic EAX setting; heterogeneous cases keep
SREX/OX (reference similarly applies EAX to its adapted homogeneous
solution form, adapters/).
"""

from __future__ import annotations

import numpy as np

DEPOT = -1


def eax_applicable(prob) -> bool:
    if prob.pd_partner is not None and (prob.pd_partner >= 0).any():
        return False
    if prob.precedence:
        return False
    starts = set(int(s) for s in prob.veh_start)
    rets = set(int(r) for r in prob.veh_return)
    types = set(int(t) for t in prob.veh_type)
    if len(starts) > 1 or len(rets) > 1 or len(types) > 1:
        return False
    if prob.allowed_vehicles is not None and not \
            prob.allowed_vehicles.all():
        return False
    return True


def _edges(routes):
    """Undirected edge multiset of a solution: (u, v) with u < v after
    normalization; DEPOT = -1 stands for the shared depot."""
    edges = []
    for r in routes.values():
        if not r:
            continue
        seq = [DEPOT] + list(r) + [DEPOT]
        for a, b in zip(seq[:-1], seq[1:]):
            edges.append((min(a, b), max(a, b)))
    return edges


def _ab_cycles(ea, eb, rng):
    """Decompose the symmetric difference multiset into AB-cycles.

    Standard construction (ab_cycle.hpp role): walk the difference graph
    alternating A-edges and B-edges; every vertex has equal A- and
    B-degree in the difference, so alternating walks close into cycles.
    Returns a list of cycles, each a list of (edge, from_a) tuples of
    even length that starts on an A edge and ends on a B edge back at
    its start vertex (cuopt_tpu closes a walk after an A edge instead, so
    its cycles are odd and both their ends come from A).
    """
    from collections import Counter, defaultdict

    ca, cb = Counter(ea), Counter(eb)
    diff_a = list((ca - cb).elements())
    diff_b = list((cb - ca).elements())
    adj_a = defaultdict(list)
    adj_b = defaultdict(list)
    for i, (u, v) in enumerate(diff_a):
        adj_a[u].append(i)
        adj_a[v].append(i)
    for i, (u, v) in enumerate(diff_b):
        adj_b[u].append(i)
        adj_b[v].append(i)
    used_a = np.zeros(len(diff_a), bool)
    used_b = np.zeros(len(diff_b), bool)
    cycles = []
    for start_i in rng.permutation(max(len(diff_a), 1)):
        if len(diff_a) == 0 or used_a[start_i]:
            continue
        u0, v0 = diff_a[start_i]
        used_a[start_i] = True
        # the open walk: path[k] is the vertex edge walk[k] leaves, and
        # walk[k] comes from A exactly when k is even
        path = [u0, v0]
        walk = [((u0, v0), True)]
        guard = 0
        while walk and guard <= 2 * (len(diff_a) + len(diff_b) + 1):
            guard += 1
            need_b = walk[-1][1]  # an A edge is followed by a B edge
            cur = path[-1]
            pool = adj_b[cur] if need_b else adj_a[cur]
            used = used_b if need_b else used_a
            elist = diff_b if need_b else diff_a
            nxt = next((i for i in pool if not used[i]), None)
            if nxt is None:
                break  # dead end: discard walk (edges stay consumed)
            used[nxt] = True
            u, v = elist[nxt]
            walk.append(((u, v), not need_b))
            cur = v if cur == u else u
            path.append(cur)
            if not need_b:
                continue
            # a B edge just came back to a vertex that an A edge of the
            # walk leaves (the start, or one met on the way): the part of
            # the walk from there is an AB-cycle, even and alternating,
            # starting on A and ending on B. cuopt_tpu closes only at the
            # start and after an A edge, so its cycles are odd.
            k = next((k for k in range(len(walk) - 2, -1, -2)
                      if path[k] == cur), None)
            if k is not None:
                cycles.append(walk[k:])
                del walk[k:]
                del path[k + 1:]
    return cycles


def _routes_from_edges(edges, n_serve, rng):
    """Rebuild depot routes + free subtours from an undirected edge
    multiset where every customer has degree 2."""
    from collections import defaultdict

    adj = defaultdict(list)
    for i, (u, v) in enumerate(edges):
        adj[u].append((v, i))
        adj[v].append((u, i))
    used = np.zeros(len(edges), bool)
    routes = []
    subtours = []
    # depot walks first
    while True:
        start = next(
            ((v, i) for v, i in adj[DEPOT] if not used[i]), None
        )
        if start is None:
            break
        path = []
        cur, ei = start
        used[ei] = True
        while cur != DEPOT:
            path.append(cur)
            nxt = next(
                ((w, j) for w, j in adj[cur] if not used[j]), None
            )
            if nxt is None:
                break  # degenerate; treat as route end
            used[nxt[1]] = True
            cur = nxt[0]
        if path:
            routes.append(path)
    # remaining cycles (subtours without depot)
    for v in range(n_serve):
        while True:
            startedge = next(
                ((w, i) for w, i in adj[v] if not used[i]), None
            )
            if startedge is None:
                break
            tour = [v]
            cur, ei = startedge
            used[ei] = True
            while cur != v:
                tour.append(cur)
                nxt = next(
                    ((w, j) for w, j in adj[cur] if not used[j]), None
                )
                if nxt is None:
                    break
                used[nxt[1]] = True
                cur = nxt[0]
            subtours.append(tour)
    return routes, subtours


def _merge_subtour(prob, route, tour):
    """Cheapest 2-edge splice of `tour` (a customer cycle) into `route`
    (a depot path), preserving or reversing the tour's orientation."""
    ti = prob.type_index[int(prob.veh_type[0])]
    depot = int(prob.veh_start[0])

    def loc(o):
        return depot if o == DEPOT else int(prob.order_loc[o])

    best = None
    seq = [DEPOT] + route + [DEPOT]
    for i in range(len(seq) - 1):
        a, b = loc(seq[i]), loc(seq[i + 1])
        for k in range(len(tour)):
            rot = tour[k:] + tour[:k]
            for cand_t in (rot, rot[::-1]):
                u, v = loc(cand_t[0]), loc(cand_t[-1])
                delta = (
                    prob.raw_cost_mats[ti, a, u]
                    + prob.raw_cost_mats[ti, v, b]
                    - prob.raw_cost_mats[ti, a, b]
                )
                if best is None or delta < best[0]:
                    best = (delta, i, list(cand_t))
    _, i, cand = best
    return route[:i] + cand + route[i:]


def eax(prob, parent_a, parent_b, rng):
    """One EAX offspring from parents (routes dicts). Returns
    (routes, unassigned) or None when not applicable/degenerate."""
    if not eax_applicable(prob):
        return None
    ra = {v: r for v, r in parent_a["routes"].items() if r}
    rb = {v: r for v, r in parent_b["routes"].items() if r}
    if not ra or not rb:
        return None
    served_a = set(o for r in ra.values() for o in r)
    served_b = set(o for r in rb.values() for o in r)
    if served_a != served_b:
        return None  # prize-collecting parents: fall back
    ea, eb = _edges(ra), _edges(rb)
    cycles = _ab_cycles(ea, eb, rng)
    if not cycles:
        return None
    # E-set: single random AB-cycle (the reference's single strategy;
    # optimal_eax_cycles.cu picks via a scored selection)
    from collections import Counter

    chosen = cycles[int(rng.integers(len(cycles)))]
    child = Counter(ea)
    for (edge, from_a) in chosen:
        if from_a:
            child[edge] -= 1
            if child[edge] <= 0:
                del child[edge]
        else:
            child[edge] += 1
    routes, subtours = _routes_from_edges(
        list(child.elements()), prob.n_serve, rng
    )
    for tour in subtours:
        if not routes:
            routes.append(tour)
            continue
        # splice into the route with the cheapest insertion
        best_ri, best_cand, best_cost = None, None, np.inf
        for ri, r in enumerate(routes):
            cand = _merge_subtour(prob, r, tour)
            c = prob.route_cost(0, cand) - prob.route_cost(0, r)
            if c < best_cost:
                best_ri, best_cand, best_cost = ri, cand, c
        routes[best_ri] = best_cand
    # map back onto vehicles; repair infeasible routes by pulling orders
    out = {v: [] for v in range(prob.n_fleet)}
    leftovers = []
    # safety: any orders lost in degenerate graph surgery rejoin the pool
    present = set(o for r in routes for o in r)
    leftovers.extend(o for o in served_a if o not in present)
    routes.sort(key=len, reverse=True)
    for v, r in zip(range(prob.n_fleet), routes):
        out[v] = r
    for r in routes[prob.n_fleet:]:
        leftovers.extend(r)
    for v in range(prob.n_fleet):
        r = out[v]
        while r and not prob.route_feasible(v, r):
            # drop the order whose removal most reduces infeasibility
            # cost: cheapest-cost heuristic — remove the max-demand one
            j = int(np.argmax(prob.demand.sum(axis=0)[r]))
            leftovers.append(r.pop(j))
    from cuopt_torch.routing.construction import smart_reinsert

    out, unassigned = smart_reinsert(prob, out, leftovers, rng)
    return out, unassigned
