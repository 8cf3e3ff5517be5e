"""Exchange-cycle move family (reference
cpp/src/routing/local_search/cycle_finder/cycle_finder.cu).

The reference builds per-pair best-relocation gains in device hash maps
and searches for improving exchange cycles (order o1 moves r1->r2, o2
moves r2->r3, ..., ok closes the cycle back to r1) with a GPU
Bellman-Ford-flavored sweep. Device/host split: the (F, F) gain matrix
comes from one device tensor program (local_search.evaluate_cycle_gains)
and the negative-cycle search runs on host (F routes is small; the
matrix is tiny next to the move-evaluation tensors).

Applied cycles are re-validated against the EXACT host route model
(capacity/TW/breaks) before acceptance — the device mask uses a relaxed
capacity (each route in the cycle also loses an order).
"""

from __future__ import annotations

import numpy as np

BIG = 1e11


def find_negative_cycle(G):
    """Bellman-Ford negative-cycle detection on the dense gain matrix
    G[i, j] = cost of the best single-order move i -> j (BIG when no
    feasible move). Returns a node cycle [r0, r1, ..., r0] or None."""
    F = G.shape[0]
    dist = np.zeros(F)
    pred = np.full(F, -1)
    x = -1
    for _ in range(F):
        x = -1
        for i in range(F):
            for j in range(F):
                w = G[i, j]
                if w >= BIG:
                    continue
                if dist[i] + w < dist[j] - 1e-9:
                    dist[j] = dist[i] + w
                    pred[j] = i
                    x = j
        if x == -1:
            return None
    # x is on or reachable from a negative cycle; walk back F steps
    for _ in range(F):
        x = pred[x]
    cycle = [x]
    v = pred[x]
    while v != x:
        cycle.append(v)
        v = pred[v]
    cycle.append(x)
    cycle.reverse()  # [x, ..., x] in edge direction pred->node
    return cycle


def apply_exchange_cycle(prob, routes, gains, pos, slot):
    """Find one improving exchange cycle and apply it; returns
    (new_routes, improved: bool).

    gains/pos/slot: (F, F) arrays from evaluate_cycle_gains — the best
    order position of r1 and insertion slot in r2 per pair. Moves are
    applied in cycle order with EXACT re-validation; any failure rejects
    the whole cycle.
    """
    G = np.array(gains, float)
    np.fill_diagonal(G, BIG)
    cyc = find_negative_cycle(G)
    if cyc is None or len(cyc) < 3:
        return routes, False
    new_routes = {v: list(r) for v, r in routes.items()}
    # collect the moved order of each edge BEFORE mutating (positions
    # refer to the original routes)
    moves = []
    for a, b in zip(cyc[:-1], cyc[1:]):
        i = int(pos[a, b])
        if i >= len(routes[a]):
            return routes, False
        moves.append((a, b, routes[a][i], int(slot[a, b])))
    for a, b, order, j in moves:
        if order not in new_routes[a]:
            return routes, False
        new_routes[a].remove(order)
        j = min(j, len(new_routes[b]))
        new_routes[b].insert(j, order)
    touched = set(cyc)
    base = sum(prob.route_cost(v, routes[v]) for v in touched)
    new = sum(prob.route_cost(v, new_routes[v]) for v in touched)
    if new >= base - 1e-7:
        return routes, False
    for v in touched:
        if new_routes[v] and not prob.route_feasible(v, new_routes[v]):
            return routes, False
    return new_routes, True


def cycle_search(prob, lsp, routes, max_cycles=5):
    """Run up to max_cycles exchange-cycle improvements."""
    import torch

    from cuopt_torch.routing.local_search import (
        evaluate_cycle_gains,
        to_host,
    )

    improved_any = False
    for _ in range(max_cycles):
        longest = max((len(r) for r in routes.values()), default=1)
        L_pad = max(8, ((longest + 4 + 7) // 8) * 8)
        F = prob.n_fleet
        R = np.full((F, L_pad), -1, np.int32)
        lens = np.zeros(F, np.int32)
        for v, r in routes.items():
            R[v, : len(r)] = r
            lens[v] = len(r)
        g, p_, s_ = evaluate_cycle_gains(lsp, R, lens)
        # one readback; ids are exact in float32
        g, p_, s_ = to_host(torch.stack([g, p_.to(g.dtype),
                                         s_.to(g.dtype)]))
        p_, s_ = p_.astype(np.int64), s_.astype(np.int64)
        routes, ok = apply_exchange_cycle(prob, routes, g, p_, s_)
        improved_any |= ok
        if not ok:
            break
    return routes, improved_any


def hvrp_reassign(prob, lsp, routes, max_moves=4):
    """Regret-based route->vehicle reassignment for heterogeneous fleets
    (reference local_search/hvrp regret kernels): move whole routes onto
    cheaper idle vehicles, largest regret first, with exact
    re-validation."""
    import torch

    from cuopt_torch.routing.local_search import (
        evaluate_vehicle_reassign,
        to_host,
    )

    veh_profile = {}
    hetero = False
    for v in range(prob.n_fleet):
        key = (int(prob.veh_type[v]), int(prob.veh_start[v]),
               int(prob.veh_return[v]), float(prob.veh_fixed_cost[v]))
        veh_profile[v] = key
        if key != veh_profile[0]:
            hetero = True
    if not hetero:
        return routes, False
    longest = max((len(r) for r in routes.values()), default=1)
    L_pad = max(8, ((longest + 4 + 7) // 8) * 8)
    F = prob.n_fleet
    import numpy as np

    R = np.full((F, L_pad), -1, np.int32)
    lens = np.zeros(F, np.int32)
    for v, r in routes.items():
        R[v, : len(r)] = r
        lens[v] = len(r)
    cost, feas = evaluate_vehicle_reassign(lsp, R, lens)
    cost, feas = to_host(torch.stack([cost, feas.to(cost.dtype)]))
    feas = feas.astype(bool)
    improved = False
    idle = {v for v, r in routes.items() if not r}
    order = []
    for r1 in range(F):
        if lens[r1] == 0:
            continue
        own = cost[r1, r1]
        cands = [(cost[v2, r1], v2) for v2 in idle
                 if cost[v2, r1] < own - 1e-7]
        if not cands:
            continue
        cands.sort()
        best_gain = own - cands[0][0]
        second = cands[1][0] - cands[0][0] if len(cands) > 1 else 0.0
        order.append((-(best_gain + second), r1, cands[0][1]))
    order.sort()
    moves = 0
    for _, r1, v2 in order:
        if moves >= max_moves or v2 not in idle or not routes[r1]:
            continue
        seq = routes[r1]
        if not prob.route_feasible(v2, seq):
            continue
        old = prob.route_cost(r1, seq)
        new = prob.route_cost(v2, seq)
        if new >= old - 1e-7:
            continue
        routes[v2] = seq
        routes[r1] = []
        idle.discard(v2)
        idle.add(r1)
        improved = True
        moves += 1
    return routes, improved
