"""Population / diversity management + recombiners for routing.

Counterpart of the reference diversity framework
(cpp/src/routing/diversity/diverse_solver.hpp:151 population islands and
recombiner mix {SREX, OX, ...} in cpp/src/routing/crossovers/). The
population is a small host-side pool keyed by cost with an arc-overlap
diversity metric; offspring are produced by

  - SREX (selective route exchange, srex_recombiner.cu analogue): child
    inherits a random subset of routes from parent B on top of parent A,
    duplicates removed, missing orders greedily reinserted;
  - OX (order crossover, ox_recombiner.cu analogue) for single-route
    (TSP-like) solutions;
  - ruin & recreate mutation as the diversity fallback.

Each offspring is polished by the device local search before entering the
population (reference: LS offspring in diversity_manager).
"""

from __future__ import annotations

import numpy as np


def _arcs(routes):
    """Set of directed arcs (order -> order) over all routes."""
    s = set()
    for r in routes.values():
        for a, b in zip(r[:-1], r[1:]):
            s.add((a, b))
    return s


def solution_distance(ra, rb):
    """1 - arc overlap fraction (diversity metric; reference population
    distance in diversity/helpers)."""
    aa, bb = _arcs(ra), _arcs(rb)
    if not aa and not bb:
        return 0.0
    return 1.0 - len(aa & bb) / max(1, len(aa | bb))


class RoutingPopulation:
    """Fixed-size pool of (cost, n_unassigned, routes, unassigned).

    Optionally split into ISLANDS (reference diverse_solver.hpp:151):
    each island evolves on its own members; migrate() copies each
    island's champion into the next island, preserving diversity while
    spreading the best genes."""

    def __init__(self, max_size=8, min_distance=0.05, n_islands=1):
        self.max_size = max_size
        self.min_distance = min_distance
        self.n_islands = max(1, n_islands)
        self.members = []  # list of dicts
        self._next_island = 0
        self._adds = 0

    @property
    def best(self):
        return self.members[0] if self.members else None

    def add(self, prob, routes, unassigned):
        cost = prob.solution_cost(routes)
        key = (len(unassigned), cost)
        routes = {v: list(r) for v, r in routes.items()}
        entry = dict(cost=cost, n_un=len(unassigned), routes=routes,
                     unassigned=list(unassigned), key=key,
                     island=self._next_island % self.n_islands)
        self._next_island += 1
        # reject near-duplicates unless strictly better than the twin
        for i, m in enumerate(self.members):
            if solution_distance(m["routes"], routes) < self.min_distance:
                if key < m["key"]:
                    self.members[i] = entry
                    self.members.sort(key=lambda e: e["key"])
                    return True
                return False
        self.members.append(entry)
        self.members.sort(key=lambda e: e["key"])
        if len(self.members) > self.max_size:
            self.members.pop()
        return entry in self.members

    def parents(self, rng):
        if len(self.members) == 1:
            return self.members[0], self.members[0]
        if self.n_islands > 1:
            # prefer intra-island pairs (islands evolve independently;
            # migration is the only inter-island gene flow)
            isl = int(rng.integers(self.n_islands))
            pool = [m for m in self.members
                    if m.get("island", 0) == isl]
            if len(pool) >= 2:
                i, j = rng.choice(len(pool), size=2, replace=False)
                return pool[int(i)], pool[int(j)]
        i, j = rng.choice(len(self.members), size=2, replace=False)
        return self.members[int(i)], self.members[int(j)]

    def migrate(self, prob):
        """Copy each island's champion into the next island (ring
        migration, reference island model)."""
        if self.n_islands <= 1 or not self.members:
            return
        champs = {}
        for m in self.members:
            isl = m.get("island", 0)
            if isl not in champs or m["key"] < champs[isl]["key"]:
                champs[isl] = m
        for isl, m in list(champs.items()):
            clone = dict(m)
            clone["island"] = (isl + 1) % self.n_islands
            self.members.append(clone)
        self.members.sort(key=lambda e: e["key"])
        del self.members[self.max_size:]


def srex(prob, pa, pb, rng):
    """Selective route exchange: child = A with a random subset of B's
    routes transplanted; duplicates dropped from A-routes; missing orders
    greedily reinserted."""
    from cuopt_torch.routing.construction import smart_reinsert

    child = {v: list(r) for v, r in pa["routes"].items()}
    nonempty_b = [v for v, r in pb["routes"].items() if r]
    if not nonempty_b:
        return child, list(pa["unassigned"])
    take = rng.choice(
        nonempty_b,
        size=max(1, len(nonempty_b) // 2),
        replace=False,
    )
    transplanted = set()
    for v in take:
        child[int(v)] = list(pb["routes"][int(v)])
        transplanted.update(child[int(v)])
    # remove duplicates from non-transplanted routes
    for v in child:
        if int(v) in set(int(t) for t in take):
            continue
        child[v] = [o for o in child[v] if o not in transplanted]
    served = set()
    for r in child.values():
        served.update(r)
    missing = [o for o in range(prob.n_serve) if o not in served]
    # PD pairs: greedy_reinsert inserts pickup+delivery together; ensure
    # half-pairs are fully removed first
    if prob.pd_partner is not None:
        for v in child:
            r = child[v]
            keep = []
            rset = set(r)
            for o in r:
                p = int(prob.pd_partner[o])
                if p >= 0 and p not in rset:
                    if o not in missing:
                        missing.append(o)
                else:
                    keep.append(o)
            child[v] = keep
        missing = [o for o in missing
                   if prob.pd_partner[o] < 0 or prob.pd_sign[o] > 0]
    child, unassigned = smart_reinsert(prob, child, missing, rng)
    return child, unassigned


def ox_single_route(prob, pa, pb, rng):
    """Order crossover for 1-route solutions (TSP): keep a random segment
    of A, fill the rest in B's order. Parents with more than one route
    give no child: cuopt_tpu crosses their first routes and drops every
    other route's orders from the child, unlisted."""
    if any(sum(1 for r in p["routes"].values() if r) != 1
           for p in (pa, pb)):
        return None
    va = next((v for v, r in pa["routes"].items() if r), None)
    vb = next((v for v, r in pb["routes"].items() if r), None)
    ra, rb = pa["routes"][va], pb["routes"][vb]
    if len(ra) < 3 or set(ra) != set(rb):
        return None
    n = len(ra)
    i, j = sorted(rng.choice(n, size=2, replace=False))
    seg = ra[i:j + 1]
    seg_set = set(seg)
    rest = [o for o in rb if o not in seg_set]
    child_route = rest[:i] + seg + rest[i:]
    child = {v: [] for v in pa["routes"]}
    child[va] = child_route
    if not prob.route_feasible(va, child_route):
        return None
    return child, []


def ruin_recreate(prob, parent, rng, frac=0.15):
    """Random segment removal + greedy reinsertion (mutation operator;
    plays the reference's random-perturbation role)."""
    from cuopt_torch.routing.construction import smart_reinsert

    routes = {v: list(r) for v, r in parent["routes"].items()}
    candidates = [(v, i) for v, r in routes.items() for i in range(len(r))]
    if not candidates:
        return routes, list(parent["unassigned"])
    rng.shuffle(candidates)
    n_remove = max(1, int(frac * prob.n_serve))
    to_remove = set()
    for v, i in candidates[:n_remove]:
        o = parent["routes"][v][i]
        if prob.pd_partner is not None and prob.pd_partner[o] >= 0:
            to_remove.add(int(prob.pd_partner[o]))
        to_remove.add(o)
    for v in routes:
        routes[v] = [o for o in routes[v] if o not in to_remove]
    removed = list(to_remove) + list(parent["unassigned"])
    return smart_reinsert(prob, routes, removed, rng)


def prize_filter(prob, routes, unassigned):
    """Prize-collecting decisions (reference objective PRIZE term,
    data_model_view set_order_prizes): drop served orders whose removal
    saves more than their prize; insert unserved orders whose best
    insertion costs less than their prize."""
    if prob.prizes is None:
        return routes, unassigned
    from cuopt_torch.routing.ges import _pair_unit, feasible_insertions

    routes = {v: list(r) for v, r in routes.items()}
    unassigned = list(unassigned)
    changed = True
    guard = 0
    while changed and guard < 20:
        changed = False
        guard += 1
        # drop unprofitable orders
        for v in list(routes):
            r = routes[v]
            for o in list(r):
                unit = _pair_unit(prob, o)
                if unit[0] != o:
                    continue  # handle at the pickup
                if any(u not in r for u in unit):
                    continue
                cand = [x for x in r if x not in unit]
                saving = prob.route_cost(v, r) - prob.route_cost(v, cand)
                prize = float(sum(prob.prizes[u] for u in unit))
                if saving > prize + 1e-9:
                    routes[v] = cand
                    r = cand
                    unassigned.extend(unit)
                    changed = True
        # insert profitable unserved orders
        for o in list(unassigned):
            unit = _pair_unit(prob, o)
            if unit[0] != o:
                continue
            if any(u not in unassigned for u in unit):
                continue
            cands = feasible_insertions(prob, routes, o, max_cands=16)
            if not cands:
                continue
            delta, v, new_r = min(cands, key=lambda t: t[0])
            prize = float(sum(prob.prizes[u] for u in unit))
            if delta < prize - 1e-9:
                routes[v] = new_r
                for u in unit:
                    unassigned.remove(u)
                changed = True
    return routes, unassigned


def set_covering_child(prob, members, rng):
    """Set-covering route selection (reference crossovers/
    set_covering.hpp): pool the ROUTES of several population members and
    greedily pick a minimum-cost subset covering every order, then strip
    duplicate orders (cheapest keeper wins) and reinsert leftovers.

    A strong intensification step: good routes discovered in ANY member
    can be recombined wholesale."""
    from cuopt_torch.routing.construction import smart_reinsert

    pool = []  # (cost_per_order, orders frozenset, vehicle, route)
    for mem in members:
        for v, r in mem["routes"].items():
            if not r:
                continue
            c = prob.route_cost(v, r)
            pool.append((c / max(len(r), 1), frozenset(r), v, list(r)))
    if not pool:
        return None
    pool.sort(key=lambda t: t[0])
    uncovered = set(range(prob.n_serve))
    chosen = []
    used_vehicles = set()
    for cpo, orders, v, r in pool:
        gain = len(orders & uncovered)
        if gain == 0 or v in used_vehicles:
            continue
        chosen.append((v, r))
        used_vehicles.add(v)
        uncovered -= orders
        if not uncovered:
            break
    routes = {v: [] for v in range(prob.n_fleet)}
    placed = set()
    for v, r in chosen:
        keep = [o for o in r if o not in placed]
        routes[v] = keep
        placed.update(keep)
    leftovers = [o for o in range(prob.n_serve) if o not in placed]
    # strip any route made infeasible by duplicate removal
    for v in range(prob.n_fleet):
        if routes[v] and not prob.route_feasible(v, routes[v]):
            leftovers.extend(routes[v])
            routes[v] = []
    routes, unassigned = smart_reinsert(prob, routes, leftovers, rng)
    return routes, unassigned
