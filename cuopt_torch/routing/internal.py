"""Internal routing problem arrays + route evaluation.

The counterpart of the reference problem/route state layer
(cpp/src/routing/problem/problem.cuh, route/route.cuh dimension templates
with forward/backward cumulative data). Host-side numpy here; the hot
move-evaluation tensors live in local_search.py as PyTorch tensors on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

INF = np.inf


@dataclass
class RoutingProblem:
    n_locations: int
    n_fleet: int
    # orders to actually serve (depot-orders excluded)
    serve_orders: np.ndarray  # original order ids
    order_loc: np.ndarray  # (n_serve,) location of each served order
    demand: np.ndarray  # (n_dims, n_serve)
    capacity: np.ndarray  # (n_dims, n_fleet)
    tw_early: np.ndarray  # (n_serve,)
    tw_late: np.ndarray
    service: np.ndarray  # (n_serve,)
    prizes: np.ndarray | None
    veh_type: np.ndarray  # (n_fleet,)
    veh_start: np.ndarray  # (n_fleet,) locations
    veh_return: np.ndarray
    veh_tw_early: np.ndarray
    veh_tw_late: np.ndarray
    veh_fixed_cost: np.ndarray
    veh_max_cost: np.ndarray
    veh_max_time: np.ndarray
    drop_return: np.ndarray  # (n_fleet,) bool
    skip_first: np.ndarray  # (n_fleet,) bool
    cost_mats: np.ndarray  # (n_types, L, L)
    time_mats: np.ndarray  # (n_types, L, L)
    type_index: dict  # vehicle_type value -> index into mats
    # pickup-delivery: for each served order, partner index (-1 if none),
    # +1 if pickup, -1 if delivery, 0 if unpaired
    pd_partner: np.ndarray = field(default=None)
    pd_sign: np.ndarray = field(default=None)
    allowed_vehicles: np.ndarray = field(default=None)  # (n_serve, F) bool
    # per-vehicle break list: dicts {early, late, duration, locs|None},
    # sorted by `late` (reference data_model_view.hpp add_break_dimension /
    # add_vehicle_break; break locations :195-198)
    breaks: list = field(default=None)
    # objective weights (reference set_objective_function,
    # vehicle_routing.py:421): the SEARCH runs on effective matrices
    # cost_mats = w_cost*raw_cost + w_tt*raw_time already blended by
    # build_problem; raw matrices kept for per-objective reporting
    objective_weights: dict = field(default=None)  # Objective -> weight
    raw_cost_mats: np.ndarray = field(default=None)
    raw_fixed_cost: np.ndarray = field(default=None)
    # precedence: list of (order, np.ndarray preds) in SERVE indices
    # (reference data_model_view.hpp:368)
    precedence: list = field(default=None)

    @property
    def n_serve(self):
        return len(self.order_loc)

    def has_breaks(self, vehicle: int) -> bool:
        return bool(self.breaks) and bool(self.breaks[vehicle])

    def cost(self, vtype_idx, a, b):
        return self.cost_mats[vtype_idx, a, b]

    def route_cost(self, vehicle: int, route: list[int]) -> float:
        """Cost of one route (serve-order index list, no depots)."""
        if not route:
            return 0.0
        if self.has_breaks(vehicle):
            return self.route_plan(vehicle, route)["cost"]
        ti = self.type_index[int(self.veh_type[vehicle])]
        locs = self.order_loc[route]
        c = 0.0
        if not self.skip_first[vehicle]:
            c += self.cost_mats[ti, self.veh_start[vehicle], locs[0]]
        c += float(np.sum(self.cost_mats[ti, locs[:-1], locs[1:]]))
        if not self.drop_return[vehicle]:
            c += self.cost_mats[ti, locs[-1], self.veh_return[vehicle]]
        return c + float(self.veh_fixed_cost[vehicle])

    def route_plan(self, vehicle: int, route: list[int]) -> dict:
        """Full traversal: arrivals, cost, end time, break events,
        time-feasibility.

        Breaks use a take-late greedy: each pending break is postponed
        until the next leg would overshoot its latest start (an
        approximation of the reference's exact break scheduling —
        cpp/src/routing/node/break_node.cuh — chosen because it keeps the
        traversal single-pass and mask-friendly)."""
        ti = self.type_index[int(self.veh_type[vehicle])]
        t = self.time_mats[ti]
        cmat = self.cost_mats[ti]
        if not route:
            return dict(arrivals=np.zeros(0), time_ok=True, cost=0.0,
                        end_time=float(self.veh_tw_early[vehicle]),
                        breaks=[])
        pending = list(self.breaks[vehicle]) if self.has_breaks(vehicle) \
            else []
        pending_ct = len(pending)
        cur_loc = self.veh_start[vehicle]
        now = self.veh_tw_early[vehicle]
        cost = float(self.veh_fixed_cost[vehicle]) if route else 0.0
        arr = []
        events = []
        ok = True

        def take_break(b, next_loc):
            """Take break b now, possibly detouring via a break location.
            Returns the location we end at (for located breaks the vehicle
            continues from the break location)."""
            nonlocal now, cost, cur_loc, ok
            if b["locs"] is not None and len(b["locs"]):
                # choose the break location minimizing the cost detour
                # cur -> bl -> next
                bls = np.asarray(b["locs"], np.int64)
                detour = cmat[cur_loc, bls] + (
                    cmat[bls, next_loc] - cmat[cur_loc, next_loc]
                    if next_loc >= 0 else 0.0
                )
                bl = int(bls[int(np.argmin(detour))])
                start = max(now + t[cur_loc, bl], b["early"])
                cost += float(cmat[cur_loc, bl])
                cur_loc = bl
            else:
                start = max(now, b["early"])
            if start > b["late"] + 1e-9:
                ok = False
            events.append(dict(
                start=float(start), duration=float(b["duration"]),
                location=int(cur_loc),
            ))
            now = start + b["duration"]

        def must_take_now(b, next_depart, next_loc):
            """Postponing past the next stop means the break starts no
            earlier than next_depart (+ travel to a break location)."""
            lb = next_depart
            if b["locs"] is not None and len(b["locs"]):
                bls = np.asarray(b["locs"], np.int64)
                lb = next_depart + float(np.min(t[next_loc, bls]))
            return lb > b["late"] + 1e-9

        for k, o in enumerate(route):
            lo = self.order_loc[o]
            # take any pending breaks that cannot be postponed past this leg
            while pending:
                b = pending[0]
                skip_leg = k == 0 and self.skip_first[vehicle]
                travel = 0.0 if skip_leg else t[cur_loc, lo]
                next_depart = max(now + travel, self.tw_early[o]) \
                    + self.service[o]
                if must_take_now(b, next_depart, int(lo)):
                    pending.pop(0)
                    take_break(b, int(lo))
                else:
                    break
            skip_leg = k == 0 and self.skip_first[vehicle]
            travel = 0.0 if skip_leg else t[cur_loc, lo]
            if not skip_leg:
                cost += float(cmat[cur_loc, lo])
            a = max(now + travel, self.tw_early[o])
            if a > self.tw_late[o] + 1e-9:
                ok = False
            arr.append(a)
            now = a + self.service[o]
            cur_loc = lo
        # remaining breaks at route end
        for b in pending:
            take_break(b, int(self.veh_return[vehicle])
                       if not self.drop_return[vehicle] else -1)
        if route and not self.drop_return[vehicle]:
            cost += float(cmat[cur_loc, self.veh_return[vehicle]])
            now = now + t[cur_loc, self.veh_return[vehicle]]
        if now > self.veh_tw_late[vehicle] + 1e-9:
            ok = False
        if not ok and 0 < pending_ct <= 3:
            exact = self._route_plan_exact_breaks(vehicle, route)
            if exact is not None:
                return exact
        return dict(
            arrivals=np.asarray(arr), time_ok=ok, cost=cost,
            end_time=float(now), breaks=events,
        )

    def _route_plan_exact_breaks(self, vehicle: int, route: list[int]):
        """Exact break scheduling by position enumeration (reference
        treats breaks as route NODES whose position the search chooses,
        node/break_node.cuh). The take-late greedy in route_plan is a
        fast approximation; when it reports infeasible and the vehicle
        has <= 3 breaks, this enumerates all ordered break positions
        (start-as-early-as-allowed within a placement is optimal for
        makespan) and returns the first feasible plan, else None."""
        from itertools import combinations_with_replacement

        ti = self.type_index[int(self.veh_type[vehicle])]
        t = self.time_mats[ti]
        cmat = self.cost_mats[ti]
        brs = list(self.breaks[vehicle])
        L = len(route)
        best = None
        for positions in combinations_with_replacement(range(L + 1),
                                                       len(brs)):
            now = float(self.veh_tw_early[vehicle])
            cur_loc = int(self.veh_start[vehicle])
            cost = float(self.veh_fixed_cost[vehicle]) if route else 0.0
            arr = []
            events = []
            ok = True
            bi = 0

            def take(b, next_loc):
                nonlocal now, cur_loc, cost, ok
                if b["locs"] is not None and len(b["locs"]):
                    bls = np.asarray(b["locs"], np.int64)
                    detour = cmat[cur_loc, bls] + (
                        cmat[bls, next_loc] - cmat[cur_loc, next_loc]
                        if next_loc >= 0 else 0.0
                    )
                    bl = int(bls[int(np.argmin(detour))])
                    start = max(now + t[cur_loc, bl], b["early"])
                    cost += float(cmat[cur_loc, bl])
                    cur_loc = bl
                else:
                    start = max(now, b["early"])
                if start > b["late"] + 1e-9:
                    ok = False
                events.append(dict(start=float(start),
                                   duration=float(b["duration"]),
                                   location=int(cur_loc)))
                now = start + b["duration"]

            for k, o in enumerate(route):
                while bi < len(brs) and positions[bi] == k:
                    take(brs[bi], int(self.order_loc[o]))
                    bi += 1
                lo = int(self.order_loc[o])
                skip_leg = k == 0 and self.skip_first[vehicle]
                travel = 0.0 if skip_leg else t[cur_loc, lo]
                if not skip_leg:
                    cost += float(cmat[cur_loc, lo])
                a = max(now + travel, self.tw_early[o])
                if a > self.tw_late[o] + 1e-9:
                    ok = False
                    break
                arr.append(a)
                now = a + self.service[o]
                cur_loc = lo
            if not ok:
                continue
            end_loc = int(self.veh_return[vehicle])                 if not self.drop_return[vehicle] else -1
            while bi < len(brs):
                take(brs[bi], end_loc)
                bi += 1
            if route and not self.drop_return[vehicle]:
                cost += float(cmat[cur_loc, self.veh_return[vehicle]])
                now = now + t[cur_loc, self.veh_return[vehicle]]
            if now > self.veh_tw_late[vehicle] + 1e-9:
                ok = False
            if ok and (best is None or cost < best["cost"]):
                best = dict(arrivals=np.asarray(arr), time_ok=True,
                            cost=cost, end_time=float(now),
                            breaks=events)
        return best

    def route_schedule(self, vehicle: int, route: list[int]):
        """Arrival times; returns (arrivals, feasible)."""
        plan = self.route_plan(vehicle, route)
        return plan["arrivals"], plan["time_ok"]

    def route_feasible(self, vehicle: int, route: list[int]) -> bool:
        if not route:
            return True
        # the load carried after each stop: a pickup's load rides until
        # its delivery, so the route's summed (net) demand is not enough.
        # With no negative demand the largest prefix is the total.
        load = np.cumsum(self.demand[:, route], axis=1)
        if np.any(load > self.capacity[:, vehicle, None] + 1e-9):
            return False
        if self.allowed_vehicles is not None:
            if not np.all(self.allowed_vehicles[route, vehicle]):
                return False
        if self.pd_partner is not None:
            pos = {o: i for i, o in enumerate(route)}
            for i, o in enumerate(route):
                p = self.pd_partner[o]
                if p >= 0:
                    if p not in pos:
                        return False
                    if self.pd_sign[o] > 0 and pos[p] < i:
                        return False
        plan = self.route_plan(vehicle, route)
        if not plan["time_ok"]:
            return False
        if np.isfinite(self.veh_max_cost[vehicle]):
            if plan["cost"] - self.veh_fixed_cost[vehicle] > \
                    self.veh_max_cost[vehicle] + 1e-9:
                return False
        if np.isfinite(self.veh_max_time[vehicle]):
            start = self.veh_tw_early[vehicle]
            if plan["end_time"] - start > self.veh_max_time[vehicle] + 1e-9:
                return False
        return True

    def solution_cost(self, routes: dict[int, list[int]]) -> float:
        total = sum(
            self.route_cost(v, r) for v, r in routes.items() if r
        )
        if self.prizes is not None:
            served = set()
            for r in routes.values():
                served.update(r)
            unserved = set(range(self.n_serve)) - served
            total += float(sum(self.prizes[list(unserved)])) \
                if unserved else 0.0
        return total


def build_problem(dm) -> RoutingProblem:
    """DataModel -> RoutingProblem internal arrays."""
    L = dm.n_locations
    F = dm.n_fleet
    veh_type = dm.vehicle_types if dm.vehicle_types is not None \
        else np.zeros(F, np.int64)
    types = sorted(set(int(t) for t in veh_type))
    type_index = {t: i for i, t in enumerate(types)}
    cost_mats = np.stack([dm.cost_matrices[t] for t in types])
    if dm.transit_time_matrices:
        time_mats = np.stack([
            dm.transit_time_matrices.get(t, dm.cost_matrices[t])
            for t in types
        ])
    else:
        time_mats = cost_mats.copy()

    # objective weights: default COST=1 (reference vehicle_routing.py:421
    # "1 is used for COST objective weight and 0 for other weights").
    # The search optimizes BLENDED arc matrices (drive-time part of
    # TRAVEL_TIME; service time is solution-invariant, wait time is
    # approximated by the TW machinery) plus weighted fixed costs/prizes.
    from cuopt_torch.routing.assignment import Objective

    raw_cost_mats = cost_mats
    raw_fixed = dm.vehicle_fixed_costs if dm.vehicle_fixed_costs \
        is not None else np.zeros(F)
    if dm.objectives:
        weights = {Objective(o): w for o, w in
                   zip(dm.objectives, dm.objective_weights)}
    else:
        weights = {Objective.COST: 1.0}
    w_cost = weights.get(Objective.COST, 0.0)
    w_tt = weights.get(Objective.TRAVEL_TIME, 0.0)
    w_vfc = weights.get(Objective.VEHICLE_FIXED_COST,
                        1.0 if Objective.COST in weights else 0.0)
    if w_cost != 1.0 or w_tt != 0.0:
        cost_mats = w_cost * raw_cost_mats + w_tt * time_mats
    eff_fixed = raw_fixed * w_vfc

    veh_start = dm.vehicle_start if dm.vehicle_start is not None \
        else np.zeros(F, np.int64)
    veh_return = dm.vehicle_return if dm.vehicle_return is not None \
        else veh_start.copy()

    if dm.order_locations is not None:
        order_loc_all = dm.order_locations
        serve = np.arange(dm.n_orders)
    else:
        order_loc_all = np.arange(dm.n_orders)
        depot_locs = set(veh_start.tolist()) | set(veh_return.tolist())
        serve = np.array(
            [o for o in range(dm.n_orders)
             if int(order_loc_all[o]) not in depot_locs],
            np.int64,
        )
    ns = len(serve)
    order_loc = order_loc_all[serve]

    if dm.capacity_dimensions:
        demand = np.stack(
            [d[serve] for d, _ in dm.capacity_dimensions.values()]
        )
        capacity = np.stack(
            [c for _, c in dm.capacity_dimensions.values()]
        )
    else:
        demand = np.zeros((1, ns))
        capacity = np.full((1, F), INF)

    if dm.order_tw is not None:
        tw_early = dm.order_tw[0][serve]
        tw_late = dm.order_tw[1][serve]
    else:
        tw_early = np.zeros(ns)
        tw_late = np.full(ns, INF)
    service = dm.order_service_times.get(-1)
    service = service[serve] if service is not None else np.zeros(ns)

    if dm.vehicle_tw is not None:
        veh_tw_early, veh_tw_late = dm.vehicle_tw
    else:
        veh_tw_early = np.zeros(F)
        veh_tw_late = np.full(F, INF)

    pd_partner = None
    pd_sign = None
    if dm.pickup_indices is not None:
        orig_to_serve = {int(o): i for i, o in enumerate(serve)}
        pd_partner = np.full(ns, -1, np.int64)
        pd_sign = np.zeros(ns, np.int64)
        for p, d in zip(dm.pickup_indices, dm.delivery_indices):
            pi = orig_to_serve.get(int(p))
            di = orig_to_serve.get(int(d))
            if pi is not None and di is not None:
                pd_partner[pi] = di
                pd_partner[di] = pi
                pd_sign[pi] = 1
                pd_sign[di] = -1

    allowed = None
    if dm.vehicle_order_match or dm.order_vehicle_match:
        allowed = np.ones((ns, F), bool)
        orig_to_serve = {int(o): i for i, o in enumerate(serve)}
        if dm.order_vehicle_match:
            for o, vehs in dm.order_vehicle_match.items():
                i = orig_to_serve.get(int(o))
                if i is not None:
                    allowed[i, :] = False
                    allowed[i, vehs] = True
        if dm.vehicle_order_match:
            restricted = np.zeros(F, bool)
            ok_orders = {v: set(orders.tolist())
                         for v, orders in dm.vehicle_order_match.items()}
            for v, orders in ok_orders.items():
                restricted[v] = True
                for o in range(ns):
                    if int(serve[o]) not in orders:
                        allowed[o, v] = False

    # breaks: dimension breaks (per-fleet arrays) + per-vehicle breaks,
    # each with optional break locations (global set_break_locations is
    # the default for dimension breaks)
    breaks = None
    if dm.break_dimensions or dm.vehicle_breaks:
        breaks = [[] for _ in range(F)]
        g_locs = dm.break_locations
        for bd in dm.break_dimensions:
            for v in range(F):
                breaks[v].append(dict(
                    early=float(bd["earliest"][v]),
                    late=float(bd["latest"][v]),
                    duration=float(bd["duration"][v]),
                    locs=g_locs,
                ))
        for vb in dm.vehicle_breaks:
            v = vb["vehicle_id"]
            breaks[v].append(dict(
                early=vb["earliest"], late=vb["latest"],
                duration=vb["duration"],
                locs=vb["locations"] if vb["locations"] is not None
                else g_locs,
            ))
        for v in range(F):
            breaks[v].sort(key=lambda b: (b["late"], b["early"]))

    precedence = None
    if getattr(dm, "order_precedence", None):
        orig_to_serve = {int(o): i for i, o in enumerate(serve)}
        precedence = []
        for o, preds in dm.order_precedence.items():
            oi = orig_to_serve.get(int(o))
            pis = np.array([orig_to_serve[int(p)] for p in preds
                            if int(p) in orig_to_serve], np.int64)
            if oi is not None and len(pis):
                precedence.append((oi, pis))

    prize_w = weights.get(Objective.PRIZE,
                          1.0 if Objective.COST in weights else 0.0)
    prizes = None if dm.order_prizes is None \
        else dm.order_prizes[serve] * (prize_w if dm.objectives else 1.0)

    return RoutingProblem(
        n_locations=L, n_fleet=F,
        serve_orders=serve, order_loc=order_loc,
        demand=demand, capacity=capacity,
        tw_early=tw_early, tw_late=tw_late, service=service,
        prizes=prizes,
        veh_type=veh_type, veh_start=veh_start, veh_return=veh_return,
        veh_tw_early=veh_tw_early, veh_tw_late=veh_tw_late,
        veh_fixed_cost=eff_fixed,
        veh_max_cost=dm.vehicle_max_costs
        if dm.vehicle_max_costs is not None else np.full(F, INF),
        veh_max_time=dm.vehicle_max_times
        if dm.vehicle_max_times is not None else np.full(F, INF),
        drop_return=dm.drop_return_trips
        if dm.drop_return_trips is not None else np.zeros(F, bool),
        skip_first=dm.skip_first_trips
        if dm.skip_first_trips is not None else np.zeros(F, bool),
        cost_mats=cost_mats, time_mats=time_mats, type_index=type_index,
        pd_partner=pd_partner, pd_sign=pd_sign,
        allowed_vehicles=allowed,
        breaks=breaks,
        objective_weights=weights,
        raw_cost_mats=raw_cost_mats,
        raw_fixed_cost=raw_fixed,
        precedence=precedence,
    )


def order_arrival_times(prob: RoutingProblem, routes: dict) -> np.ndarray:
    """Service-start time of every serve order in the solution (-inf for
    unassigned). Used by the cross-route precedence check."""
    arr = np.full(prob.n_serve, -INF)
    for v, r in routes.items():
        if not r:
            continue
        plan = prob.route_plan(v, r)
        for o, a in zip(r, plan["arrivals"]):
            arr[o] = a
    return arr


def precedence_depth(prob: RoutingProblem) -> np.ndarray:
    """DAG depth of every serve order under the precedence constraints
    (0 = no predecessors). Construction/reinsertion process orders in
    ascending depth so predecessors are always placed first — precedence
    is then satisfiable by insertion-time checks instead of post-hoc
    repair (reference enforces it in ejection-insertion feasibility,
    data_model_view.hpp:359-368)."""
    depth = np.zeros(prob.n_serve, np.int32)
    if not prob.precedence:
        return depth
    preds_map = {int(o): [int(p) for p in preds]
                 for o, preds in prob.precedence}
    memo: dict[int, int] = {}

    def d(o: int) -> int:
        if o in memo:
            return memo[o]
        memo[o] = 0  # cycle guard (validate() rejects real cycles)
        ps = preds_map.get(o, [])
        memo[o] = 1 + max((d(p) for p in ps), default=-1)
        return memo[o]

    for o in range(prob.n_serve):
        depth[o] = d(o)
    return depth


def insert_precedence_ok(prob: RoutingProblem, arr: np.ndarray, v: int,
                         cand: list[int]) -> bool:
    """Would replacing route v with `cand` keep all precedence pairs whose
    arrivals it touches consistent?  `arr` holds current service-start
    times (order_arrival_times); constraints with an UNSERVED predecessor
    are ignored here — construction processes orders in precedence_depth
    order, so a served order's predecessors are placed first, and the
    final solution check (precedence_ok) still rejects pred-unserved."""
    if not prob.precedence:
        return True
    arr2 = arr.copy()
    plan = prob.route_plan(v, cand)
    for o, a in zip(cand, plan["arrivals"]):
        arr2[o] = a
    changed = set(int(o) for o in cand)
    for o, preds in prob.precedence:
        o = int(o)
        if arr2[o] == -INF:
            continue
        if o not in changed and not any(int(p) in changed for p in preds):
            continue
        for p in preds:
            pa = arr2[int(p)]
            if pa != -INF and pa > arr2[o] + 1e-9:
                return False
    return True


def precedence_ok(prob: RoutingProblem, routes: dict,
                  unassigned=()) -> bool:
    """Cross-route temporal precedence: every order with precedence must
    start service no earlier than each of its preceding orders; a served
    order with an UNSERVED predecessor is infeasible (reference
    data_model_view.hpp:359-368 'scheduled prior')."""
    if not prob.precedence:
        return True
    arr = order_arrival_times(prob, routes)
    for o, preds in prob.precedence:
        if arr[o] == -INF:
            continue  # o itself unserved: nothing to order
        for p in preds:
            if arr[int(p)] == -INF or arr[int(p)] > arr[o] + 1e-9:
                return False
    return True
