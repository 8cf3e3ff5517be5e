"""cuopt_torch's re-routing, objectives, precedence, vehicle start
locations and breaks against cuopt_tpu's, on the CPU.

`construct_rerouting_model` and the per-objective values of a fixed set
of routes are deterministic: on the same rows (a pandas DataFrame for
cuopt_tpu, the port's numpy RouteTable for cuopt_torch) both packages
must build the same model and `order_map`, and report the same values.
`Solve` runs until its time limit, so the cases of
tests/test_routing_extras.py, tests/test_routing_objectives.py and
tests/test_routing.py are held to the same properties on the port's
`Solve(device="cpu")` (time limits of 2 s).
"""

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")
pytest.importorskip("jax")

import cuopt_torch.io.vrp as t_vrp  # noqa: E402
import cuopt_torch.routing as T  # noqa: E402
import cuopt_torch.routing.solver as TS  # noqa: E402
import cuopt_tpu.io.vrp as j_vrp  # noqa: E402
import cuopt_tpu.routing as J  # noqa: E402
import cuopt_tpu.routing.solver as JS  # noqa: E402
from cuopt_torch.routing.assignment import ROUTE_COLUMNS, RouteTable  # noqa: E402
from cuopt_torch.routing.construction import cheapest_insertion  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_torch.utils.errors import ValidationError  # noqa: E402
from cuopt_torch.utils.timer import Timer as TTimer  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402
from torch_routing_instances import gh60, pd_wide  # noqa: E402

torch.set_num_threads(1)


def settings(t=2.0):
    s = T.SolverSettings()
    s.set_time_limit(t)
    return s


def solve(dm, t=2.0):
    return T.Solve(dm, settings(t), device="cpu")


def _plain(v):
    """A DataModel attribute as nested Python values, arrays with their
    dtype kind, for an exact comparison across the packages."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.kind, v.shape, v.tolist())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def _model(dm):
    return {k: _plain(v) for k, v in vars(dm).items()}


def _frame(table):
    return pd.DataFrame(table.rows(), columns=ROUTE_COLUMNS)


def base_model(R):
    """tests/test_routing_extras.py:63: locations 0..5 on a line, depot 0,
    two vehicles, pickup-delivery pairs (0 -> 1) and (2 -> 3)."""
    n = 6
    cost = np.abs(
        np.arange(n)[:, None] - np.arange(n)[None]
    ).astype(float) * 2.0
    dm = R.DataModel(n, 2, n_orders=4)
    dm.add_cost_matrix(cost)
    dm.add_transit_time_matrix(cost)
    dm.set_order_locations([1, 2, 3, 4])
    dm.set_order_time_windows([0, 0, 0, 0], [1000] * 4)
    dm.set_order_service_times([1, 1, 1, 1])
    dm.add_capacity_dimension("demand", [2, -2, 3, -3], [10, 10])
    dm.set_pickup_delivery_pairs([0, 2], [1, 3])
    dm.set_vehicle_time_windows([0, 0], [10000, 10000])
    return dm


NEW_PAIR = dict(
    order_locations=[5, 1], earliest_time=[0, 0], latest_time=[2000, 2000],
    service_time=[1, 1], pickup_indices=[0], delivery_indices=[1],
    demand=[2, -2],
)


def gh60_pd_table():
    """The port's route table of a 60-order pickup-delivery instance with
    wide windows, made from cuopt_tpu's cheapest insertion
    (deterministic), and both packages' models. The routes are those the
    port made too until it held the load carried between a pickup and
    its delivery (test_torch_carried_load.py): its own now put order 0's
    pickup on vehicle 1, where cuopt_tpu's partial-pair lookup pins the
    dummy to the first Depot row's vehicle (test_dummy_pickup_pinned_to_
    carrier), so the parity cases keep these. Re-routing reads a table,
    not its feasibility."""
    from cuopt_tpu.routing.construction import cheapest_insertion as j_ci

    tdm, jdm = pd_wide(t_vrp)[1], pd_wide(j_vrp)[1]
    prob = t_build(tdm)
    routes, unassigned = j_ci(j_build(jdm))
    asg = TS._build_assignment(prob, routes, unassigned, TTimer(10.0), tdm)
    return asg.get_route(), tdm, jdm


def _rerouted_pair(table, t, new=None):
    a = T.construct_rerouting_model(base_model(T), table, t, new)
    b = J.construct_rerouting_model(base_model(J), _frame(table), t, new)
    return a, b


class TestReRoutingParity:
    @pytest.fixture(scope="class")
    def base_table(self):
        sol = solve(base_model(T))
        assert sol.get_status() == T.SolutionStatus.SUCCESS.value
        return sol.get_route()

    @pytest.mark.parametrize("frac", [0.0, 0.15, 0.3, 0.5, 0.7, 1.1])
    @pytest.mark.parametrize("new", [None, NEW_PAIR])
    def test_base_model_equal(self, base_table, frac, new):
        t = frac * float(base_table["arrival_stamp"].max())
        (tm, tmap), (jm, jmap) = _rerouted_pair(base_table, t, new)
        assert tmap == jmap
        assert _model(tm) == _model(jm)
        # the port takes a pandas DataFrame of the same rows as well
        fm, fmap = T.construct_rerouting_model(
            base_model(T), _frame(base_table), t, new)
        assert fmap == tmap and _model(fm) == _model(tm)

    @pytest.mark.parametrize("frac", [0.2, 0.5, 0.8])
    def test_gh60_pd_equal(self, frac):
        table, tdm, jdm = gh60_pd_table()
        t = frac * float(table["arrival_stamp"].max())
        rng = np.random.default_rng(7)
        locs = rng.integers(1, tdm.get_num_locations(), 20)
        new = dict(
            order_locations=locs.tolist(), earliest_time=[0.0] * 20,
            latest_time=[1e6] * 20, service_time=[10.0] * 20,
            pickup_indices=list(range(10)),
            delivery_indices=list(range(10, 20)),
            demand=[3.0] * 10 + [-3.0] * 10,
        )
        tm, tmap = T.construct_rerouting_model(tdm, table, t, new)
        jm, jmap = J.construct_rerouting_model(jdm, _frame(table), t, new)
        assert any(isinstance(x, tuple) and x[0] == "dummy"
                   for x in tmap.values())
        assert tmap == jmap
        assert _model(tm) == _model(jm)

    def test_dummy_pickup_pinned_to_carrier(self):
        """Departure from cuopt_tpu (ROADMAP Queue 3): Depot and Break
        rows carry route 0, and cuopt_tpu's partial-pair lookup
        (cuopt_tpu/routing/re_routing.py:110) takes the first row with
        route == p, so a partly served pair whose pickup is order 0 is
        pinned to the vehicle of the table's first Depot row. The port
        searches order rows only: vehicle 1 carries order 0 here."""
        rows = [
            (0, 0.0, 0, 0, "Depot"), (2, 6.0, 0, 3, "Pickup"),
            (3, 9.0, 0, 4, "Delivery"), (0, 18.0, 0, 0, "Depot"),
            (0, 0.0, 1, 0, "Depot"), (0, 2.0, 1, 1, "Pickup"),
            (1, 5.0, 1, 2, "Delivery"), (0, 10.0, 1, 0, "Depot"),
        ]
        (tm, tmap), (jm, jmap) = _rerouted_pair(RouteTable(rows), 3.5)
        assert tmap == jmap and tmap[0] == ("dummy", 0)
        assert tm.order_vehicle_match[0].tolist() == [1]
        assert tm.order_locations[0] == 1  # where vehicle 1 stands
        assert jm.order_vehicle_match[0].tolist() == [0]
        assert jm.order_locations[0] == 0

    def test_equal_stamps_keep_route_order(self):
        """Rows with equal arrival stamps are replayed in table order (a
        stable sort): the vehicle resumes at the later row's order."""
        rows = [
            (0, 0.0, 0, 0, "Depot"), (0, 2.0, 0, 1, "Pickup"),
            (2, 2.0, 0, 3, "Pickup"), (1, 8.0, 0, 2, "Delivery"),
            (3, 9.0, 0, 4, "Delivery"), (0, 18.0, 0, 0, "Depot"),
        ]
        tm, _ = T.construct_rerouting_model(
            base_model(T), RouteTable(rows), 2.5, None)
        assert tm.vehicle_start.tolist() == [3, 0]
        tm, _ = T.construct_rerouting_model(
            base_model(T), RouteTable([rows[0], rows[2], rows[1]]
                                      + rows[3:]), 2.5, None)
        assert tm.vehicle_start.tolist() == [1, 0]


def test_pinned_orders_inserted_first():
    """Departure from cuopt_tpu (ROADMAP Queue 3): the port's cheapest
    insertion takes the orders with the fewest allowed vehicles first. On
    the model re-routed at 0.3 of the 60-order plan, cuopt_tpu fills a
    carrier with cheaper orders before its pinned pair and leaves the
    pair unassigned; the port places every order. Both re-routed models
    are equal (test_gh60_pd_equal)."""
    from cuopt_tpu.routing.construction import cheapest_insertion as j_ci

    table, tdm, jdm = gh60_pd_table()
    t = 0.3 * float(table["arrival_stamp"].max())
    tm, tmap = T.construct_rerouting_model(tdm, table, t, None)
    jm, _ = J.construct_rerouting_model(jdm, _frame(table), t, None)
    tp = t_build(tm)
    routes, unassigned = cheapest_insertion(tp)
    assert unassigned == []
    for v, r in routes.items():
        assert not r or tp.route_feasible(v, r)
    jp = j_build(jm)
    left = sorted(int(jp.serve_orders[o]) for o in j_ci(jp)[1])
    # cuopt_tpu's left-out pair is a dummy pickup and its delivery, both
    # pinned to the carrier
    assert len(left) == 2 and tmap[left[0]][0] == "dummy"
    assert all(k in jm.order_vehicle_match for k in left)


def test_pd_capacity_holds_carried_load():
    """Departure from cuopt_tpu (ROADMAP "Deliberate departures"): the
    port's route_feasible holds the load carried after each stop to the
    capacity, so a route carrying two full pairs at once (twice the
    capacity between the pickups and the deliveries) fails. cuopt_tpu
    holds the route's summed demand, which for pairs is the net load,
    and still accepts it."""
    def model(R):
        dm = base_model(R)
        dm.capacity_dimensions.clear()
        dm.add_capacity_dimension("demand", [10, -10, 10, -10], [10, 10])
        return dm

    route = [0, 2, 1, 3]  # both pickups, then both deliveries
    tp, jp = t_build(model(T)), j_build(model(J))
    assert np.cumsum(tp.demand[0, route]).max() == 20.0
    assert not tp.route_feasible(0, route) and jp.route_feasible(0, route)
    assert tp.route_feasible(0, [0, 1, 2, 3])


class TestReRoutingSolve:
    """tests/test_routing_extras.py:81-131 on the port's own Solve."""

    def test_rerouting_drops_fulfilled_orders(self):
        dm = base_model(T)
        sol = solve(dm)
        assert sol.get_status() == T.SolutionStatus.SUCCESS.value
        table = sol.get_route()
        t_end = float(table["arrival_stamp"].max()) + 10
        _, order_map = T.construct_rerouting_model(dm, table, t_end, None)
        assert order_map == {}

    def test_rerouting_preserves_uninitiated_and_new(self):
        dm = base_model(T)
        table = solve(dm).get_route()
        new_dm, order_map = T.construct_rerouting_model(
            dm, table, 0.5, NEW_PAIR)
        assert ("new", 0) in order_map.values()
        assert ("new", 1) in order_map.values()
        sol2 = solve(new_dm)
        assert sol2.get_status() == T.SolutionStatus.SUCCESS.value
        served = table_orders(sol2.get_route())
        assert sorted(served) == list(range(len(order_map)))

    def test_rerouting_partial_creates_dummy_pickup(self):
        dm = base_model(T)
        table = solve(dm).get_route()
        order = np.asarray(table["type"]) != "Depot"
        picks = order & np.isin(table["route"], [0, 2])
        first = np.flatnonzero(picks)[
            np.argmin(table["arrival_stamp"][picks])]
        t = float(table["arrival_stamp"][first]) + 1.0 + 1e-6
        new_dm, order_map = T.construct_rerouting_model(dm, table, t, None)
        dummies = [k for k, x in order_map.items()
                   if isinstance(x, tuple) and x[0] == "dummy"]
        assert dummies
        sol2 = solve(new_dm)
        assert sol2.get_status() == T.SolutionStatus.SUCCESS.value
        new_table = sol2.get_route()
        for k in dummies:
            veh = int(new_dm.order_vehicle_match[k][0])
            on = new_table["truck_id"][
                (new_table["route"] == k)
                & (np.asarray(new_table["type"]) == "Pickup")]
            assert on.tolist() == [veh]


def table_orders(table):
    kind = np.asarray(table["type"])
    return table["route"][(kind != "Depot") & (kind != "Break")].tolist()


# ---------------------------------------------------------- objectives
def _two_metric_instance(R):
    """tests/test_routing_objectives.py:15: the COST matrix prefers one
    tour, the TIME matrix another."""
    n = 5
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (n, 2))
    dist = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1))
    cost = dist.copy()
    time = dist.max() - dist
    np.fill_diagonal(time, 0.0)
    dm = R.DataModel(n, 1, n)
    dm.add_cost_matrix(cost)
    dm.add_transit_time_matrix(time)
    return dm, cost, time


def _locs(sol):
    return sol.get_route()["location"].tolist()


def _arc_sum(mat, locs):
    return float(sum(mat[a, b] for a, b in zip(locs, locs[1:])))


def test_objective_weights_change_optimized_quantity():
    dm, cost, time = _two_metric_instance(T)
    dm.set_objective_function([T.Objective.COST], [1.0])
    locs_c = _locs(solve(dm))
    dm2, _, _ = _two_metric_instance(T)
    dm2.set_objective_function([T.Objective.TRAVEL_TIME], [1.0])
    locs_t = _locs(solve(dm2))
    assert _arc_sum(cost, locs_c) <= _arc_sum(cost, locs_t) + 1e-6
    assert _arc_sum(time, locs_t) <= _arc_sum(time, locs_c) + 1e-6
    assert _arc_sum(cost, locs_c) < _arc_sum(cost, locs_t) - 1e-6 or \
        _arc_sum(time, locs_t) < _arc_sum(time, locs_c) - 1e-6


def test_objective_values_reported_per_objective():
    dm, cost, time = _two_metric_instance(T)
    dm.set_objective_function(
        [T.Objective.COST, T.Objective.TRAVEL_TIME], [1.0, 0.5])
    sol = solve(dm)
    vals = sol.get_objective_values()
    assert T.Objective.COST in vals and T.Objective.TRAVEL_TIME in vals
    locs = _locs(sol)
    np.testing.assert_allclose(vals[T.Objective.COST], _arc_sum(cost, locs),
                               rtol=1e-6)
    # one vehicle leaving at 0: its travel time is the tour's time
    np.testing.assert_allclose(vals[T.Objective.TRAVEL_TIME],
                               _arc_sum(time, locs), rtol=1e-6)


ALL_OBJECTIVES = ([0, 1, 2, 3, 5], [1.0, 0.3, 2.0, 0.01, 1.0])


@pytest.mark.parametrize("variant", ["tw", "prizes", "hetero"])
def test_objective_values_of_fixed_routes_equal(variant):
    """The same routes assembled by both packages: per-objective values
    and the total within 1e-9 relative, and the same route rows."""
    ids, weights = ALL_OBJECTIVES
    tdm, jdm = gh60(t_vrp, variant)[1], gh60(j_vrp, variant)[1]
    for dm, R in ((tdm, T), (jdm, J)):
        dm.set_objective_function([R.Objective(i) for i in ids], weights)
        if variant == "tw":
            dm.set_vehicle_fixed_costs(np.linspace(0.0, 40.0, dm.n_fleet))
    tp, jp = t_build(tdm), j_build(jdm)
    routes, unassigned = cheapest_insertion(tp)
    if variant == "prizes":  # leave orders unserved: prizes are lost
        drop = [o for r in routes.values() for o in r[:1]]
        routes = {v: [o for o in r if o not in drop]
                  for v, r in routes.items()}
        unassigned = sorted(set(unassigned) | set(drop))
    a = TS._build_assignment(tp, routes, unassigned, TTimer(10.0), tdm)
    b = JS._build_assignment(jp, routes, unassigned, JTimer(10.0), jdm)
    va, vb = a.get_objective_values(), b.get_objective_values()
    assert sorted(map(int, va)) == sorted(map(int, vb))
    assert len(va) >= 4
    for k in va:
        np.testing.assert_allclose(va[k], vb[T.Objective(int(k))],
                                   rtol=1e-9, atol=0)
    np.testing.assert_allclose(a.get_total_objective(),
                               b.get_total_objective(), rtol=1e-9, atol=0)
    assert a.get_route().rows() == list(
        b.get_route().itertuples(index=False, name=None))


# ---------------------------------------------------------- precedence
def _precedence_instance(R=T):
    """tests/test_routing_objectives.py:79: 6 seeded points, 2 vehicles."""
    n = 6
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (n, 2))
    dist = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1))
    dm = R.DataModel(n, 2, n)
    dm.add_cost_matrix(dist)
    return dm


def _copy_routes(routes):
    return {v: list(r) for v, r in routes.items()}


def _arrivals(sol):
    table = sol.get_route()
    kind = np.asarray(table["type"])
    served = (kind == "Delivery") | (kind == "Pickup")
    return dict(zip(table["route"][served].tolist(),
                    table["arrival_stamp"][served].tolist()))


class TestPrecedence:
    def test_precedence_enforced_in_solution(self):
        dm = _precedence_instance()
        dm.add_order_precedence(5, [1, 2])
        arr = _arrivals(solve(dm))
        assert 5 in arr and 1 in arr and 2 in arr
        assert arr[5] >= arr[1] - 1e-9
        assert arr[5] >= arr[2] - 1e-9

    def test_chain_precedence(self):
        dm = _precedence_instance()
        dm.add_order_precedence(3, [2])
        dm.add_order_precedence(2, [1])
        arr = _arrivals(solve(dm))
        assert arr[2] >= arr[1] - 1e-9
        assert arr[3] >= arr[2] - 1e-9

    def test_last_repair_round_pulls_successors(self):
        """Repair (ROADMAP Queue 3): the last round of
        _enforce_precedence pulls the violators without reinserting them,
        and cuopt_tpu returns their served successors without their
        predecessor. Chain 1 -> 2 -> 3 with 2 served before 1, one round:
        the port pulls 3 as well and every link holds."""
        from cuopt_torch.routing.internal import precedence_ok
        from cuopt_tpu.routing.solver import (
            _enforce_precedence as j_enforce,
        )

        def model(R):
            dm = _precedence_instance(R)
            dm.add_order_precedence(2, [1])
            dm.add_order_precedence(3, [2])
            return dm

        tp, jp = t_build(model(T)), j_build(model(J))
        sid = {int(o): i for i, o in enumerate(tp.serve_orders)}
        routes = {0: [sid[2], sid[1], sid[3]], 1: []}
        rt, ut = TS._enforce_precedence(
            tp, _copy_routes(routes), [], np.random.default_rng(0),
            max_rounds=1)
        rj, uj = j_enforce(jp, _copy_routes(routes), [],
                           np.random.default_rng(0), max_rounds=1)
        assert precedence_ok(tp, rt)
        assert sorted(ut) == [sid[2], sid[3]] and rt[0] == [sid[1]]
        assert sorted(uj) == [sid[2]] and rj[0] == [sid[1], sid[3]]

    def test_cycle_moves_keep_precedence(self, monkeypatch):
        """Repair (ROADMAP Queue 3): the local search's cycle and HVRP
        moves do not check precedence, and when the routes after them
        broke a link, cuopt_tpu's _local_search stopped and returned those
        routes. Here the exchange-cycle search is replaced by one that
        swaps orders 1 and 2 of the chain 1 -> 2: the port returns routes
        that keep the link."""
        import cuopt_torch.routing.cycle_finder as TF
        import cuopt_torch.routing.local_search as TL
        from cuopt_torch.routing.internal import precedence_ok

        dm = _precedence_instance()
        dm.add_order_precedence(2, [1])
        prob = t_build(dm)
        lsp = TL.build_ls_problem(prob, device="cpu")
        start, unassigned = cheapest_insertion(prob)
        assert unassigned == [] and precedence_ok(prob, start)
        sid = {int(o): i for i, o in enumerate(prob.serve_orders)}
        swap = {sid[1]: sid[2], sid[2]: sid[1]}

        def swapping(prob, lsp, routes, max_cycles=5):
            return {v: [swap.get(o, o) for o in r]
                    for v, r in routes.items()}, True

        monkeypatch.setattr(TF, "cycle_search", swapping)
        out = TS._local_search(prob, lsp, _copy_routes(start), TTimer(5.0))
        assert precedence_ok(prob, out)
        assert sorted(o for r in out.values() for o in r) == \
            sorted(o for r in start.values() for o in r)

    @staticmethod
    def _late_successor(R=T):
        """Four orders on a line (depot 0; A at 10, B at -10, D at -11, S
        at 11), two vehicles of capacity 10, demand 5 each, S due by 15
        and after A. Cheapest insertion puts B, A on vehicle 0 (A at 30)
        and D on vehicle 1, so S has no slot; the local search's first
        move takes B to vehicle 1, and A at 10 leaves S the slot after
        it. cuopt_tpu leaves S unserved unless a later recombination
        happens to reinsert it."""
        x = np.array([0.0, 10, -10, -11, 11])
        cost = np.abs(x[:, None] - x[None])
        dm = R.DataModel(5, 2, 4)
        dm.add_cost_matrix(cost)
        dm.add_transit_time_matrix(cost)
        dm.set_order_locations([1, 2, 3, 4])
        dm.add_capacity_dimension("w", [5, 5, 5, 5], [10, 10])
        dm.set_order_time_windows([0, 0, 0, 0], [1000, 1000, 1000, 15])
        dm.add_order_precedence(3, [0])
        return dm

    def test_unserved_successor_reinserted(self):
        """Repair (ROADMAP Queue 3): construction leaves S out, the local
        search opens a slot, and _reinsert_successors puts S at its
        cheapest feasible place (after A on vehicle 0); every link
        holds."""
        import cuopt_torch.routing.local_search as TL
        from cuopt_torch.routing.internal import precedence_ok

        prob = t_build(self._late_successor())
        routes, left = cheapest_insertion(prob)
        assert routes == {0: [1, 0], 1: [2]} and left == [3]
        lsp = TL.build_ls_problem(prob, device="cpu")
        routes = TS._local_search(prob, lsp, routes, TTimer(5.0),
                                  unserved=left)
        assert routes == {0: [0], 1: [1, 2]}
        out, left2 = TS._reinsert_successors(prob, routes, left,
                                              TTimer(5.0))
        assert out == {0: [0, 3], 1: [1, 2]} and left2 == []
        assert precedence_ok(prob, out)
        assert all(prob.route_feasible(v, r) for v, r in out.items())

    def test_solve_serves_the_successor(self, monkeypatch):
        """Solve on the same instance, its recombinations stubbed to hand
        back their first parent, so that only construction, the local
        search, GES and the repair step serve orders: S is served and
        precedence_ok holds (without the repair step S stays out)."""
        import cuopt_torch.routing.diversity as TD
        from cuopt_torch.routing.internal import precedence_ok

        def parent(prob, pa, *args, **kw):
            return ({v: list(r) for v, r in pa["routes"].items()},
                    list(pa["unassigned"]))

        for name in ("srex", "ruin_recreate", "ox_single_route"):
            monkeypatch.setattr(TD, name, parent)
        monkeypatch.setattr(TD, "set_covering_child",
                            lambda prob, members, rng: parent(
                                prob, members[0]))
        dm = self._late_successor()
        sol = solve(dm, 1.0)
        assert sol.get_status() == T.SolutionStatus.SUCCESS.value
        assert sol.get_infeasible_orders() == []
        arr = _arrivals(sol)
        assert sorted(arr) == [0, 1, 2, 3] and arr[3] >= arr[0] - 1e-9
        prob = t_build(dm)
        table = sol.get_route()
        routes = {}
        for v, o, kind in zip(table["truck_id"], table["route"],
                              table["type"]):
            if kind != "Depot":
                routes.setdefault(int(v), []).append(int(o))
        assert precedence_ok(prob, routes)

    @pytest.mark.parametrize("seed", range(4))
    def test_reinsertion_breaks_no_link(self, seed):
        """Seeded chains of three on GH60 (with its windows): from
        cheapest insertion's routes, repaired and searched as Solve does
        first, the repair step serves what it can; every link holds,
        every route is feasible, and each order is served once or listed
        unserved."""
        import cuopt_torch.routing.local_search as TL
        from cuopt_torch.routing.internal import precedence_ok

        inst, dm = gh60(t_vrp, "tw")
        rng = np.random.default_rng(seed)
        for a, b, c in rng.choice(60, (8, 3), replace=False):
            a, b, c = sorted((a, b, c),
                             key=lambda o: (inst.tw_early[o + 1], o))
            dm.add_order_precedence(int(b), [int(a)])
            dm.add_order_precedence(int(c), [int(b)])
        prob = t_build(dm)
        routes, left = TS._enforce_precedence(
            prob, *cheapest_insertion(prob), np.random.default_rng(seed))
        lsp = TL.build_ls_problem(prob, device="cpu")
        routes = TS._local_search(prob, lsp, routes, TTimer(3.0),
                                  unserved=left)
        assert precedence_ok(prob, routes, left) and left
        out, left2 = TS._reinsert_successors(prob, routes, left,
                                              TTimer(5.0))
        assert set(left2) <= set(left)
        assert precedence_ok(prob, out, left2)
        assert all(prob.route_feasible(v, r) for v, r in out.items() if r)
        served = sorted(o for r in out.values() for o in r)
        assert sorted(served + left2) == list(range(prob.n_serve))

    @staticmethod
    def _chains(seed):
        """GH60 with its windows and eight seeded chains of three, the
        problem and cheapest insertion's routes."""
        inst, dm = gh60(t_vrp, "tw")
        rng = np.random.default_rng(seed)
        for a, b, c in rng.choice(60, (8, 3), replace=False):
            a, b, c = sorted((a, b, c),
                             key=lambda o: (inst.tw_early[o + 1], o))
            dm.add_order_precedence(int(b), [int(a)])
            dm.add_order_precedence(int(c), [int(b)])
        prob = t_build(dm)
        return prob, cheapest_insertion(prob)[0]

    @pytest.mark.parametrize("seed", range(2))
    def test_reinsert_memo_changes_nothing(self, seed, monkeypatch):
        """greedy_reinsert (ruin & recreate, with noise) gives the same
        routes with its scan memo as without; a second call on the same
        routes reads every scan from the memo (no route_feasible call),
        and a changed route is scanned again."""
        from cuopt_torch.routing import construction as TC

        prob, routes = self._chains(seed)
        served = [o for r in routes.values() for o in r]
        removed = [int(o) for o in np.random.default_rng(seed).choice(
            served, 12, replace=False)]
        ruined = {v: [o for o in r if o not in removed]
                  for v, r in routes.items()}

        def run(memo):
            return TC.greedy_reinsert(
                prob, {v: list(r) for v, r in ruined.items()}, removed,
                np.random.default_rng(seed), memo=memo)

        memo = {}
        plain = run(None)
        assert run(memo) == plain and memo
        calls = []
        feasible = prob.route_feasible
        monkeypatch.setattr(prob, "route_feasible",
                            lambda v, r: calls.append(v) or feasible(v, r))
        assert run(memo) == plain and calls == []
        v = next(v for v, r in ruined.items() if r)
        ruined[v] = ruined[v][1:]
        run(memo)
        assert calls

    def test_reinsert_stops_on_its_timer(self):
        """With its timer expired, greedy_reinsert places nothing: every
        removed order comes back left out."""
        from cuopt_torch.routing.construction import greedy_reinsert

        prob, routes = self._chains(0)
        removed = sorted(routes[0])
        ruined = {v: ([] if v == 0 else list(r)) for v, r in routes.items()}
        out, left = greedy_reinsert(prob, ruined, removed, noise=0.0,
                                    timer=TTimer(0.0))
        assert out == ruined and sorted(left) == removed

    def test_reinsert_keeps_an_unserved_predecessor_s_successor_out(self):
        """An order whose predecessor is not served stays out of
        greedy_reinsert (insert_precedence_ok passes over an unserved
        predecessor; precedence_ok does not): on _late_successor's
        routes without A, S is left out and every link holds."""
        from cuopt_torch.routing.construction import greedy_reinsert
        from cuopt_torch.routing.internal import precedence_ok

        prob = t_build(self._late_successor())
        out, left = greedy_reinsert(prob, {0: [], 1: [1, 2]}, [3],
                                    noise=0.0)
        assert out == {0: [], 1: [1, 2]} and left == [3]
        assert precedence_ok(prob, out)
        out, left = greedy_reinsert(prob, {0: [0], 1: [1, 2]}, [3],
                                    noise=0.0)
        assert out == {0: [0, 3], 1: [1, 2]} and left == []

    def test_circular_precedence_rejected(self):
        dm = _precedence_instance()
        dm.add_order_precedence(1, [2])
        dm.add_order_precedence(2, [1])
        with pytest.raises(ValidationError):
            dm.validate()

    def test_bad_ids_rejected(self):
        dm = _precedence_instance()
        with pytest.raises(ValidationError):
            dm.add_order_precedence(99, [1])
        with pytest.raises(ValidationError):
            dm.add_order_precedence(1, [1])


# ------------------------------------------- vehicle starts and breaks
def test_vehicle_start_locations():
    """tests/test_routing.py:184."""
    n = 4
    dm = T.DataModel(n, 1)
    dm.add_cost_matrix(np.ones((n, n)) - np.eye(n))
    dm.set_vehicle_locations([2], [2])
    locs = _locs(solve(dm))
    assert locs[0] == 2 and locs[-1] == 2


def test_vehicle_break_with_locations():
    """tests/test_routing.py:251: the break is taken at location 3."""
    n = 4
    dm = T.DataModel(n, 1, n_orders=2)
    dm.add_cost_matrix(np.ones((n, n)) - np.eye(n))
    dm.set_order_locations([1, 2])
    dm.add_vehicle_break(0, 0.0, 1.0, 2.0, locations=[3])
    sol = solve(dm)
    assert sol.get_status() == T.SolutionStatus.SUCCESS.value
    table = sol.get_route()
    brk = np.asarray(table["type"]) == "Break"
    assert table["location"][brk].tolist() == [3]


def _early_break(R):
    """tests/test_routing_extras.py:133: the break must start in [0, 12],
    before the drive to the one customer (window [30, 40])."""
    mat = np.array([[0.0, 10.0], [10.0, 0.0]])
    dm = R.DataModel(2, 1, 1)
    dm.add_cost_matrix(mat)
    dm.add_transit_time_matrix(mat)
    dm.set_order_locations(np.array([1], np.int32))
    dm.set_order_time_windows(np.array([30.0]), np.array([40.0]))
    dm.set_order_service_times(np.array([5.0]))
    dm.set_vehicle_time_windows(np.array([0.0]), np.array([200.0]))
    dm.add_vehicle_break(0, earliest=0.0, latest=12.0, duration=5.0)
    return dm


def test_exact_break_placement_beats_greedy():
    tp, jp = t_build(_early_break(T)), j_build(_early_break(J))
    plan = tp.route_plan(0, [0])
    assert plan["time_ok"], plan
    assert len(plan["breaks"]) == 1
    assert plan["breaks"][0]["start"] <= 12.0 + 1e-9
    assert tp.route_feasible(0, [0])
    ref = jp.route_plan(0, [0])
    assert plan["breaks"] == ref["breaks"]
    assert plan["arrivals"].tolist() == np.asarray(ref["arrivals"]).tolist()
    assert (plan["cost"], plan["end_time"]) == (ref["cost"], ref["end_time"])
    sol = solve(_early_break(T))
    assert sol.get_status() == T.SolutionStatus.SUCCESS.value
    table = sol.get_route()
    brk = np.asarray(table["type"]) == "Break"
    assert table["arrival_stamp"][brk].tolist()[0] <= 12.0 + 1e-9


# ------------------------------------------------- generated instances
def test_generated_instances_solve():
    """tests/test_routing_extras.py:25-43: a generated CVRPTW solves with
    every order served, and a generated pickup-delivery model solves."""
    dm = T.generate_dataset(T.DatasetParams(
        n_locations=20, fleet_size=4, tw_tightness=0.3, seed=3))
    sol = solve(dm, 3.0)
    assert sol.get_status() == T.SolutionStatus.SUCCESS.value
    assert len(set(table_orders(sol.get_route()))) == 19
    dm = T.generate_dataset(T.DatasetParams(
        n_locations=11, fleet_size=3, pickup_delivery=True, seed=4))
    assert dm.pickup_indices is not None
    assert solve(dm, 3.0).get_status() == T.SolutionStatus.SUCCESS.value


def test_solve_small_solomon():
    """tests/test_vrp_io.py:102: the three-customer Solomon text, parsed
    by the port and solved, fits one or two vehicles."""
    from test_vrp_io import SOLOMON

    inst = t_vrp.parse_solomon(SOLOMON)
    sol = solve(inst.to_data_model(), 3.0)
    assert sol.get_status() == 0, sol.get_message()
    cost, used = t_vrp.solution_cost(inst, sol)
    assert cost > 0 and 1 <= used <= 2


def test_route_structure():
    """tests/test_routing.py:56: the table's columns, and every location
    but the depot served once."""
    cost = np.array([[0, 1, 5, 2], [2, 0, 7, 4], [1, 5, 0, 9],
                     [5, 6, 2, 0]], float)
    dm = T.DataModel(4, 2)
    dm.add_cost_matrix(cost)
    table = solve(dm).get_route()
    assert set(table.columns) == set(ROUTE_COLUMNS)
    assert sorted(table["location"][table["route"] != 0].tolist()) == \
        [1, 2, 3]
