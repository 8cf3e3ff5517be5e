"""cuopt_torch's GES route minimization, population and prize logic
against cuopt_tpu's, on the CPU: the cases of tests/test_routing_ges.py.

`feasible_insertions`, the population's order and dedup, SREX, the prize
filter and the lexicographic ejection search are deterministic: both
packages must give equal results. `minimize_routes` and `Solve` run on a
time budget, so they are held to the JAX tests' properties; the local
search's prize moves (scored on the device) to equal routes.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.routing as T  # noqa: E402
import cuopt_torch.routing.diversity as TD  # noqa: E402
import cuopt_torch.routing.ges as TG  # noqa: E402
import cuopt_torch.routing.local_search as TL  # noqa: E402
import cuopt_torch.routing.solver as TS  # noqa: E402
import cuopt_tpu.routing as J  # noqa: E402
import cuopt_tpu.routing.diversity as JD  # noqa: E402
import cuopt_tpu.routing.ges as JG  # noqa: E402
import cuopt_tpu.routing.local_search as JL  # noqa: E402
import cuopt_tpu.routing.solver as JS  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_torch.utils.timer import Timer as TTimer  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402

torch.set_num_threads(1)


def grid_model(R, n_loc=10, n_fleet=4, capacity=100, fixed_cost=0.0,
               seed=0):
    """tests/test_routing_ges.py:22: seeded points, the depot at (50, 50),
    unit demands."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, size=(n_loc, 2))
    pts[0] = (50, 50)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=2)
    dm = R.DataModel(n_loc, n_fleet)
    dm.add_cost_matrix(d)
    demand = np.ones(n_loc, np.int32)
    demand[0] = 0
    dm.add_capacity_dimension(
        "w", demand, np.full(n_fleet, capacity, np.int32))
    if fixed_cost:
        dm.set_vehicle_fixed_costs(np.full(n_fleet, fixed_cost))
    return dm


def both(make, **kw):
    return t_build(make(T, **kw)), j_build(make(J, **kw))


def test_ges_eliminates_routes_with_fixed_costs():
    tp, _ = both(grid_model, n_loc=12, n_fleet=6, fixed_cost=500.0)
    orders = list(range(tp.n_serve))
    routes = {v: [] for v in range(tp.n_fleet)}
    for i, o in enumerate(orders):
        routes[i % tp.n_fleet].append(o)
    out = TG.minimize_routes(tp, routes, TTimer(10.0),
                             np.random.default_rng(0), budget_s=5.0)
    assert sorted(o for r in out.values() for o in r) == orders
    assert sum(1 for r in out.values() if r) <= 2


def test_feasible_insertions_equal():
    tp, jp = both(grid_model, n_loc=6, n_fleet=2, capacity=2)
    routes = {0: [0, 1], 1: []}
    a = TG.feasible_insertions(tp, routes, 2)
    assert a == JG.feasible_insertions(jp, routes, 2)
    assert a and all(v == 1 for _, v, _ in a)  # vehicle 0 is full


def test_population_orders_and_dedups():
    tp, jp = both(grid_model, n_loc=8, n_fleet=3)
    r1 = {0: list(range(tp.n_serve)), 1: [], 2: []}
    r2 = {0: list(reversed(range(tp.n_serve))), 1: [], 2: []}
    pops = []
    for M, prob in ((TD, tp), (JD, jp)):
        pop = M.RoutingPopulation(max_size=4)
        assert pop.add(prob, r1, [])
        assert not pop.add(prob, r1, [])  # duplicate rejected
        pop.add(prob, r2, [])
        assert pop.best["cost"] == min(m["cost"] for m in pop.members)
        pops.append(pop)
    assert [m["cost"] for m in pops[0].members] == \
        [m["cost"] for m in pops[1].members]
    assert TD.solution_distance(r1, r2) == JD.solution_distance(r1, r2)
    assert 0.0 <= TD.solution_distance(r1, r2) <= 1.0


def test_srex_equal():
    tp, jp = both(grid_model, n_loc=10, n_fleet=4)
    n = tp.n_serve
    pa = dict(routes={0: list(range(n // 2)), 1: list(range(n // 2, n)),
                      2: [], 3: []}, unassigned=[])
    pb = dict(routes={0: [], 1: [], 2: list(range(0, n, 2)),
                      3: list(range(1, n, 2))}, unassigned=[])
    a = TD.srex(tp, pa, pb, np.random.default_rng(1))
    b = JD.srex(jp, pa, pb, np.random.default_rng(1))
    assert a[0] == b[0] and list(a[1]) == list(b[1])
    served = sorted(o for r in a[0].values() for o in r)
    assert sorted(served + list(a[1])) == list(range(n))
    assert len(set(served)) == len(served)


def far_prize_model(R, with_good=False):
    """tests/test_routing_ges.py:98 and :128: the order at location 2 is
    far for a small prize; with_good adds location 4, near, prize 50."""
    d = np.array([[0, 1, 100, 1, 2], [1, 0, 100, 1, 2],
                  [100, 100, 0, 100, 100], [1, 1, 100, 0, 2],
                  [2, 2, 100, 2, 0]], float)
    n = 5 if with_good else 4
    dm = R.DataModel(n, 1)
    dm.add_cost_matrix(d[:n, :n])
    dm.set_order_prizes(np.array([0.0, 5.0, 1.0, 5.0, 50.0][:n]))
    return dm


def test_prize_filter_equal():
    tp, jp = both(far_prize_model)
    routes = {0: list(range(tp.n_serve))}
    a = TD.prize_filter(tp, {0: list(routes[0])}, [])
    b = JD.prize_filter(jp, {0: list(routes[0])}, [])
    assert a[0] == b[0] and list(a[1]) == list(b[1])
    far = [i for i in range(tp.n_serve) if tp.order_loc[i] == 2]
    assert far and far[0] in a[1]


def test_solve_with_fixed_costs_uses_few_vehicles():
    s = T.SolverSettings()
    s.time_limit = 4.0
    sol = T.Solve(grid_model(T, n_loc=10, n_fleet=5, fixed_cost=200.0), s,
                  device="cpu")
    assert sol.get_status() == 0
    assert sol.get_vehicle_count() <= 2


def test_prize_moves_inside_local_search():
    """The local search alone drops the far order and picks the near
    one up, in both packages, to equal routes."""
    tp, jp = both(far_prize_model, with_good=True)
    far = [i for i in range(tp.n_serve) if tp.order_loc[i] == 2][0]
    good = [i for i in range(tp.n_serve) if tp.order_loc[i] == 4][0]
    start = [i for i in range(tp.n_serve) if i != good]

    def net(prob, routes, unserved):
        cost = sum(prob.route_cost(v, r) for v, r in routes.items() if r)
        return cost + sum(float(prob.prizes[o]) for o in unserved)

    t_un, j_un = [good], [good]
    before = net(tp, {0: start}, t_un)
    a = TS._local_search(tp, TL.build_ls_problem(tp, device="cpu"),
                         {0: list(start)}, TTimer(30), max_rounds=6,
                         unserved=t_un)
    b = JS._local_search(jp, JL.build_ls_problem(jp), {0: list(start)},
                         JTimer(30), max_rounds=6, unserved=j_un)
    assert a == b and sorted(t_un) == sorted(j_un)
    assert far in t_un and good in a[0]
    assert net(tp, a, t_un) < before - 50.0


def test_lexicographic_ejection_equal():
    """tests/test_routing_ges.py:172: serving the heavy pooled order
    needs the route's first and last orders ejected together."""
    def model(R):
        dm = R.DataModel(8, 1)
        dm.add_cost_matrix(np.ones((8, 8)) - np.eye(8))
        dm.add_capacity_dimension(
            "w", np.array([0, 5, 0, 0, 0, 0, 5, 10], float),
            np.array([10.0]))
        return dm

    tp, jp = both(model)
    dem = tp.demand[0]
    heavy = [i for i in range(tp.n_serve) if dem[i] == 5]
    zero = [i for i in range(tp.n_serve) if dem[i] == 0]
    big = [i for i in range(tp.n_serve) if dem[i] == 10][0]
    route = [heavy[0]] + zero + [heavy[1]]
    pen = np.ones(tp.n_serve)
    for k in (1, 3):
        a = TG._ejection_insertions(tp, {0: list(route)}, big, pen,
                                    nc_k_max=k)
        b = JG._ejection_insertions(jp, {0: list(route)}, big, pen,
                                    nc_k_max=k)
        assert a == b
    assert TG._ejection_insertions(tp, {0: list(route)}, big, pen,
                                   nc_k_max=1) is None
    _, v, new_r, ejected = a
    assert sorted(ejected) == sorted(heavy) and big in new_r
