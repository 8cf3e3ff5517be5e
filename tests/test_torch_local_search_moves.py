"""cuopt_torch's move evaluator and the moves it drives, on the cases of
tests/test_local_search_moves.py (the port on the CPU): the best scored
move predicts the host's cost change and keeps its routes feasible,
2-opt* untangles crossed tails, a route merge past the padded width
solves, a full pair of routes proposes no infeasible move, and the paired
relocate improves a bad pickup-delivery start to cuopt_tpu's routes.
test_torch_local_search.py holds the evaluators' scores against
cuopt_tpu's."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import test_local_search_moves as M  # noqa: E402
from cuopt_torch.routing import DataModel, SolverSettings, Solve  # noqa: E402
from cuopt_torch.routing.internal import build_problem  # noqa: E402
from cuopt_torch.routing.local_search import (  # noqa: E402
    build_ls_problem,
    evaluate_moves,
)
from cuopt_torch.routing.solver import (  # noqa: E402
    _apply_move,
    _pdp_pair_improve,
    _routes_to_arrays,
)
from cuopt_torch.utils.timer import Timer  # noqa: E402

torch.set_num_threads(1)


def random_instance(rng, n_loc=9, fleet=3, tw=False):
    """tests/test_local_search_moves.py:23, the port's DataModel."""
    pts = rng.uniform(0, 100, (n_loc, 2))
    cost = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    dm = DataModel(n_loc, fleet, n_loc - 1)
    dm.add_cost_matrix(cost)
    dm.set_order_locations(np.arange(1, n_loc))
    demand = rng.integers(1, 4, n_loc - 1)
    dm.add_capacity_dimension("w", demand, np.full(fleet, 12))
    if tw:
        dm.add_transit_time_matrix(cost)
        early = rng.uniform(0, 50, n_loc - 1)
        late = early + rng.uniform(150, 400, n_loc - 1)
        dm.set_order_time_windows(early, late)
        dm.set_order_service_times(np.full(n_loc - 1, 2.0))
    return dm


def _best(prob, routes, L_pad=8):
    lsp = build_ls_problem(prob, device="cpu")
    R, lens = _routes_to_arrays(prob, routes, L_pad)
    delta, kind, mv = evaluate_moves(lsp, R, lens)
    return float(delta), int(kind), [int(x) for x in mv]


@pytest.mark.parametrize("tw", [False, True])
def test_best_move_delta_matches_host(tw):
    rng = np.random.default_rng(42 if tw else 7)
    n_checked = 0
    for trial in range(6):
        prob = build_problem(random_instance(rng, tw=tw))
        routes = M.random_routes(rng, prob)
        if not all(prob.route_feasible(v, r) for v, r in routes.items()):
            continue
        L_pad = max(8, max(len(r) for r in routes.values()) + 4)
        delta, kind, mv = _best(prob, routes, L_pad)
        if delta >= -1e-7:
            continue
        new_routes = _apply_move({v: list(r) for v, r in routes.items()},
                                 kind, mv)
        change = prob.solution_cost(new_routes) - prob.solution_cost(routes)
        assert change == pytest.approx(delta, abs=1e-3)
        for v in (mv[0], mv[2]):
            assert prob.route_feasible(v, new_routes[v])
        n_checked += 1
    assert n_checked >= 3


def test_two_opt_star_descends_to_uncrossed_tails():
    x = np.array([0.0, 1.0, 2.0, 101.0, 102.0])
    dm = DataModel(5, 2, 4)
    dm.add_cost_matrix(np.abs(x[:, None] - x[None]))
    dm.set_order_locations([1, 2, 3, 4])
    prob = build_problem(dm)
    routes = {0: [0, 2], 1: [1, 3]}  # both routes go near, then far
    for _ in range(12):
        delta, kind, mv = _best(prob, routes)
        if delta >= -1e-7:
            break
        routes = _apply_move(routes, kind, mv)
    assert prob.solution_cost(routes) == pytest.approx(204.0, abs=1e-6)


def test_route_merge_does_not_overflow_padding():
    x = np.concatenate([[0.0], np.arange(1.0, 13.0)])
    dm = DataModel(13, 2, 12)
    dm.add_cost_matrix(np.abs(x[:, None] - x[None]))
    dm.set_order_locations(np.arange(1, 13))
    dm.set_vehicle_fixed_costs(np.array([100.0, 100.0]))
    s = SolverSettings()
    s.time_limit = 4.0
    sol = Solve(dm, s, device="cpu")  # must not raise
    assert sol.get_status() == 0
    assert sol.get_total_objective() <= 224.0 + 1e-6


def test_or_opt_moves_adjacent_pair_together():
    x = np.array([0.0, 50.0, 51.0, 1.0, 2.0])
    dm = DataModel(5, 2, 4)
    dm.add_cost_matrix(np.abs(x[:, None] - x[None]))
    dm.set_order_locations([1, 2, 3, 4])
    dm.add_capacity_dimension("w", np.array([1, 1, 1, 1]), np.array([2, 2]))
    prob = build_problem(dm)
    routes = {0: [0, 1], 1: [2, 3]}
    delta, kind, mv = _best(prob, routes)
    if delta < -1e-7:
        new_routes = _apply_move({v: list(r) for v, r in routes.items()},
                                 kind, mv)
        for v in (mv[0], mv[2]):
            assert prob.route_feasible(v, new_routes[v])


def _bad_pdp(R):
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 100, (17, 2))
    cost = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    dm = R.DataModel(17, 4, n_orders=16)
    dm.add_cost_matrix(cost)
    dm.add_transit_time_matrix(cost)
    dm.set_order_locations(list(range(1, 17)))
    dm.set_pickup_delivery_pairs(list(range(0, 16, 2)),
                                 list(range(1, 16, 2)))
    return dm


def test_pdp_pair_relocate_matches():
    import cuopt_tpu.routing as J
    from cuopt_tpu.routing.internal import build_problem as j_build
    from cuopt_tpu.routing.solver import _pdp_pair_improve as j_improve
    from cuopt_tpu.utils.timer import Timer as JTimer

    import cuopt_torch.routing as T

    tp, jp = build_problem(_bad_pdp(T)), j_build(_bad_pdp(J))
    routes = {v: [] for v in range(4)}
    for k, (p, d) in enumerate(zip(range(0, 16, 2), range(1, 16, 2))):
        routes[k % 4] += [p, d]
    base = sum(tp.route_cost(v, r) for v, r in routes.items() if r)
    a = _pdp_pair_improve(tp, {v: list(r) for v, r in routes.items()},
                          Timer(30.0))
    b = j_improve(jp, {v: list(r) for v, r in routes.items()},
                  JTimer(30.0))
    assert a == b and a[1]
    assert sum(tp.route_cost(v, r) for v, r in a[0].items() if r) < \
        base - 1e-6
    for r in a[0].values():
        for p, d in zip(range(0, 16, 2), range(1, 16, 2)):
            if p in r:
                assert d in r and r.index(p) < r.index(d)
