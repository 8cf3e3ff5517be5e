"""The load a pickup-delivery route carries, held to the capacity after
every stop (a deliberate departure from cuopt_tpu, ROADMAP "Deliberate
departures"): `route_feasible` on the host and the move and insertion
scores on the device (here on the CPU), each against a plain host walk
of the carried load (`carried_ok`), not against cuopt_tpu, which holds a
route's summed (net) demand to the capacity and so accepts a route that
carries twice its capacity.
"""

import numpy as np
import pytest
import torch

import cuopt_torch.io.vrp as t_vrp
import cuopt_torch.routing.construction as TC
import cuopt_torch.routing.local_search as TL
import cuopt_torch.routing.solver as TS
from cuopt_torch.routing import SolutionStatus, SolverSettings, Solve
from cuopt_torch.routing.internal import build_problem as t_build
from torch_routing_instances import (
    GH60_VARIANTS,
    assert_reductions_are_the_host_s,
    carried_ok,
    gh60,
    host_move_scores,
    pd_mixed,
    random_routes,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
BIG = TL.BIG


def _pd_routes(prob, rng):
    """Random routes over a few vehicles, each pair on one route with its
    pickup first: only the capacity can make them infeasible."""
    F = min(prob.n_fleet, 4)
    routes = {v: [] for v in range(prob.n_fleet)}
    for o in rng.permutation(prob.n_serve):
        o = int(o)
        if prob.pd_sign[o] < 0:
            continue
        r = routes[int(rng.integers(F))]
        i = int(rng.integers(len(r) + 1))
        r.insert(i, o)
        if prob.pd_partner[o] >= 0:
            r.insert(int(rng.integers(i + 1, len(r) + 1)),
                     int(prob.pd_partner[o]))
    return routes


@pytest.mark.parametrize("seed", range(5))
def test_route_feasible_capacity_is_the_host_walk(seed):
    """Seeded routes on a small pickup-delivery instance without time
    windows, pairs kept in order: route_feasible's verdict is the host
    walk's, on every route, and both verdicts occur."""
    prob = pd_mixed(t_vrp, t_build, seed=seed)
    rng = np.random.default_rng(seed)
    verdicts = []
    for _ in range(40):
        for v, r in _pd_routes(prob, rng).items():
            if r:
                want = carried_ok(prob, v, r)
                assert prob.route_feasible(v, r) == want, (v, r)
                verdicts.append(want)
    assert any(verdicts) and not all(verdicts)


@pytest.mark.parametrize("variant", [v for v in GH60_VARIANTS if v != "pd"])
def test_without_pairs_the_total_decides(variant):
    """With no negative demand the largest load carried is the route's
    total, so without pairs route_feasible's verdict is the summed-demand
    check's on every route, and every instance without pairs keeps its
    routes bit for bit (the parity tests of test_torch_routing_solve.py
    run those instances unedited)."""
    prob = t_build(gh60(t_vrp, variant)[1])
    assert (prob.demand >= 0).all()
    rng = np.random.default_rng(3)
    for _ in range(20):
        for v, r in random_routes(rng, prob.n_serve, prob.n_fleet).items():
            if r:
                net = bool(np.all(prob.demand[:, r].sum(axis=1)
                                  <= prob.capacity[:, v] + 1e-9))
                assert carried_ok(prob, v, r) == net


def test_route_with_two_pickups_in_hand_rejected():
    """The route of tests/test_torch_routing_extras.py's departure test at
    GHC_200_1's width: every pickup of a vehicle's pairs first, then the
    deliveries, nets to zero but carries their sum."""
    prob = pd_mixed(t_vrp, t_build)
    p = [o for o in range(prob.n_serve) if prob.pd_sign[o] > 0]
    d = [int(prob.pd_partner[o]) for o in p]
    route = p + d
    assert abs(prob.demand[:, route].sum()) < 1e-9
    assert not prob.route_feasible(0, route)
    assert not carried_ok(prob, 0, route)
    assert prob.route_feasible(0, [p[0], d[0]])


def test_prefix_load_is_the_host_cumsum():
    """_route_tensors' carried load (ndim, F, L): the host's cumulative
    sum of each route's demands, its padding the route's total; None
    without pairs."""
    prob = pd_mixed(t_vrp, t_build)
    lsp = TL.build_ls_problem(prob, device="cpu")
    assert lsp.has_pairs
    routes = _pd_routes(prob, np.random.default_rng(0))
    R, lens = TS._routes_to_arrays(prob, routes, TS._pad_len(routes, 4))
    out = TL._route_tensors(lsp, TL._ids(lsp, R), TL._ids(lsp, lens))
    pre = out[-1].numpy()
    assert pre.shape == (prob.demand.shape[0],) + R.shape
    for v, r in routes.items():
        want = np.cumsum(prob.demand[:, r], axis=1)
        np.testing.assert_array_equal(pre[:, v, :len(r)], want)
        total = want[:, -1] if r else 0.0
        assert np.all(pre[:, v, len(r):] == np.asarray(total)[..., None])
    plain = t_build(gh60(t_vrp, "tw")[1])
    lsp = TL.build_ls_problem(plain, device="cpu")
    assert not lsp.has_pairs and lsp.pair_next is None
    R, lens = TS._routes_to_arrays(plain, {0: [1, 2]}, 8)
    assert TL._route_tensors(lsp, TL._ids(lsp, R),
                             TL._ids(lsp, lens))[-1] is None


def assert_scores_are_the_host_walk(device, host):
    """Finite entries exactly where the host reference has a value, and
    the values close to the host's cost change."""
    device = np.asarray(device)
    has = np.vectorize(lambda x: x is not None)(host)
    assert device.shape == host.shape
    assert np.array_equal(device < BIG / 2, has), \
        int(((device < BIG / 2) != has).sum())
    np.testing.assert_allclose(device[has], host[has].astype(float),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_move_scores_hold_the_carried_load(seed):
    """Routes from a noisy cheapest insertion (feasible, so every move is
    scored from a feasible start) on the mixed pickup-delivery instance:
    the five move families and the insertion scores are valid exactly
    where the host walk holds for every route a move changes, and their
    deltas are the host's cost changes. Or-opt moves a pickup with its
    adjacent delivery: the pair relocate."""
    prob = pd_mixed(t_vrp, t_build, seed=seed)
    lsp = TL.build_ls_problem(prob, device="cpu")
    routes, left = TC.cheapest_insertion(
        prob, rng=np.random.default_rng(seed), noise=0.5)
    assert not left
    assert all(carried_ok(prob, v, r) for v, r in routes.items())
    L = TS._pad_len(routes, 4)
    R, lens = TS._routes_to_arrays(prob, routes, L)
    cand = np.arange(0, prob.n_serve, 2)
    scores = TL._move_scores(lsp, TL._ids(lsp, R), TL._ids(lsp, lens))
    ins = TL.evaluate_insertions(lsp, R, lens, cand)
    ref = host_move_scores(prob, routes, L, cand)
    for device, host in zip([*scores, ins], ref):
        assert_scores_are_the_host_walk(device.numpy(), host)
    oro = scores[4].numpy()
    f2, j, f1, i = np.nonzero(oro < BIG / 2)
    pairs = [int(prob.pd_partner[R[a, b]]) == int(R[a, b + 1])
             for a, b in zip(f1, i)]
    assert any(pairs) and not all(pairs)


@pytest.mark.parametrize("seed", range(3))
def test_move_reductions_are_the_host_s(seed):
    """On the same routes, where every family has live moves (GH60's "pd"
    variant pairs every order, so there only 2-opt does): the best move,
    the top-k of each family and the best insertion per candidate are
    the host walk's."""
    prob = pd_mixed(t_vrp, t_build, seed=seed)
    lsp = TL.build_ls_problem(prob, device="cpu")
    routes, _ = TC.cheapest_insertion(
        prob, rng=np.random.default_rng(seed), noise=0.5)
    L = TS._pad_len(routes, 4)
    R, lens = TS._routes_to_arrays(prob, routes, L)
    cand = np.arange(0, prob.n_serve, 2)
    ref = host_move_scores(prob, routes, L, cand)
    assert all(np.any(h != None) for h in ref)  # noqa: E711
    assert_reductions_are_the_host_s(TL, lsp, R, lens, cand, ref, RTOL,
                                     ATOL)


def test_carried_load_binds_the_device_scores():
    """The same start with the net-load reading of the scores (each route
    held by its total, as cuopt_tpu's evaluators hold it) proposes moves
    that the host walk rejects: the carried load decides on this
    instance."""
    prob = pd_mixed(t_vrp, t_build, seed=1)
    routes, _ = TC.cheapest_insertion(prob, rng=np.random.default_rng(1),
                                      noise=0.5)
    reloc = host_move_scores(prob, routes, TS._pad_len(routes, 4))[0]
    net_ok = carried = 0
    for f1, r1 in routes.items():
        for i, u in enumerate(r1):
            for f2, r2 in routes.items():
                if f2 == f1 or prob.pd_partner[u] >= 0:
                    continue
                for j in range(len(r2) + 1):
                    if np.all(prob.demand[:, r2 + [u]].sum(axis=1)
                              <= prob.capacity[:, f2] + 1e-9):
                        net_ok += 1
                        carried += reloc[f2, j, f1, i] is not None
    assert carried < net_ok


def test_vehicle_reassign_holds_the_carried_load():
    """evaluate_vehicle_reassign on a fleet of two capacities: route r on
    vehicle v is feasible exactly where the host walk of r holds on v."""
    prob = pd_mixed(t_vrp, t_build)
    prob.capacity = np.where(np.arange(prob.n_fleet) % 2, 40.0, 60.0)[None]
    lsp = TL.build_ls_problem(prob, device="cpu")
    routes = _pd_routes(prob, np.random.default_rng(2))
    R, lens = TS._routes_to_arrays(prob, routes, TS._pad_len(routes, 4))
    _, feas = TL.evaluate_vehicle_reassign(lsp, R, lens)
    want = np.array([[bool(routes[r]) and carried_ok(prob, v, routes[r])
                      for r in range(prob.n_fleet)]
                     for v in range(prob.n_fleet)])
    assert np.array_equal(feas.numpy(), want)
    assert want.any() and not want[:, [r for r in routes if routes[r]]].all()


def test_tiled_moves_hold_the_carried_load():
    """The large-fleet tiling (_grouped_moves, one vmapped evaluation of
    every tile) on the mixed instance: every improving candidate it
    returns, applied on the host, keeps the carried load of both routes
    it changes."""
    prob = pd_mixed(t_vrp, t_build, n=48, seed=2)
    lsp = TL.build_ls_problem(prob, device="cpu")
    routes, _ = TC.cheapest_insertion(prob, rng=np.random.default_rng(2),
                                      noise=0.8)
    R, lens = TS._routes_to_arrays(prob, routes, TS._pad_len(routes, 4))
    packed = TS._grouped_moves(prob, lsp, R, lens, 0, group=4)
    live = packed[packed[:, 0] < BIG / 2]
    assert len(live)
    for delta, kind, *mv in live:
        new = TS._apply_move({v: list(r) for v, r in routes.items()},
                             kind, mv)
        for v in {int(mv[0]), int(mv[2])}:
            assert carried_ok(prob, v, new[v]), (kind, mv)


def test_solve_holds_the_carried_load():
    """GH60 as pairs (test_torch_routing_solve.py's "pd" variant): the
    plan cheapest insertion makes under the net load (all pairs' pickups
    of a route may ride at once) breaks the carried load, and Solve's
    routes pass the host walk: every order once, pickup first, carried
    load within the capacity after every stop."""
    pytest.importorskip("jax")
    import cuopt_tpu.io.vrp as j_vrp
    from cuopt_tpu.routing.construction import cheapest_insertion
    from cuopt_tpu.routing.internal import build_problem as j_build

    inst, dm = gh60(t_vrp, "pd")
    prob = t_build(dm)
    net_plan, _ = cheapest_insertion(j_build(gh60(j_vrp, "pd")[1]))
    assert not all(carried_ok(prob, v, r) for v, r in net_plan.items())

    s = SolverSettings()
    s.set_time_limit(3)
    s.seed = 0
    sol = Solve(dm, s, device="cpu")
    assert sol.get_status() == SolutionStatus.SUCCESS.value
    table = sol.get_route()
    seen = []
    for v in sorted(set(table["truck_id"].tolist())):
        rows = np.flatnonzero((table["truck_id"] == v)
                              & (table["type"] != "Depot"))
        r = [int(o) for o in table["route"][rows]]
        seen += r
        assert carried_ok(prob, int(v), r)
        for o in r:
            if prob.pd_sign[o] > 0:
                assert int(prob.pd_partner[o]) in r[r.index(o):]
    assert sorted(seen) == list(range(prob.n_serve))

