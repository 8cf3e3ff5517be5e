"""cuopt_torch's routing search and `Solve` against cuopt_tpu's, on the
CPU.

Construction, one local search and each recombination or mutation are
deterministic given their inputs and the numpy Generator: from the same
start with the same seed both packages must produce the same routes
(their move scores agree within rtol 1e-5 / atol 1e-3; the instances
here meet no tie within 1e-3 on the moves they take). `Solve` itself
runs until its time limit, so it is held to the outcomes of
tests/test_routing.py and tests/test_bks_regression.py instead, each
case with a time limit of 2-5 s.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import cuopt_torch.io.vrp as t_vrp  # noqa: E402
import cuopt_torch.routing.construction as TC  # noqa: E402
import cuopt_torch.routing.diversity as TD  # noqa: E402
import cuopt_torch.routing.eax as TE  # noqa: E402
import cuopt_torch.routing.ges as TG  # noqa: E402
import cuopt_torch.routing.local_search as TL  # noqa: E402
import cuopt_torch.routing.solver as TS  # noqa: E402
import cuopt_tpu.io.vrp as j_vrp  # noqa: E402
import cuopt_tpu.routing.construction as JC  # noqa: E402
import cuopt_tpu.routing.diversity as JD  # noqa: E402
import cuopt_tpu.routing.eax as JE  # noqa: E402
import cuopt_tpu.routing.ges as JG  # noqa: E402
import cuopt_tpu.routing.local_search as JL  # noqa: E402
import cuopt_tpu.routing.solver as JS  # noqa: E402
from cuopt_torch.routing import DataModel, SolutionStatus, SolverSettings  # noqa: E402
from cuopt_torch.routing import Solve  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_torch.utils.timer import Timer as TTimer  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402
from torch_routing_instances import GH60_VARIANTS, gh60  # noqa: E402

torch.set_num_threads(1)


def _problems(variant="tw", n=None):
    """The same instance built by both packages, each with its LsProblem
    cached on it as Solve caches it (the port's on the CPU)."""
    if n is None:
        tp = t_build(gh60(t_vrp, variant)[1])
        jp = j_build(gh60(j_vrp, variant)[1])
    else:
        tp = t_build(t_vrp.synth_gh_instance(n, "RC", seed=3).to_data_model())
        jp = j_build(j_vrp.synth_gh_instance(n, "RC", seed=3).to_data_model())
    tp._lsp_cache = TL.build_ls_problem(tp, device="cpu")
    jp._lsp_cache = JL.build_ls_problem(jp)
    return tp, jp


def _routes(routes):
    return {int(v): [int(o) for o in r] for v, r in routes.items() if r}


@pytest.mark.parametrize("variant", ["tw", "pd", "max-cost-time"])
def test_cheapest_insertion_matches(variant):
    """The same routes as cuopt_tpu's. "pd" is a departure: the port holds
    the load carried after each stop to the capacity, cuopt_tpu the
    route's net demand (test_torch_carried_load.py), so there the port's
    routes are held to the host walk and cuopt_tpu's break it; with a
    capacity that no carried load can exceed, both match."""
    tp, jp = _problems(variant)
    if variant == "pd":
        from torch_routing_instances import carried_ok

        routes, left = TC.cheapest_insertion(tp)
        served = sorted(o for r in routes.values() for o in r)
        assert not left and served == list(range(tp.n_serve))
        assert all(carried_ok(tp, v, r) and tp.route_feasible(v, r)
                   for v, r in routes.items() if r)
        j_routes = JC.cheapest_insertion(jp)[0]
        assert not all(carried_ok(tp, v, r) for v, r in j_routes.items())
        roomy = float(np.clip(tp.demand, 0, None).sum())
        tp.capacity[:] = jp.capacity[:] = roomy
    a, b = TC.cheapest_insertion(tp), JC.cheapest_insertion(jp)
    assert _routes(a[0]) == _routes(b[0]) and a[1] == b[1]
    if variant != "tw":
        return
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    a = TC.cheapest_insertion(tp, rng=rng_a, noise=0.3)
    b = JC.cheapest_insertion(jp, rng=rng_b, noise=0.3)
    assert _routes(a[0]) == _routes(b[0]) and a[1] == b[1]


@pytest.mark.parametrize("variant", ["tw", "no-tw"])
def test_batched_construction_matches(variant):
    tp, jp = _problems(variant)
    a = TC.batched_construction(tp, tp._lsp_cache)
    b = JC.batched_construction(jp, jp._lsp_cache)
    assert _routes(a[0]) == _routes(b[0]) and a[1] == b[1]
    assert sum(map(len, a[0].values())) + len(a[1]) == tp.n_serve


_j_move_scores = jax.jit(JL._move_scores)


def _j_topk_cost_neutral_zero(p, R, lens, kf=8):
    """cuopt_tpu's evaluate_moves_topk under the port's 2-opt* rule (a
    deliberate departure): an exchange that leaves the cost as it is
    (two empty tails, or two whole routes swapped between vehicles of one
    start and fixed cost) scores 0, where float32 rounding scored it as
    low as -2e-6 and the local search applied it as improving. The
    families' kf smallest entries, ties to the lower index, packed as
    cuopt_tpu packs them."""
    scores = [np.array(s) for s in _j_move_scores(p, R, lens)]
    ln = np.asarray(lens)[:, None, None, None]
    cut = np.arange(scores[3].shape[1])
    i, k = cut[None, :, None, None], cut[None, None, None, :]
    start, fixed = np.asarray(p.veh_start), np.asarray(p.veh_fixed)
    same = (start[:, None] == start[None, :]) & \
        (fixed[:, None] == fixed[None, :])
    no_op = ((i == ln) & (k == ln.transpose(2, 1, 0, 3))) | \
        ((i == 0) & (k == 0) & same[:, None, :, None])
    scores[3] = np.where(no_op & (scores[3] < JL.BIG / 2), 0.0, scores[3])
    rows = []
    for kind, score in enumerate(scores):
        flat = np.concatenate([score.ravel(),
                               np.full(kf, JL.BIG, score.dtype)])
        idx = np.argsort(flat, kind="stable")[:kf]
        args = np.unravel_index(np.minimum(idx, score.size - 1), score.shape)
        mv = np.stack([args[0], args[1], args[0], args[2]] if kind == 2
                      else list(args), axis=1)
        rows.append(np.concatenate([flat[idx, None], np.full((kf, 1), kind),
                                    mv], axis=1).astype(np.float32))
    return np.concatenate(rows)


@pytest.mark.parametrize("variant", ["tw", "no-tw", "hetero"])
def test_local_search_matches(variant, monkeypatch):
    """Five rounds from cuopt_tpu's cheapest insertion: the same routes,
    and the cost goes down. cuopt_tpu's local search proposes its moves
    under the port's 2-opt* rule for cost-neutral exchanges
    (_j_topk_cost_neutral_zero): with its own, it applies such a no-op
    in a round and so blocks the two routes from that round's other
    moves."""
    monkeypatch.setattr(JL, "evaluate_moves_topk", _j_topk_cost_neutral_zero)
    tp, jp = _problems(variant)
    start, _ = JC.cheapest_insertion(jp)
    a = TS._local_search(tp, tp._lsp_cache, dict(start), TTimer(60.0),
                         max_rounds=5)
    b = JS._local_search(jp, jp._lsp_cache, dict(start), JTimer(60.0),
                         max_rounds=5)
    assert _routes(a) == _routes(b)

    def cost(r):
        return sum(tp.route_cost(v, x) for v, x in r.items() if x)

    assert cost(a) < cost(start)


def test_local_search_keeps_pickup_before_delivery():
    """Five rounds on the pickup-delivery variant (no time windows, so
    2-opt is scored): the port rechecks every move on the host, as it
    does for breaks or max cost, and every route stays feasible. The
    device scores do not see a pair inside a reversed segment;
    cuopt_tpu applies such a 2-opt unchecked and delivers before picking
    up (its routes fail the same host check). Both start from the port's
    cheapest insertion: cuopt_tpu's routes carry more than the capacity
    between a pickup and its delivery (test_torch_carried_load.py)."""
    tp, jp = _problems("pd")
    assert tp._lsp_cache.allow_2opt
    start, _ = TC.cheapest_insertion(tp)
    assert all(tp.route_feasible(v, r) for v, r in start.items() if r)
    a = TS._local_search(tp, tp._lsp_cache, dict(start), TTimer(60.0),
                         max_rounds=5)
    b = JS._local_search(jp, jp._lsp_cache, dict(start), JTimer(60.0),
                         max_rounds=5)
    assert all(tp.route_feasible(v, r) for v, r in a.items() if r)
    assert sum(tp.route_cost(v, r) for v, r in a.items() if r) <= \
        sum(tp.route_cost(v, r) for v, r in start.items() if r)
    assert not all(jp.route_feasible(v, r) for v, r in b.items() if r)


OPERATORS = {
    "srex": lambda M, p, pa, pb, rng: M["D"].srex(p, pa, pb, rng),
    "ox": lambda M, p, pa, pb, rng: M["D"].ox_single_route(p, pa, pb, rng),
    "ruin-recreate": lambda M, p, pa, pb, rng: M["D"].ruin_recreate(
        p, pa, rng),
    "eax": lambda M, p, pa, pb, rng: M["E"].eax(p, pa, pb, rng),
    "feasible-insertions": lambda M, p, pa, pb, rng: (
        M["G"].feasible_insertions(
            p, {v: [o for o in r if o != 7] for v, r in pa["routes"].items()},
            7),),
}
T_MODS = {"D": TD, "E": TE, "G": TG}
J_MODS = {"D": JD, "E": JE, "G": JG}


def _parents(prob, C):
    """Two parents: batched construction, plain and with noise 0.5."""
    a = C.batched_construction(prob, prob._lsp_cache)
    b = C.batched_construction(prob, prob._lsp_cache,
                               rng=np.random.default_rng(1), noise=0.5)
    return ({"routes": a[0], "unassigned": a[1]},
            {"routes": b[0], "unassigned": b[1]})


@pytest.fixture(scope="module")
def gh400():
    """The 400-order instance in both packages and each one's parents."""
    tp, jp = _problems(n=400)
    return tp, _parents(tp, TC), jp, _parents(jp, JC)


def _copy(parent):
    return {"routes": {v: list(r) for v, r in parent["routes"].items()},
            "unassigned": list(parent["unassigned"])}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_children_match(name, gh400):
    """Each recombination / mutation with seed 11 gives the same child.
    At 400 orders with about 40 vehicles the reinsertion after removal
    and the insertion scan take the device-batched paths
    (smart_reinsert, _device_insertion_prefilter). EAX is a departure:
    the port's AB-cycles close on a B edge and cuopt_tpu's after an A
    edge (test_torch_cycle_finder.py), so its child is checked on the
    host instead: every order once, every route feasible."""
    tp, (ta, tb), jp, (ja, jb) = gh400
    ta, tb, ja, jb = map(_copy, (ta, tb, ja, jb))
    assert _routes(ta["routes"]) == _routes(ja["routes"])
    assert _routes(tb["routes"]) == _routes(jb["routes"])
    if name == "eax":
        assert TE.eax_applicable(tp)
        routes, left = OPERATORS[name](T_MODS, tp, ta, tb,
                                       np.random.default_rng(11))
        served = [o for r in routes.values() for o in r]
        assert sorted(served + list(left)) == list(range(tp.n_serve))
        assert all(tp.route_feasible(v, r) for v, r in routes.items() if r)
        return
    a = OPERATORS[name](T_MODS, tp, ta, tb, np.random.default_rng(11))
    b = OPERATORS[name](J_MODS, jp, ja, jb, np.random.default_rng(11))
    assert (a is None) == (b is None)
    if name == "feasible-insertions":
        assert a[0] and [(round(d, 6), v, r) for d, v, r in a[0]] == \
            [(round(d, 6), v, r) for d, v, r in b[0]]
    elif a is not None:
        assert _routes(a[0]) == _routes(b[0])
        assert sorted(a[1]) == sorted(b[1])


def test_ox_on_one_route_and_the_orders_cuopt_tpu_drops():
    """Order crossover on a 13-order TSP: the same child in both packages.
    On a multi-route parent crossed with itself (which Solve does when
    the population holds one member), cuopt_tpu's child keeps only the
    first route's orders and lists the rest nowhere, so Solve can return
    SUCCESS with orders missing; the port gives no child there."""
    from cuopt_tpu.routing.data_model import DataModel as JDataModel

    pts = np.random.default_rng(8).uniform(0, 100, (14, 2))
    cost = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    probs = []
    for D, build in ((DataModel, t_build), (JDataModel, j_build)):
        dm = D(14, 1)
        dm.add_cost_matrix(cost)
        probs.append(build(dm))
    tp, jp = probs
    ra, _ = JC.cheapest_insertion(jp)
    rb, _ = JC.cheapest_insertion(jp, rng=np.random.default_rng(2),
                                  noise=0.8)
    pa, pb = ({"routes": r, "unassigned": []} for r in (ra, rb))
    a = TD.ox_single_route(tp, pa, pb, np.random.default_rng(4))
    b = JD.ox_single_route(jp, pa, pb, np.random.default_rng(4))
    assert a is not None and _routes(a[0]) == _routes(b[0])

    tp, jp = _problems("no-tw")
    routes, _ = JC.cheapest_insertion(jp)
    par = {"routes": routes, "unassigned": []}
    assert TD.ox_single_route(tp, par, par, np.random.default_rng(0)) \
        is None
    child, left = JD.ox_single_route(jp, par, par, np.random.default_rng(0))
    assert sum(map(len, child.values())) + len(left) < jp.n_serve


# --------------------------------------------------------------- Solve
def _settings(t):
    s = SolverSettings()
    s.set_time_limit(t)
    s.seed = 0
    return s


def _unit_cost(n):
    return np.ones((n, n)) - np.eye(n)


def _points_cost(seed, n, scale):
    pts = np.random.default_rng(seed).uniform(0, scale, (n, 2))
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


def _tsp():
    cost = _points_cost(5, 7, 100)
    dm = DataModel(7, 1)
    dm.add_cost_matrix(cost)
    tours = ((0,) + p + (0,) for p in itertools.permutations(range(1, 7)))
    best = min(sum(cost[t[i], t[i + 1]] for i in range(7)) for t in tours)

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        assert sol.get_vehicle_count() == 1
        assert sol.get_total_objective() <= best * 1.02 + 1e-6
    return dm, check


def _capacity():
    dm = DataModel(5, 3)
    dm.add_cost_matrix(_unit_cost(5))
    dm.add_capacity_dimension("weight", [0, 2, 2, 2, 2], [4, 4, 4])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        assert sol.get_vehicle_count() >= 2
        for v in set(table["truck_id"].tolist()):
            sub = table[(table["truck_id"] == v) & (table["route"] != 0)]
            assert 2 * len(sub) <= 4
    return dm, check


def _capacity_infeasible():
    dm = DataModel(3, 1)
    dm.add_cost_matrix(_unit_cost(3))
    dm.add_capacity_dimension("w", [0, 5, 5], [4])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.FAIL.value
        assert len(sol.get_infeasible_orders()) == 2
    return dm, check


def _time_windows():
    cost = _points_cost(2, 5, 10)
    early, late = [0, 0, 10, 0, 20], [1000, 15, 30, 100, 40]
    dm = DataModel(5, 2)
    dm.add_cost_matrix(cost)
    dm.add_transit_time_matrix(cost)
    dm.set_order_time_windows(early, late)
    dm.set_order_service_times([0, 1, 1, 1, 1])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        for o, t in zip(table["route"], table["arrival_stamp"]):
            if o != 0:
                assert early[o] - 1e-6 <= t <= late[o] + 1e-6
    return dm, check


def _time_windows_infeasible():
    cost = np.full((3, 3), 100.0) - 100.0 * np.eye(3)
    dm = DataModel(3, 1)
    dm.add_cost_matrix(cost)
    dm.add_transit_time_matrix(cost)
    dm.set_order_time_windows([0, 0, 0], [1000, 10, 10])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.FAIL.value
    return dm, check


def _pickup_delivery():
    dm = DataModel(5, 2, n_orders=4)
    dm.add_cost_matrix(_points_cost(4, 5, 10))
    dm.set_order_locations([1, 2, 3, 4])
    dm.set_pickup_delivery_pairs([0, 2], [1, 3])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        for v in set(table["truck_id"].tolist()):
            seq = table[table["truck_id"] == v]["route"].tolist()
            for p, d in ((0, 1), (2, 3)):
                if p in seq:
                    assert d in seq and seq.index(p) < seq.index(d)
    return dm, check


def _break():
    dm = DataModel(3, 1)
    dm.add_cost_matrix(np.array([[0, 5, 9], [5, 0, 5], [9, 5, 0]], float))
    dm.add_break_dimension([10.0], [20.0], [5.0])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        brk = table[table["type"] == "Break"]
        assert len(brk) == 1
        assert 10.0 - 1e-6 <= brk["arrival_stamp"][0] <= 20.0 + 1e-6
        assert table["arrival_stamp"][-1] >= 5.0
    return dm, check


def _break_infeasible():
    dm = DataModel(3, 1)
    dm.add_cost_matrix(np.array([[0, 5, 9], [5, 0, 5], [9, 5, 0]], float))
    dm.set_vehicle_time_windows([0.0], [50.0])
    dm.add_break_dimension([0.0], [1.0], [100.0])

    def check(sol, table):
        assert sol.get_status() != SolutionStatus.SUCCESS.value
    return dm, check


def _min_vehicles():
    dm = DataModel(5, 3, n_orders=4)
    dm.add_cost_matrix(_unit_cost(5))
    dm.set_order_locations([1, 2, 3, 4])
    dm.set_min_vehicles(2)

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        assert sol.get_vehicle_count() >= 2
    return dm, check


def _fixed_costs():
    dm = DataModel(5, 4)
    dm.add_cost_matrix(_unit_cost(5))
    dm.set_vehicle_fixed_costs([100.0] * 4)

    def check(sol, table):
        assert sol.get_vehicle_count() == 1
    return dm, check


def _order_vehicle_match():
    dm = DataModel(4, 2)
    dm.add_cost_matrix(_unit_cost(4))
    for o in (1, 2, 3):
        dm.add_order_vehicle_match(o, [1])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        served = table[table["route"] != 0]
        assert set(served["truck_id"].tolist()) == {1}
    return dm, check


def _initial_solution():
    dm = DataModel(5, 2, n_orders=4)
    dm.add_cost_matrix(np.array([
        [0, 2, 4, 4, 3], [2, 0, 1, 6, 5], [4, 1, 0, 3, 4],
        [4, 6, 3, 0, 1], [3, 5, 4, 1, 0]], float))
    dm.set_order_locations([1, 2, 3, 4])
    dm.add_initial_solutions([0, 1], [0, 1, 2, 3], ["Delivery"] * 4,
                             [0, 2, 4])

    def check(sol, table):
        assert sol.get_status() == SolutionStatus.SUCCESS.value
        served = table[~np.isin(table["type"], ["Depot", "Break"])]
        assert sorted(served["location"].tolist()) == [1, 2, 3, 4]
    return dm, check


# the brute-forceable cases of tests/test_routing.py, time limit in s
SOLVE_CASES = {
    "tsp-optimum": (_tsp, 3.0),
    "capacity": (_capacity, 2.0),
    "capacity-infeasible": (_capacity_infeasible, 2.0),
    "time-windows": (_time_windows, 2.0),
    "time-windows-infeasible": (_time_windows_infeasible, 2.0),
    "pickup-delivery-order": (_pickup_delivery, 2.0),
    "break": (_break, 2.0),
    "break-infeasible": (_break_infeasible, 2.0),
    "min-vehicles": (_min_vehicles, 2.0),
    "fixed-costs": (_fixed_costs, 2.0),
    "order-vehicle-match": (_order_vehicle_match, 2.0),
    "initial-solution": (_initial_solution, 2.0),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_cases(case):
    build, t = SOLVE_CASES[case]
    dm, check = build()
    sol = Solve(dm, _settings(t), device="cpu")
    check(sol, sol.get_route())


@pytest.mark.parametrize("variant", GH60_VARIANTS)
def test_solve_variants(variant):
    """Solve (2 s) on each 60-order variant: time windows, none, max cost
    and time (the host recheck of every move), prizes, pickup-delivery
    pairs, two vehicle types. Every order is served at most once; an order
    left out is reported (prizes may leave orders by choice); every route
    is feasible on the host."""
    inst, dm = gh60(t_vrp, variant)
    prob = t_build(dm)
    sol = Solve(dm, _settings(2.0), device="cpu")
    left = set(sol.get_infeasible_orders())
    assert sol.get_status() == (1 if left and variant != "prizes" else 0)
    table = sol.get_route()
    served = table[~np.isin(table["type"], ["Depot", "Break"])]
    ids = served["route"].tolist()
    assert len(ids) == len(set(ids)) and not set(ids) & left
    assert len(ids) + len(left) == 60
    for v in np.unique(served["truck_id"]):
        sub = served[served["truck_id"] == v]
        route = sub["route"][np.argsort(sub["arrival_stamp"], kind="stable")]
        assert prob.route_feasible(int(v), route.tolist())


def test_gh100_improves_over_construction():
    """tests/test_bks_regression.py's rule at a 5 s limit: every customer
    served once and at least 3% below plain cheapest insertion."""
    inst = t_vrp.synth_gh_instance(100, "RC", seed=5)
    dm = inst.to_data_model()
    prob = t_build(dm)
    base_routes, base_un = TC.cheapest_insertion(prob)
    assert not base_un
    base = sum(prob.route_cost(v, r) for v, r in base_routes.items() if r)
    sol = Solve(dm, _settings(5.0), device="cpu")
    assert sol.status == 0, sol.message
    cost, _ = t_vrp.solution_cost(inst, sol)
    table = sol.get_route()
    served = table[np.isin(table["type"], ["Delivery", "Pickup"])]
    assert len(served) == 100 and len(set(served["route"].tolist())) == 100
    assert cost < base * 0.97, (cost, base)
