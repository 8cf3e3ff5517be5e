"""cuopt_torch's exchange-cycle search and HVRP reassignment
(routing/cycle_finder.py) against cuopt_tpu's, on the CPU.

Both packages keep the same host code around their device scoring
(`evaluate_cycle_gains`, `evaluate_vehicle_reassign`): on the same routes
the negative-cycle search, the cycle's application, `cycle_search` and
`hvrp_reassign` must give equal routes and equal improved flags. The
instances are tests/test_eax_cycles.py's contrived ones and the GH60
`hetero` variant of tests/torch_routing_instances.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.io.vrp as t_vrp  # noqa: E402
import cuopt_torch.routing.cycle_finder as TF  # noqa: E402
import cuopt_torch.routing.local_search as TL  # noqa: E402
import cuopt_tpu.io.vrp as j_vrp  # noqa: E402
import cuopt_tpu.routing.cycle_finder as JF  # noqa: E402
import cuopt_tpu.routing.local_search as JL  # noqa: E402
from cuopt_torch.routing import DataModel as TDM  # noqa: E402
from cuopt_torch.routing.construction import cheapest_insertion  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_tpu.routing import DataModel as JDM  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from torch_routing_instances import gh60, random_routes  # noqa: E402

torch.set_num_threads(1)


def _copy(routes):
    return {int(v): [int(o) for o in r] for v, r in routes.items()}


def _both(make):
    """The same instance built by both packages, with their LsProblems
    (the port's on the CPU)."""
    tp, jp = t_build(make(TDM)), j_build(make(JDM))
    return tp, jp, TL.build_ls_problem(tp, device="cpu"), \
        JL.build_ls_problem(jp)


def three_clusters(DataModel):
    """tests/test_eax_cycles.py:96: clusters at (0,0), (10,0), (20,0),
    depot at (5,5), three vehicles of capacity 3."""
    pts = [(5.0, 5.0)]
    for cx, cy in ((0.0, 0.0), (10.0, 0.0), (20.0, 0.0)):
        for k in range(3):
            pts.append((cx + 0.1 * k, cy))
    xy = np.asarray(pts)
    dist = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1))
    dm = DataModel(len(pts), 3, 9)
    dm.add_cost_matrix(dist)
    dm.set_order_locations(np.arange(1, 10, dtype=np.int32))
    dm.add_capacity_dimension("d", np.ones(9), np.full(3, 3.0))
    return dm


ROTATED = {0: [0, 1, 5], 1: [3, 4, 8], 2: [6, 7, 2]}


def two_types(DataModel):
    """tests/test_eax_cycles.py:131: four points on a line, an expensive
    vehicle type 0 and a cheap type 1."""
    xy = np.asarray([(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)])
    dist = np.sqrt(((xy[:, None] - xy[None, :]) ** 2).sum(-1))
    dm = DataModel(4, 2, 3)
    dm.add_cost_matrix(dist * 3.0, vehicle_type=0)
    dm.add_cost_matrix(dist, vehicle_type=1)
    dm.set_vehicle_types(np.array([0, 1], np.int32))
    dm.set_order_locations(np.array([1, 2, 3], np.int32))
    return dm


def test_negative_cycle_contrived():
    BIG = TF.BIG
    G = np.full((4, 4), BIG)
    G[0, 1], G[1, 2], G[2, 0], G[1, 0] = 2.0, -1.5, -1.5, 5.0
    cyc = TF.find_negative_cycle(G)
    assert cyc == JF.find_negative_cycle(G)
    assert cyc is not None and cyc[0] == cyc[-1] and set(cyc) <= {0, 1, 2}
    G2 = np.full((3, 3), BIG)
    G2[0, 1] = G2[1, 0] = 1.0
    assert TF.find_negative_cycle(G2) is None
    assert JF.find_negative_cycle(G2) is None


@pytest.mark.parametrize("seed", range(8))
def test_negative_cycle_seeded(seed):
    """Seeded sparse gain matrices, with and without a negative cycle."""
    rng = np.random.default_rng(seed)
    F = int(rng.integers(4, 13))
    G = np.where(rng.random((F, F)) < 0.5, rng.normal(1.0, 1.5, (F, F)),
                 TF.BIG)
    np.fill_diagonal(G, TF.BIG)
    a, b = TF.find_negative_cycle(G), JF.find_negative_cycle(G)
    assert (a is None) == (b is None)
    if a is not None:
        assert [int(x) for x in a] == [int(x) for x in b]
        cost = sum(G[i, j] for i, j in zip(a[:-1], a[1:]))
        assert cost < 0


def test_cycle_gains_and_application_equal():
    """One scoring of the rotated clusters: equal gains (float32 on both
    sides), equal positions and slots, and the same cycle applied."""
    tp, jp, tl, jl = _both(three_clusters)
    R = np.full((3, 8), -1, np.int32)
    lens = np.full(3, 3, np.int32)
    for v, r in ROTATED.items():
        R[v, :3] = r
    g, p_, s_ = (t.numpy() for t in TL.evaluate_cycle_gains(tl, R, lens))
    jg, jp_, js_ = (np.asarray(a) for a in JL.evaluate_cycle_gains(
        jl, R, lens))
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-4)
    assert np.array_equal(p_, jp_) and np.array_equal(s_, js_)
    a = TF.apply_exchange_cycle(tp, _copy(ROTATED), g, p_.astype(np.int64),
                                s_.astype(np.int64))
    b = JF.apply_exchange_cycle(jp, _copy(ROTATED), jg,
                                jp_.astype(np.int64), js_.astype(np.int64))
    assert a[1] and a == b


def test_cycle_search_improves_contrived():
    tp, jp, tl, jl = _both(three_clusters)
    base = sum(tp.route_cost(v, r) for v, r in ROTATED.items())
    a = TF.cycle_search(tp, tl, _copy(ROTATED))
    b = JF.cycle_search(jp, jl, _copy(ROTATED))
    assert a == b and a[1]
    new = sum(tp.route_cost(v, r) for v, r in a[0].items())
    assert new < base - 1e-6
    assert all(len(r) <= 3 for r in a[0].values())


def test_hvrp_reassign_contrived():
    tp, jp, tl, jl = _both(two_types)
    a = TF.hvrp_reassign(tp, tl, {0: [0, 1, 2], 1: []})
    b = JF.hvrp_reassign(jp, jl, {0: [0, 1, 2], 1: []})
    assert a == b and a[1]
    assert a[0][1] == [0, 1, 2] and a[0][0] == []


def _hetero():
    tp = t_build(gh60(t_vrp, "hetero")[1])
    jp = j_build(gh60(j_vrp, "hetero")[1])
    return tp, jp, TL.build_ls_problem(tp, device="cpu"), \
        JL.build_ls_problem(jp)


def _on_costly_vehicles(prob, routes):
    """Routes only on the costlier type-1 (odd) vehicles, the cheap ones
    idle: the orders in the given routes' visiting order, cut into runs
    that a type-1 vehicle can carry, one run for each odd vehicle."""
    seq = [o for v in sorted(routes) for o in routes[v]]
    out = {v: [] for v in range(prob.n_fleet)}
    for w in range(1, prob.n_fleet, 2):
        run = []
        while seq and prob.route_feasible(w, run + seq[:1]):
            run.append(seq.pop(0))
        out[w] = run
    assert all(out[w] for w in range(1, prob.n_fleet, 2))
    return out


def test_hetero_cycle_search_and_reassign_equal():
    """GH60 with two vehicle types: from cheapest insertion, cycle_search
    then hvrp_reassign (as the local search calls them); and hvrp_reassign
    from routes put on the costly vehicles, where it must improve."""
    tp, jp, tl, jl = _hetero()
    routes, _ = cheapest_insertion(tp)
    a = TF.cycle_search(tp, tl, _copy(routes))
    b = JF.cycle_search(jp, jl, _copy(routes))
    assert a == b
    assert TF.hvrp_reassign(tp, tl, _copy(a[0])) == \
        JF.hvrp_reassign(jp, jl, _copy(a[0]))
    costly = _on_costly_vehicles(tp, routes)
    a = TF.hvrp_reassign(tp, tl, _copy(costly))
    b = JF.hvrp_reassign(jp, jl, _copy(costly))
    assert a == b and a[1]
    before = sum(tp.route_cost(v, r) for v, r in costly.items() if r)
    after = sum(tp.route_cost(v, r) for v, r in a[0].items() if r)
    assert after < before - 1e-6


@pytest.mark.parametrize("seed", range(3))
def test_hetero_random_routes_equal(seed):
    """Seeded random splits of GH60's orders over the mixed fleet (most
    routes infeasible, so the exact re-validation rejects many moves)."""
    tp, jp, tl, jl = _hetero()
    routes = random_routes(np.random.default_rng(seed), tp.n_serve,
                           tp.n_fleet // 2)
    a = TF.cycle_search(tp, tl, _copy(routes))
    b = JF.cycle_search(jp, jl, _copy(routes))
    assert a == b
    full = {v: routes.get(v, []) for v in range(tp.n_fleet)}
    assert TF.hvrp_reassign(tp, tl, _copy(full)) == \
        JF.hvrp_reassign(jp, jl, _copy(full))


def _gh40(vrp, seed):
    """tests/test_eax_cycles.py:20: synth_gh_instance(n, "C", seed)
    without time windows."""
    return vrp.synth_gh_instance(40 if seed == 2 else 30, "C", seed=seed,
                                 tw_frac=0.0).to_data_model()


def test_ab_cycles_are_ab_cycles():
    """tests/test_eax_cycles.py:34 on the same two parents: every cycle
    `_ab_cycles` returns is an AB-cycle, an even closed walk whose edges
    alternate between the parents, starting on an A edge at its start
    vertex and ending on a B edge back there; each edge comes from its
    parent's side of the difference. A departure (ROADMAP "Deliberate
    departures"): cuopt_tpu closes a walk after an A edge
    (cuopt_tpu/routing/eax.py:101), and every cycle it returns here is
    odd with A edges at both ends."""
    import cuopt_torch.routing.eax as TE
    import cuopt_tpu.routing.eax as JE
    from cuopt_torch.routing.construction import cheapest_insertion as tci

    tp = t_build(_gh40(t_vrp, 2))
    ra = tci(tp)[0]
    rb = tci(tp, rng=np.random.default_rng(1), noise=0.6)[0]
    ea, eb = TE._edges(ra), TE._edges(rb)
    a = TE._ab_cycles(ea, eb, np.random.default_rng(0))
    assert a
    only_a, only_b = set(ea) - set(eb), set(eb) - set(ea)
    for cyc in a:
        kinds = [from_a for _, from_a in cyc]
        assert len(cyc) % 2 == 0 and kinds[0] and not kinds[-1]
        assert all(x != y for x, y in zip(kinds, kinds[1:]))
        assert all(e in (only_a if k else only_b) for e, k in cyc)
        (u0, v0), _ = cyc[0]
        cur = v0
        for (u, v), _ in cyc[1:]:
            assert cur in (u, v)
            cur = v if cur == u else u
        assert cur == u0
    b = JE._ab_cycles(JE._edges(ra), JE._edges(rb),
                      np.random.default_rng(0))
    assert b and all(len(c) % 2 == 1 and c[0][1] and c[-1][1] for c in b)


def test_set_covering_child_equal():
    """tests/test_eax_cycles.py:151: a child chosen from three members'
    routes serves every order once, in both packages alike."""
    import cuopt_torch.routing.diversity as TD
    import cuopt_tpu.routing.diversity as JD
    from cuopt_torch.routing.construction import cheapest_insertion as tci

    tp, jp = t_build(_gh40(t_vrp, 4)), j_build(_gh40(j_vrp, 4))
    members = []
    for seed in (0, 1, 2):
        r, u = tci(tp, rng=np.random.default_rng(seed), noise=0.4 * seed)
        members.append({"routes": r, "unassigned": u})
    a = TD.set_covering_child(tp, members, np.random.default_rng(9))
    b = JD.set_covering_child(jp, members, np.random.default_rng(9))
    assert a is not None and a[0] == b[0] and list(a[1]) == list(b[1])
    served = sorted([o for r in a[0].values() for o in r] + list(a[1]))
    assert served == list(range(tp.n_serve))
    for v, r in a[0].items():
        assert not r or tp.route_feasible(v, r)
