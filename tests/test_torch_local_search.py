"""cuopt_torch's routing move evaluators against cuopt_tpu's, on the CPU.

The same DataModel (built by each package from the same seeded numpy
arrays) and the same routes go through both packages' evaluators. Both
score in float32; cuopt_tpu's XLA and the port's eager torch may round a
sum in a different order, so values are held to rtol 1e-5 / atol 1e-3 and
masks (BIG entries) exactly. Chosen moves, routes and slots must be
cuopt_tpu's, except where two candidates' deltas lie within 1e-3 of each
other: there either choice is right.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import cuopt_torch.io.vrp as t_vrp  # noqa: E402
import cuopt_torch.routing.local_search as TL  # noqa: E402
import cuopt_torch.routing.solver as TS  # noqa: E402
import cuopt_tpu.io.vrp as j_vrp  # noqa: E402
import cuopt_tpu.routing.local_search as JL  # noqa: E402
import cuopt_tpu.routing.solver as JS  # noqa: E402
from cuopt_torch.routing.data_model import DataModel as TDataModel  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_tpu.routing.construction import cheapest_insertion  # noqa: E402
from cuopt_tpu.routing.data_model import DataModel as JDataModel  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from torch_routing_instances import (  # noqa: E402
    GH60_VARIANTS,
    gh60,
    grid_dm,
    random_routes,
)

torch.set_num_threads(1)

RTOL, ATOL, TIE = 1e-5, 1e-3, 1e-3
BIG = TL.BIG
# cuopt_tpu runs these inside its jitted evaluators; jitted here too, as
# op-by-op JAX takes minutes
j_move_scores = jax.jit(JL._move_scores)
j_route_tensors = jax.jit(JL._route_tensors)


def _pair(variant):
    """(port problem, port LsProblem, cuopt_tpu problem, its LsProblem,
    routes from cuopt_tpu's cheapest insertion)."""
    tp = t_build(gh60(t_vrp, variant)[1])
    jp = j_build(gh60(j_vrp, variant)[1])
    routes, _ = cheapest_insertion(jp)
    return (tp, TL.build_ls_problem(tp, device="cpu"), jp,
            JL.build_ls_problem(jp), routes)


def _arrays(prob, routes, headroom=4):
    return JS._routes_to_arrays(prob, routes,
                                JS._pad_len(routes, headroom=headroom))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_scores_close(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    big_a, big_b = a >= BIG / 2, b >= BIG / 2
    assert np.array_equal(big_a, big_b), int((big_a != big_b).sum())
    np.testing.assert_allclose(a[~big_a], b[~big_b], rtol=RTOL, atol=ATOL)


def assert_same_moves(a, b):
    """Packed (K, 6) candidate rows: deltas close; where the moves differ
    the delta is tied within TIE with another candidate of its family."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=RTOL, atol=ATOL)
    assert np.array_equal(a[:, 1], b[:, 1])
    for i in np.flatnonzero(np.any(a[:, 2:] != b[:, 2:], axis=1)):
        fam = a[:, 1] == a[i, 1]
        assert np.sum(np.abs(a[fam, 0] - a[i, 0]) <= TIE) >= 2, (i, a[i])


# the port's own fields: the carried load of pickup-delivery pairs
# (a departure from cuopt_tpu, test_torch_carried_load.py)
PORT_ONLY = ("has_pairs", "pair_next")


@pytest.mark.parametrize("variant", GH60_VARIANTS)
def test_ls_problem_and_route_tensors_match(variant):
    tp, tl, jp, jl, routes = _pair(variant)
    for f in ("has_tw", "allow_2opt", "has_max_cost", "has_prize"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.has_pairs == (variant == "pd")
    if tl.has_pairs:
        want = np.where(tp.pd_sign > 0, tp.pd_partner, -1)
        assert np.array_equal(tl.pair_next.numpy(), want)
    for f in TL.LsProblem.__dataclass_fields__:
        if f in ("has_tw", "allow_2opt", "has_max_cost", "has_prize") + \
                PORT_ONLY:
            continue
        a, b = _np(getattr(tl, f)), np.asarray(getattr(jl, f))
        assert a.dtype == (np.int64 if b.dtype.kind == "i" else b.dtype), f
        assert np.array_equal(a, b), f
    R, lens = _arrays(jp, routes)
    ta = TL._route_tensors(tl, TL._ids(tl, np.array(R)),
                           TL._ids(tl, np.array(lens)))
    ja = j_route_tensors(jl, R, lens)
    for name, x, y in zip(("locs", "arr", "dep", "lat", "load", "ti",
                           "valid"), ta, ja):
        x, y = _np(x), np.asarray(y)
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("variant", GH60_VARIANTS)
def test_evaluators_match(variant):
    """All seven evaluators, on routes from cuopt_tpu's cheapest
    insertion, padded as the local search pads them. The "pd" variant
    is a departure (test_torch_carried_load.py): the port holds the load
    carried after each stop, where cuopt_tpu holds the route's net
    demand, and moves an adjacent pickup and delivery as an Or-opt
    segment, so there the evaluators that see it are held to the host
    walk instead, from the port's own cheapest insertion (cuopt_tpu's
    routes break the carried load)."""
    if variant == "pd":
        return _pd_evaluators_hold_the_host_walk()
    tp, tl, jp, jl, routes = _pair(variant)
    R, lens = _arrays(jp, routes, headroom=12)
    Rn, ln = np.array(R), np.array(lens)  # writable copies for torch

    # the five score tensors behind evaluate_moves / evaluate_moves_topk
    t_scores = TL._move_scores(tl, TL._ids(tl, Rn), TL._ids(tl, ln))
    j_scores = j_move_scores(jl, R, lens)
    for a, b in zip(t_scores, j_scores):
        assert_scores_close(a, b)
    if jl.allow_2opt:
        assert (_np(t_scores[2]) < BIG / 2).any()  # 2-opt was scored

    tb, tk, tm = TL.evaluate_moves(tl, Rn, ln)
    jb, jk, jm = JL.evaluate_moves(jl, R, lens)
    assert abs(float(tb) - float(jb)) <= ATOL + RTOL * abs(float(jb))
    if not np.array_equal(_np(tm), np.asarray(jm)):
        # a tie: the port's move scores within TIE of the best
        k = int(tk)
        sc = np.asarray(j_scores[k])
        at = tuple(int(x) for x in _np(tm))
        at = at[:2] + at[3:] if k == 2 else at
        assert sc[at] <= float(jb) + TIE

    assert_same_moves(TL.evaluate_moves_topk(tl, Rn, ln),
                      JL.evaluate_moves_topk(jl, R, lens))

    cand = np.arange(0, jp.n_serve, 3, dtype=np.int64)
    t_ins = TL.evaluate_insertions(tl, Rn, ln, cand)
    j_ins = JL.evaluate_insertions(jl, R, lens, cand.astype(np.int32))
    assert_scores_close(t_ins, j_ins)
    mask = np.arange(len(cand)) < len(cand) - 2
    a = _np(TL.evaluate_insertions_best(tl, Rn, ln, cand, mask))
    b = np.asarray(JL.evaluate_insertions_best(
        jl, R, lens, cand.astype(np.int32), mask))
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=RTOL, atol=ATOL)
    j_ins = np.asarray(j_ins)
    for i in np.flatnonzero(np.any(a[:, 1:] != b[:, 1:], axis=1)):
        v, j = int(a[i, 1]), int(a[i, 2])
        assert j_ins[i, v, j] <= b[i, 0] + TIE

    tg = [_np(x) for x in TL.evaluate_cycle_gains(tl, Rn, ln)]
    jg = [np.asarray(x) for x in JL.evaluate_cycle_gains(jl, R, lens)]
    assert_scores_close(tg[0], jg[0])
    assert np.array_equal(tg[1], jg[1]) and np.array_equal(tg[2], jg[2])

    tc, tf = TL.evaluate_vehicle_reassign(tl, Rn, ln)
    jc, jf = JL.evaluate_vehicle_reassign(jl, R, lens)
    assert_scores_close(tc, jc)
    assert np.array_equal(_np(tf), np.asarray(jf))

    assert_scores_close(TL.evaluate_prize_drops(tl, Rn, ln),
                        JL.evaluate_prize_drops(jl, R, lens))


def _pd_evaluators_hold_the_host_walk():
    """The "pd" case of test_evaluators_match: relocate, swap, 2-opt*,
    the cycle gains (values, positions and slots), the vehicle
    reassignment costs and the prize drops (no pair moves in any) equal
    cuopt_tpu's; 2-opt, Or-opt and the insertion scores are valid exactly
    where the host walk holds (host_move_scores) with its cost changes as
    deltas, and a route fits a vehicle (evaluate_vehicle_reassign) where
    its carried load does. The reductions over them (evaluate_moves,
    evaluate_moves_topk, evaluate_insertions_best) are held to the same
    reductions of the host's scores, a differing choice only within TIE
    of the host's best, as against cuopt_tpu in the other variants."""
    from cuopt_torch.routing.construction import cheapest_insertion as tci
    from torch_routing_instances import (
        assert_reductions_are_the_host_s,
        carried_ok,
        host_move_scores,
    )

    tp, tl, jp, jl, _ = _pair("pd")
    routes, left = tci(tp)
    assert not left
    assert all(carried_ok(tp, v, r) for v, r in routes.items())
    R, lens = _arrays(jp, routes, headroom=12)
    Rn, ln = np.array(R), np.array(lens)
    t_scores = TL._move_scores(tl, TL._ids(tl, Rn), TL._ids(tl, ln))
    j_scores = j_move_scores(jl, R, lens)
    for k in (0, 1, 3):
        assert_scores_close(t_scores[k], j_scores[k])
    cand = np.arange(0, tp.n_serve, 3)
    L = R.shape[1]
    reloc, swap, two, tail, oro, ins = host_move_scores(tp, routes, L, cand)
    has = np.vectorize(lambda x: x is not None)
    for device, host in ((t_scores[2], two), (t_scores[4], oro),
                         (TL.evaluate_insertions(tl, Rn, ln, cand), ins)):
        device = _np(device)
        assert np.array_equal(device < BIG / 2, has(host))
        np.testing.assert_allclose(device[has(host)],
                                   host[has(host)].astype(float),
                                   rtol=RTOL, atol=ATOL)
    assert_reductions_are_the_host_s(
        TL, tl, Rn, ln, cand, (reloc, swap, two, tail, oro, ins),
        RTOL, ATOL, TIE)
    tg = [_np(x) for x in TL.evaluate_cycle_gains(tl, Rn, ln)]
    jg = [np.asarray(x) for x in JL.evaluate_cycle_gains(jl, R, lens)]
    assert_scores_close(tg[0], jg[0])
    assert np.array_equal(tg[1], jg[1]) and np.array_equal(tg[2], jg[2])
    tc, tf = TL.evaluate_vehicle_reassign(tl, Rn, ln)
    jc, _ = JL.evaluate_vehicle_reassign(jl, R, lens)
    assert_scores_close(tc, jc)
    want = np.array([[bool(routes.get(r)) and carried_ok(tp, v, routes[r])
                      for r in range(tp.n_fleet)]
                     for v in range(tp.n_fleet)])
    assert np.array_equal(_np(tf), want)
    assert_scores_close(TL.evaluate_prize_drops(tl, Rn, ln),
                        JL.evaluate_prize_drops(jl, R, lens))


@pytest.mark.parametrize("variant", GH60_VARIANTS)
def test_cost_neutral_exchanges_score_zero(variant):
    """A deliberate departure: a 2-opt* that leaves the cost as it is
    (two empty tails, or two whole routes swapped between vehicles of
    one start and fixed cost) scores exactly 0 in the port. cuopt_tpu's
    float32 delta there is rounding, as low as -4e-6, below the local
    search's -1e-7, so its local search applied such no-ops as improving
    moves (on the "pd" variant's routes its rounding happens to give 0).
    Elsewhere the scores are held to cuopt_tpu's in
    test_evaluators_match."""
    tp, tl, jp, jl, routes = _pair(variant)
    R, lens = _arrays(jp, routes, headroom=12)
    Rn, ln = np.array(R), np.array(lens)
    ts = _np(TL._move_scores(tl, TL._ids(tl, Rn), TL._ids(tl, ln))[3])
    js = np.asarray(j_move_scores(jl, R, lens)[3])
    cut = np.arange(ts.shape[1])
    i, k = cut[None, :, None, None], cut[None, None, None, :]
    l4 = ln[:, None, None, None]
    start, fixed = np.asarray(jl.veh_start), np.asarray(jl.veh_fixed)
    same = (start[:, None] == start[None, :]) & \
        (fixed[:, None] == fixed[None, :])
    no_op = ((i == l4) & (k == l4.transpose(2, 1, 0, 3))) | \
        ((i == 0) & (k == 0) & same[:, None, :, None])
    live = no_op & (js < BIG / 2)
    assert live.any()
    assert np.array_equal(ts[no_op] < BIG / 2, js[no_op] < BIG / 2)
    assert np.all(ts[live] == 0.0)
    np.testing.assert_allclose(js[live], 0.0, atol=ATOL)
    if variant != "pd":
        assert (js[live] < -1e-7).any()


def test_ties_break_by_index_as_cuopt_tpu():
    """An integer grid with Manhattan costs: every delta is exact, and
    equal deltas tie by the thousand (BIG-masked entries too). The port's
    top-k must pick cuopt_tpu's candidates exactly, lowest index first."""
    tp, jp = t_build(grid_dm(TDataModel)), j_build(grid_dm(JDataModel))
    tl, jl = TL.build_ls_problem(tp, device="cpu"), JL.build_ls_problem(jp)
    assert tl.allow_2opt
    rng = np.random.default_rng(4)
    n_ties = 0
    for _ in range(4):
        routes = random_routes(rng, jp.n_serve, jp.n_fleet)
        R, lens = JS._routes_to_arrays(jp, routes, 24)  # one shape
        a = _np(TL.evaluate_moves_topk(tl, R, lens))
        b = np.asarray(JL.evaluate_moves_topk(jl, R, lens))
        assert np.array_equal(a, b)
        d = a[:, 0][a[:, 0] < BIG / 2]
        n_ties += len(d) - len(np.unique(d))
        scores = TL._move_scores(tl, TL._ids(tl, np.array(R)),
                                 TL._ids(tl, np.array(lens)))
        for s, js in zip(scores, j_move_scores(jl, R, lens)):
            assert np.array_equal(_np(s), np.asarray(js))
    assert n_ties > 10  # the instance really ties


def _sweep_routes(prob, inst):
    """Capacity-feasible routes by angle around the depot."""
    ang = np.arctan2(*(inst.xy[1:] - inst.xy[0]).T[::-1])
    routes = {v: [] for v in range(prob.n_fleet)}
    v, load = 0, 0.0
    for o in np.argsort(ang, kind="stable"):
        if load + inst.demand[o + 1] > inst.capacity:
            v, load = v + 1, 0.0
        routes[v].append(int(o))
        load += inst.demand[o + 1]
    return routes


def test_grouped_moves_match():
    """The tiled evaluation (torch.func.vmap over the tiles' per-vehicle
    fields) against cuopt_tpu's jax.vmap, 8 routes a tile, on a 200-order
    plain CVRP over three rounds' tilings."""
    insts = [vrp.synth_gh_instance(200, "C", seed=1) for vrp in
             (t_vrp, j_vrp)]
    for inst in insts:
        inst.tw_early = inst.tw_late = inst.service = None
    tp, jp = (b(i.to_data_model()) for b, i in zip((t_build, j_build),
                                                    insts))
    tl, jl = TL.build_ls_problem(tp, device="cpu"), JL.build_ls_problem(jp)
    routes = _sweep_routes(jp, insts[1])
    R, lens = _arrays(jp, routes, headroom=12)
    assert jp.n_fleet > 16
    for round_no in range(3):
        a = TS._grouped_moves(tp, tl, np.asarray(R), np.asarray(lens),
                              round_no, group=8)
        b = JS._grouped_moves(jp, jl, R, lens, round_no, group=8)
        assert a.shape == b.shape
        assert_same_moves(a, b)
        assert (a[:, 0] < -1e-7).any()  # improving moves were found


def test_float32_ids_are_exact():
    """Route, slot and position ids travel as float32 in the packed
    readbacks: the evaluators refuse shapes where that is not exact."""
    prob = t_build(grid_dm(TDataModel))
    lsp = TL.build_ls_problem(prob, device="cpu")
    packed = TL.evaluate_moves_topk(lsp, *_arrays(prob, {0: [0, 1]}))
    assert packed.dtype == torch.float32 and packed.shape == (40, 6)
    ids = packed[:, 2:].numpy()
    assert np.array_equal(ids, np.round(ids))
