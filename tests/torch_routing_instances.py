"""Seeded routing instances for the cuopt_torch routing tests, built for
either package: each function takes that package's `io.vrp` module, so
both packages get the same arrays."""

import numpy as np

GH60_VARIANTS = ("tw", "no-tw", "max-cost-time", "prizes", "pd", "hetero")


def gh60(vrp, variant="tw"):
    """synth_gh_instance(60, "R", seed=9) as a DataModel, in one of the
    GH60_VARIANTS: with its time windows; as a plain CVRP (symmetric, no
    time windows, so 2-opt is scored); with per-vehicle max cost 300 and
    max time 2000 (tests/test_local_search_moves.py:203); with seeded
    prizes; with orders i and i + 30 as pickup-delivery pairs; with two
    vehicle types (the second's matrix 1.3 times the first, half the
    capacity and a fixed cost of 50)."""
    inst = vrp.synth_gh_instance(60, "R", seed=9)
    if variant in ("no-tw", "pd", "hetero"):
        inst.tw_early = inst.tw_late = inst.service = None
    if variant == "pd":
        d = inst.demand.copy()
        d[31:] = -d[1:31]
        inst.demand = d
    dm = inst.to_data_model()
    nv = inst.n_vehicles
    if variant == "max-cost-time":
        dm.set_vehicle_max_costs(np.full(nv, 300.0))
        dm.set_vehicle_max_times(np.full(nv, 2000.0))
    elif variant == "prizes":
        rng = np.random.default_rng(3)
        dm.set_order_prizes(rng.uniform(5.0, 60.0, 60))
    elif variant == "pd":
        dm.set_pickup_delivery_pairs(np.arange(30), np.arange(30, 60))
    elif variant == "hetero":
        dm.add_cost_matrix(1.3 * inst.cost_matrix(), vehicle_type=1)
        dm.set_vehicle_types(np.arange(nv) % 2)
        cap = np.where(np.arange(nv) % 2, 0.5, 1.0) * inst.capacity
        dm.capacity_dimensions.clear()
        dm.add_capacity_dimension("demand", inst.demand[1:], cap)
        dm.set_vehicle_fixed_costs(np.where(np.arange(nv) % 2, 50.0, 0.0))
    return inst, dm


def grid_dm(DataModel, n_side=4, fleet=4):
    """Customers on an integer grid, Manhattan distances, unit demands:
    every cost and delta is an exact small integer in float32, so equal
    deltas tie exactly, by the thousand."""
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side))
    pts = np.stack([xs.ravel(), ys.ravel()], 1)
    pts = np.concatenate([[[1.5, 1.5]], pts])
    cost = np.abs(pts[:, None] - pts[None]).sum(-1)
    n = len(pts)
    dm = DataModel(n, fleet, n - 1)
    dm.add_cost_matrix(cost)
    dm.set_order_locations(np.arange(1, n))
    dm.add_capacity_dimension("w", np.ones(n - 1), np.full(fleet, n))
    return dm


def random_routes(rng, n_serve, n_fleet):
    """A random split of a random order permutation into n_fleet routes."""
    orders = rng.permutation(n_serve)
    cuts = np.sort(rng.choice(n_serve + 1, n_fleet - 1))
    bounds = list(cuts) + [n_serve]
    routes, lo = {}, 0
    for v in range(n_fleet):
        routes[v] = [int(o) for o in orders[lo:bounds[v]]]
        lo = bounds[v]
    return routes


def pd_wide(vrp, n=60, kind="R", seed=9):
    """synth_gh_instance(n, kind, seed) as pickup-delivery pairs (order i
    with i + n/2, the delivery's demand minus the pickup's, as gh60's
    "pd" variant), every order's window [0, the depot's close], the
    instance's service times. chip_smoke.py's phase 20 builds GHC_200_1
    the same way."""
    inst = vrp.synth_gh_instance(n, kind, seed=seed)
    h = n // 2
    d = inst.demand.copy()
    d[1 + h:] = -d[1:1 + h]
    inst.demand = d
    inst.tw_early = inst.tw_early.copy()
    inst.tw_late = inst.tw_late.copy()
    inst.tw_early[1:] = 0.0
    inst.tw_late[1:] = inst.tw_late[0]
    dm = inst.to_data_model()
    dm.set_pickup_delivery_pairs(np.arange(h), np.arange(h, n))
    return inst, dm


def pd_mixed(vrp, build, n=30, seed=4, capacity=60.0):
    """A routing problem (`build` applied to a DataModel) on
    synth_gh_instance(n, "R", seed) without time windows, its capacity
    `capacity`: orders i and i + n/2 (i < n/3) a pickup-delivery pair
    (the delivery's demand minus the pickup's), the other orders
    unpaired with their own demands. The DataModel asks for every order
    in a pair, so the problem's pair arrays are cut afterwards, as
    build_problem cuts a pair whose partner it does not serve. At 60 the
    load carried between a pickup and its delivery binds."""
    inst = vrp.synth_gh_instance(n, "R", seed=seed, capacity=capacity)
    inst.tw_early = inst.tw_late = inst.service = None
    h = n // 2
    d = inst.demand.copy()
    d[1 + h:] = -d[1:1 + h]
    inst.demand = d
    dm = inst.to_data_model()
    dm.set_pickup_delivery_pairs(np.arange(h), np.arange(h, n))
    prob = build(dm)
    k = n // 3
    single = [o for o in range(n) if k <= o % h]
    prob.pd_partner[single] = -1
    prob.pd_sign[single] = 0
    prob.demand[:, single] = np.abs(prob.demand[:, single])
    return prob


def carried_ok(prob, v, route):
    """The host walk: after each stop of `route`, the load vehicle v
    carries (every demand so far summed) stays within its capacity, in
    every dimension."""
    load = np.zeros(prob.demand.shape[0])
    for o in route:
        load = load + prob.demand[:, o]
        if np.any(load > prob.capacity[:, v] + 1e-9):
            return False
    return True


def host_move_scores(prob, routes, L, cand=()):
    """Host reference of the port's five move-score tensors (relocate,
    swap, 2-opt, 2-opt*, Or-opt) and of its insertion scores of the
    orders `cand`, on an instance without time windows, max cost, order
    pins or vehicle types: each candidate move is applied to a copy of
    the routes and is valid where the evaluator's structure allows it
    (slot in range, orders movable, the routes fit in the padded width
    L) and carried_ok holds for every route it changes. Valid entries
    hold the change of route_cost, the rest None. A pickup and its
    delivery move only together, as an adjacent Or-opt segment; 2-opt
    may reverse a pair (the host recheck rejects that)."""
    F = prob.n_fleet
    r = {v: list(routes.get(v, [])) for v in range(F)}
    n = {v: len(r[v]) for v in range(F)}
    paired = prob.pd_partner >= 0
    nxt = np.where(prob.pd_sign > 0, prob.pd_partner, -1)

    def score(changed):
        if not all(carried_ok(prob, v, x) for v, x in changed.items()):
            return None
        return sum(prob.route_cost(v, x) - prob.route_cost(v, r[v])
                   for v, x in changed.items())

    reloc = np.full((F, L + 1, F, L), None)
    oro = np.full((F, L + 1, F, L), None)
    swap = np.full((F, L, F, L), None)
    two = np.full((F, L, L), None)
    tail = np.full((F, L + 1, F, L + 1), None)
    for f1 in range(F):
        for i in range(n[f1]):
            u = r[f1][i]
            seg = r[f1][i:i + 2]
            seg_ok = len(seg) == 2 and (
                not paired[seg].any() or nxt[seg[0]] == seg[1])
            for f2 in range(F):
                if f2 == f1:
                    continue
                for j in range(n[f2] + 1):
                    rest = r[f1][:i] + r[f1][i + 1:]
                    if not paired[u] and n[f2] + 1 <= L:
                        reloc[f2, j, f1, i] = score({
                            f1: rest, f2: r[f2][:j] + [u] + r[f2][j:]})
                    if seg_ok and n[f2] + 2 <= L:
                        oro[f2, j, f1, i] = score({
                            f1: r[f1][:i] + r[f1][i + 2:],
                            f2: r[f2][:j] + seg + r[f2][j:]})
                for k in range(n[f2]):
                    w = r[f2][k]
                    if not paired[u] and not paired[w]:
                        a, b = list(r[f1]), list(r[f2])
                        a[i], b[k] = w, u
                        swap[f1, i, f2, k] = score({f1: a, f2: b})
        for i in range(n[f1]):
            for k in range(i + 1, n[f1]):
                x = r[f1][:i] + r[f1][i:k + 1][::-1] + r[f1][k + 1:]
                two[f1, i, k] = score({f1: x})
        for f2 in range(F):
            if f2 == f1:
                continue
            for i in range(n[f1] + 1):
                for k in range(n[f2] + 1):
                    t1, t2 = r[f1][i:], r[f2][k:]
                    if paired[t1 + t2].any() or i + len(t2) > L or \
                            k + len(t1) > L:
                        continue
                    tail[f1, i, f2, k] = score({f1: r[f1][:i] + t2,
                                                f2: r[f2][:k] + t1})
    ins = np.full((len(cand), F, L + 1), None)
    for c, o in enumerate(cand):
        for f in range(F):
            for j in range(n[f] + 1):
                if n[f] + 1 <= L:
                    ins[c, f, j] = score({f: r[f][:j] + [o] + r[f][j:]})
    return reloc, swap, two, tail, oro, ins


def assert_reductions_are_the_host_s(TL, lsp, R, lens, cand, host,
                                     rtol=1e-5, atol=1e-3, tie=1e-3,
                                     kf=8):
    """The port's reductions over its move and insertion scores, held to
    the same reductions of host_move_scores' output `host` (None is
    BIG): evaluate_moves' best delta is the host's best and its move
    scores within `tie` of it on the host; evaluate_moves_topk's kf rows
    of each family are the family's kf smallest host entries (deltas
    close, each row's move scored so on the host; rows past the host's
    live entries BIG); evaluate_insertions_best's best per candidate
    (the last two masked out) is the host's, its (route, slot) within
    `tie` of it on the host."""
    big = TL.BIG
    hosts = [np.where(np.vectorize(lambda x: x is None)(h), big,
                      h).astype(np.float64) for h in host]
    moves, ins = hosts[:5], hosts[5]

    def close(a, b):
        return abs(a - b) <= atol + rtol * abs(b)

    def at(kind, row):
        m = tuple(int(x) for x in row)
        return m[:2] + m[3:] if kind == 2 else m

    h_best = min(float(h.min()) for h in moves)
    tb, tk, tm = TL.evaluate_moves(lsp, R, lens)
    assert close(float(tb), h_best)
    assert moves[int(tk)][at(int(tk), np.asarray(tm))] <= h_best + tie
    topk = np.asarray(TL.evaluate_moves_topk(lsp, R, lens, kf))
    for k, h in enumerate(moves):
        rows = topk[k * kf:(k + 1) * kf]
        assert np.all(rows[:, 1] == k)
        want = np.sort(h.ravel())[:kf]
        live = want < big / 2
        np.testing.assert_allclose(rows[live, 0], want[live], rtol=rtol,
                                   atol=atol)
        assert np.all(rows[~live, 0] >= big / 2)
        for row in rows[live]:
            assert close(h[at(k, row[2:])], row[0])
    mask = np.arange(len(cand)) < len(cand) - 2
    best = np.asarray(TL.evaluate_insertions_best(lsp, R, lens, cand, mask))
    want = np.where(mask, ins.reshape(len(cand), -1).min(axis=1), big)
    np.testing.assert_allclose(best[:, 0], want, rtol=rtol, atol=atol)
    for i in np.flatnonzero(mask & (want < big / 2)):
        assert ins[i, int(best[i, 1]), int(best[i, 2])] <= want[i] + tie
