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
