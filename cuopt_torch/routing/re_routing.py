"""Re-routing: build a re-optimization model that preserves committed work.

Role parity with the reference
python/cuopt/cuopt/routing/re_routing.py:21 (`construct_rerouting_model`):
given an optimized route and a re-route time, classify orders as
fulfilled / partially fulfilled (picked up, not delivered) / uninitiated,
then build a new DataModel where

  - fulfilled orders are dropped,
  - partially-fulfilled pickups become dummy pickups at the carrying
    vehicle's current location, pinned to that vehicle,
  - vehicles start from their current position with earliest time =
    reroute_from_time,
  - new orders are appended.

Same assumptions as the reference: fixed fleet, plan executed on schedule
until reroute time, pickup-and-delivery problems, one demand dimension.
Unlike the reference (which encodes vehicle-order pinning through two
artificial capacity dimensions), this build uses the native
order_vehicle_match constraint.
"""

from __future__ import annotations

import numpy as np

from cuopt_torch.routing.data_model import DataModel
from cuopt_torch.utils.errors import ValidationError


def construct_rerouting_model(
    original_model: DataModel,
    optimized_route,
    reroute_from_time: float,
    new_order_data: dict | None,
    new_distances=None,
):
    """Returns (new_model, order_map) where order_map maps new-model order
    index -> original order index (or ('new', i) for appended orders,
    ('dummy', orig_pickup) for dummy pickups)."""
    if new_order_data is not None:
        required = [
            "order_locations", "earliest_time", "latest_time",
            "service_time", "pickup_indices", "delivery_indices", "demand",
        ]
        for entry in required:
            if entry not in new_order_data:
                raise ValueError(f"{entry} is missing in new order data")

    F = original_model.get_fleet_size()
    L = original_model.get_num_locations()
    if len(original_model.capacity_dimensions) != 1:
        raise ValidationError(
            "re-routing supports exactly one capacity dimension"
        )
    if original_model.pickup_indices is None:
        raise ValidationError("re-routing requires pickup-delivery pairs")

    order_loc = original_model.get_order_locations()
    if order_loc is None:
        order_loc = np.arange(original_model.get_num_orders())
    early, late = original_model.order_tw
    service = original_model.order_service_times.get(-1)
    if service is None:
        service = np.zeros(len(order_loc))
    (dname, (demand, capacity)), = \
        original_model.capacity_dimensions.items()
    picks = list(map(int, original_model.pickup_indices))
    drops = list(map(int, original_model.delivery_indices))
    delivery_of = dict(zip(picks, drops))
    pickup_of = dict(zip(drops, picks))

    # replay the optimized route up to reroute_from_time, on the table's
    # columns: any object with `columns` and column access by name (the
    # port's RouteTable, or a pandas DataFrame)
    route = np.asarray(optimized_route["route"]).astype(np.int64)
    stamp = np.asarray(optimized_route["arrival_stamp"], np.float64)
    truck = np.asarray(optimized_route["truck_id"]).astype(np.int64)
    where = np.asarray(optimized_route["location"]).astype(np.int64)
    is_order = np.ones(len(route), bool)
    if "type" in optimized_route.columns:
        kind = np.asarray(optimized_route["type"], object)
        is_order = (kind != "Depot") & (kind != "Break")
    done = set()  # orders already visited by reroute time
    veh_pos = {}  # vehicle -> (location, free_time)
    for v in np.unique(truck).tolist():
        sub = np.flatnonzero(truck == v)
        # stable: rows with equal stamps keep their route order
        sub = sub[np.argsort(stamp[sub], kind="stable")]
        loc = int(where[sub[0]])
        free = reroute_from_time
        for i in sub[is_order[sub]].tolist():
            o = int(route[i])
            t = float(stamp[i])
            fin = t + float(service[o])
            if t <= reroute_from_time:
                # assumption 3: an order being serviced is finished first
                done.add(o)
                loc = int(order_loc[o])
                free = max(free, fin)
        veh_pos[int(v)] = (loc, free)

    # classify
    new_orders = []  # (loc, early, late, service, demand, tag)
    pin = {}  # new order idx -> vehicle id
    pairs = []  # (pickup new idx, delivery new idx)
    order_map = {}

    def add(loc, e, lt, s, d, tag):
        new_orders.append((int(loc), float(e), float(lt), float(s),
                           float(d), tag))
        order_map[len(new_orders) - 1] = tag
        return len(new_orders) - 1

    for p, d in zip(picks, drops):
        if p in done and d in done:
            continue  # fulfilled
        if p in done:  # partially fulfilled: dummy pickup on the vehicle
            # the vehicle that picked p up: Depot and Break rows carry
            # route 0 too, so only order rows are searched
            veh = int(truck[np.flatnonzero(is_order & (route == p))[0]])
            loc, free = veh_pos.get(veh, (0, reroute_from_time))
            pi = add(loc, reroute_from_time, max(float(late[d]), free),
                     0.0, float(demand[p]), ("dummy", p))
            di = add(order_loc[d], early[d], late[d], service[d],
                     demand[d], d)
            pin[pi] = veh
            pin[di] = veh
            pairs.append((pi, di))
        else:  # uninitiated
            pi = add(order_loc[p], max(float(early[p]), reroute_from_time),
                     late[p], service[p], demand[p], p)
            di = add(order_loc[d], max(float(early[d]), reroute_from_time),
                     late[d], service[d], demand[d], d)
            pairs.append((pi, di))

    if new_order_data is not None:
        base = len(new_orders)
        for i, loc in enumerate(new_order_data["order_locations"]):
            add(loc, new_order_data["earliest_time"][i],
                new_order_data["latest_time"][i],
                new_order_data["service_time"][i],
                new_order_data["demand"][i], ("new", i))
        for p, d in zip(new_order_data["pickup_indices"],
                        new_order_data["delivery_indices"]):
            pairs.append((base + int(p), base + int(d)))

    n_new = len(new_orders)
    dm = DataModel(L, F, n_orders=max(n_new, 1))
    mats = original_model.cost_matrices if new_distances is None else {
        t: np.asarray(new_distances, float)
        for t in original_model.cost_matrices
    }
    for t, m in mats.items():
        dm.add_cost_matrix(m, vehicle_type=t)
    for t, m in original_model.transit_time_matrices.items():
        dm.add_transit_time_matrix(
            m if new_distances is None else np.asarray(new_distances),
            vehicle_type=t,
        )
    if original_model.vehicle_types is not None:
        dm.set_vehicle_types(original_model.vehicle_types)
    if n_new:
        dm.set_order_locations([o[0] for o in new_orders])
        dm.set_order_time_windows(
            [o[1] for o in new_orders], [o[2] for o in new_orders]
        )
        dm.set_order_service_times([o[3] for o in new_orders])
        dm.add_capacity_dimension(
            dname, [o[4] for o in new_orders], capacity
        )
        if pairs:
            dm.set_pickup_delivery_pairs(
                [p for p, _ in pairs], [d for _, d in pairs]
            )
        for o, v in pin.items():
            dm.add_order_vehicle_match(o, [v])
    # vehicles resume from their current position at the reroute time
    starts = [veh_pos.get(v, (0, reroute_from_time))[0] for v in range(F)]
    frees = [veh_pos.get(v, (0, reroute_from_time))[1] for v in range(F)]
    ret = original_model.vehicle_return if \
        original_model.vehicle_return is not None else np.zeros(F, int)
    dm.set_vehicle_locations(starts, ret)
    v_late = original_model.vehicle_tw[1] if original_model.vehicle_tw \
        is not None else np.full(F, np.inf)
    dm.set_vehicle_time_windows(frees, v_late)
    return dm, order_map
