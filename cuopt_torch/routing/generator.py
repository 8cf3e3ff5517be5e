"""Synthetic routing instance generator.

Role parity with the reference generator
(cpp/src/routing/generator/, `dataset_params_t` at
include/cuopt/routing/cython/generator.hpp:42-62): clustered or random
location distributions, demand ranges, time-window tightness, vehicle
shifts, heterogeneous vehicle types, breaks, pickup-delivery pairing.
Used by tests and benchmarks to create instances of any size without
network downloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cuopt_torch.routing.data_model import DataModel


@dataclass
class DatasetParams:
    """Mirrors reference dataset_params_t (generator.hpp:42-62)."""

    n_locations: int = 100
    asymmetric: bool = False
    dim: int = 2
    # demand range per capacity dimension
    min_demand: int = 1
    max_demand: int = 9
    min_capacities: int = 100
    max_capacities: int = 100
    # time windows
    min_service_time: float = 0.0
    max_service_time: float = 10.0
    tw_tightness: float = 0.0  # 0 = no TWs, towards 1 = tighter windows
    drop_return_trips: float = 0.0  # fraction of vehicles
    n_shifts: int = 1
    n_vehicle_types: int = 1
    n_matrix_types: int = 1
    break_dim: int = 0
    center_box: tuple = (0.0, 1000.0)
    distrib: str = "clustered"  # 'clustered' | 'random'
    n_clusters: int = 5
    seed: int = 0
    fleet_size: int = 0  # 0 = auto (n_locations // 10 + 1)
    pickup_delivery: bool = False


def generate_coordinates(params: DatasetParams, rng):
    lo, hi = params.center_box
    n = params.n_locations
    if params.distrib == "clustered":
        k = max(1, params.n_clusters)
        centers = rng.uniform(lo, hi, (k, params.dim))
        which = rng.integers(0, k, n)
        spread = (hi - lo) / (4.0 * k)
        pts = centers[which] + rng.normal(0.0, spread, (n, params.dim))
        return np.clip(pts, lo, hi)
    return rng.uniform(lo, hi, (n, params.dim))


def generate_dataset(params: DatasetParams) -> DataModel:
    """Build a DataModel for a synthetic VRP instance. Location 0 is the
    depot."""
    rng = np.random.default_rng(params.seed)
    n = params.n_locations
    pts = generate_coordinates(params, rng)
    mat = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    if params.asymmetric:
        skew = rng.uniform(1.0, 1.2, mat.shape)
        mat = mat * skew
        np.fill_diagonal(mat, 0.0)

    fleet = params.fleet_size or (n // 10 + 1)
    # PDP instances are order-indexed: pairs must cover every order, so
    # orders are the 2m non-depot locations (pickups then deliveries)
    n_pairs = (n - 1) // 2 if params.pickup_delivery else 0
    n_orders = 2 * n_pairs if params.pickup_delivery else n
    dm = DataModel(n, fleet, n_orders=n_orders if params.pickup_delivery
                   else -1)
    n_types = max(1, params.n_vehicle_types)
    vt = rng.integers(0, n_types, fleet)
    dm.set_vehicle_types(vt)
    for t in range(n_types):
        scale = 1.0 + 0.1 * t if params.n_matrix_types > 1 else 1.0
        dm.add_cost_matrix(mat * scale, vehicle_type=t)
        dm.add_transit_time_matrix(mat * scale, vehicle_type=t)

    cap = rng.integers(
        params.min_capacities, params.max_capacities + 1, fleet
    )
    if params.pickup_delivery:
        order_locs = np.arange(1, 1 + n_orders)
        dm.set_order_locations(order_locs)
        pair_dem = rng.integers(
            params.min_demand, params.max_demand + 1, n_pairs
        )
        demand = np.concatenate([pair_dem, -pair_dem])
        service = rng.uniform(
            params.min_service_time, params.max_service_time, n_orders
        )
    else:
        demand = rng.integers(params.min_demand, params.max_demand + 1, n)
        demand[0] = 0
        service = rng.uniform(
            params.min_service_time, params.max_service_time, n
        )
        service[0] = 0.0
    dm.add_capacity_dimension("demand", demand, cap)
    dm.set_order_service_times(service)

    # horizon from a rough route-length estimate
    horizon = float(np.percentile(mat, 90) * max(4, n // fleet + 2))
    if params.tw_tightness > 0:
        n_tw = n_orders if params.pickup_delivery else n
        width = horizon * (1.0 - 0.9 * min(params.tw_tightness, 1.0))
        early = rng.uniform(0.0, horizon - width, n_tw)
        late = early + width
        if not params.pickup_delivery:
            early[0] = 0.0
            late[0] = horizon * 2
        else:
            # deliveries must be reachable after their pickups
            early[n_pairs:] = np.maximum(
                early[n_pairs:], early[:n_pairs]
            )
            late[n_pairs:] = early[n_pairs:] + width
        dm.set_order_time_windows(early, late)
        shift_len = horizon * 2 / max(1, params.n_shifts)
        shift_id = rng.integers(0, max(1, params.n_shifts), fleet)
        dm.set_vehicle_time_windows(
            shift_id * 0.0,  # all shifts start at 0 for feasibility
            (shift_id + 1) * shift_len + horizon,
        )
    if params.drop_return_trips > 0:
        dm.set_drop_return_trips(
            rng.uniform(0, 1, fleet) < params.drop_return_trips
        )
    for _ in range(params.break_dim):
        b_early = rng.uniform(0.2 * horizon, 0.4 * horizon, fleet)
        b_late = b_early + 0.3 * horizon
        b_dur = np.full(fleet, 0.02 * horizon)
        dm.add_break_dimension(b_early, b_late, b_dur)
    if params.pickup_delivery:
        dm.set_pickup_delivery_pairs(
            np.arange(n_pairs), np.arange(n_pairs, 2 * n_pairs)
        )
    return dm
