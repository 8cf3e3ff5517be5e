"""Routing DataModel.

API parity with the reference Python `cuopt.routing.DataModel`
(python/cuopt/cuopt/routing/vehicle_routing.py:34, setter surface :82-1398)
over the C++ `data_model_view_t`
(cpp/include/cuopt/routing/data_model_view.hpp:86-399): cost/time matrices
per vehicle type, order locations/time windows/demands/service times/
prizes, pickup-delivery pairs, vehicle locations/time windows/capacities/
fixed costs/max cost/max time, order-vehicle matching, breaks, min
vehicles, drop-return/skip-first flags, initial solutions.
"""

from __future__ import annotations

import numpy as np

from cuopt_torch.utils.errors import ValidationError


def _as2d(mat):
    a = np.asarray(mat, dtype=np.float64)
    if hasattr(mat, "to_numpy"):  # DataFrame-likes
        a = np.asarray(mat.to_numpy(), dtype=np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValidationError("cost matrix must be square")
    return a


class DataModel:
    def __init__(self, n_locations: int, n_fleet: int, n_orders: int = -1):
        if n_locations <= 0 or n_fleet <= 0:
            raise ValidationError("n_locations and n_fleet must be positive")
        self.n_locations = int(n_locations)
        self.n_fleet = int(n_fleet)
        # reference semantics: orders default to the locations themselves
        self.n_orders = int(n_orders) if n_orders > 0 else int(n_locations)
        self.cost_matrices: dict[int, np.ndarray] = {}
        self.transit_time_matrices: dict[int, np.ndarray] = {}
        self.order_locations: np.ndarray | None = None
        self.order_tw: tuple[np.ndarray, np.ndarray] | None = None
        self.order_prizes: np.ndarray | None = None
        self.order_service_times: dict[int, np.ndarray] = {}
        self.pickup_indices: np.ndarray | None = None
        self.delivery_indices: np.ndarray | None = None
        self.vehicle_types: np.ndarray | None = None
        self.vehicle_tw: tuple[np.ndarray, np.ndarray] | None = None
        self.vehicle_start: np.ndarray | None = None
        self.vehicle_return: np.ndarray | None = None
        self.vehicle_max_costs: np.ndarray | None = None
        self.vehicle_max_times: np.ndarray | None = None
        self.vehicle_fixed_costs: np.ndarray | None = None
        self.drop_return_trips: np.ndarray | None = None
        self.skip_first_trips: np.ndarray | None = None
        self.capacity_dimensions: dict[str, tuple[np.ndarray, np.ndarray]] \
            = {}
        self.vehicle_order_match: dict[int, np.ndarray] = {}
        self.order_vehicle_match: dict[int, np.ndarray] = {}
        self.break_locations: np.ndarray | None = None
        self.break_dimensions: list[dict] = []
        self.vehicle_breaks: list[dict] = []
        self.min_vehicles: int = 0
        self.objectives: list[int] = []
        self.objective_weights: list[float] = []
        self.initial_solutions: list = []
        # order precedence: order_id -> np.ndarray of preceding order ids
        # (reference data_model_view.hpp:368 add_order_precedence)
        self.order_precedence: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ matrices
    def add_cost_matrix(self, cost_mat, vehicle_type: int = 0):
        a = _as2d(cost_mat)
        if a.shape[0] != self.n_locations:
            raise ValidationError(
                f"cost matrix size {a.shape[0]} != n_locations "
                f"{self.n_locations}"
            )
        if np.any(a < 0):
            raise ValidationError("cost matrix entries must be >= 0")
        self.cost_matrices[int(vehicle_type)] = a

    def add_transit_time_matrix(self, mat, vehicle_type: int = 0):
        a = _as2d(mat)
        if a.shape[0] != self.n_locations:
            raise ValidationError("transit time matrix size mismatch")
        self.transit_time_matrices[int(vehicle_type)] = a

    # -------------------------------------------------------------- orders
    def set_order_locations(self, order_locations):
        a = np.asarray(order_locations, dtype=np.int64)
        if len(a) != self.n_orders:
            # reference allows redefining the order count via locations
            self.n_orders = len(a)
        if np.any(a < 0) or np.any(a >= self.n_locations):
            raise ValidationError("order location out of range")
        self.order_locations = a

    def set_order_time_windows(self, earliest, latest):
        e = np.asarray(earliest, dtype=np.float64)
        l_ = np.asarray(latest, dtype=np.float64)
        if len(e) != self.n_orders or len(l_) != self.n_orders:
            raise ValidationError("order time window length mismatch")
        if np.any(e > l_):
            raise ValidationError("order earliest > latest")
        self.order_tw = (e, l_)

    def set_order_service_times(self, service_times, vehicle_id: int = -1):
        s = np.asarray(service_times, dtype=np.float64)
        if len(s) != self.n_orders:
            raise ValidationError("service times length mismatch")
        if np.any(s < 0):
            raise ValidationError("service times must be >= 0")
        self.order_service_times[int(vehicle_id)] = s

    def set_order_prizes(self, prizes):
        p = np.asarray(prizes, dtype=np.float64)
        if len(p) != self.n_orders:
            raise ValidationError("prizes length mismatch")
        self.order_prizes = p

    def set_pickup_delivery_pairs(self, pickup_indices, delivery_indices):
        p = np.asarray(pickup_indices, dtype=np.int64)
        d = np.asarray(delivery_indices, dtype=np.int64)
        if len(p) != len(d):
            raise ValidationError("pickup/delivery length mismatch")
        if 2 * len(p) != self.n_orders:
            raise ValidationError(
                "pickup-delivery pairs must cover all orders"
            )
        self.pickup_indices = p
        self.delivery_indices = d

    # --------------------------------------------------------------- fleet
    def set_vehicle_types(self, vehicle_types):
        t = np.asarray(vehicle_types, dtype=np.int64)
        if len(t) != self.n_fleet:
            raise ValidationError("vehicle types length mismatch")
        self.vehicle_types = t

    def set_vehicle_time_windows(self, earliest_time, latest_time):
        e = np.asarray(earliest_time, dtype=np.float64)
        l_ = np.asarray(latest_time, dtype=np.float64)
        if len(e) != self.n_fleet or len(l_) != self.n_fleet:
            raise ValidationError("vehicle time window length mismatch")
        self.vehicle_tw = (e, l_)

    def set_vehicle_locations(self, start_locations, return_locations):
        s = np.asarray(start_locations, dtype=np.int64)
        r = np.asarray(return_locations, dtype=np.int64)
        if len(s) != self.n_fleet or len(r) != self.n_fleet:
            raise ValidationError("vehicle locations length mismatch")
        if np.any((s < 0) | (s >= self.n_locations)):
            raise ValidationError("vehicle start location out of range")
        if np.any((r < 0) | (r >= self.n_locations)):
            raise ValidationError("vehicle return location out of range")
        self.vehicle_start = s
        self.vehicle_return = r

    def set_vehicle_max_costs(self, vehicle_max_costs):
        self.vehicle_max_costs = np.asarray(vehicle_max_costs, np.float64)

    def set_vehicle_max_times(self, vehicle_max_times):
        self.vehicle_max_times = np.asarray(vehicle_max_times, np.float64)

    def set_vehicle_fixed_costs(self, vehicle_fixed_costs):
        self.vehicle_fixed_costs = np.asarray(
            vehicle_fixed_costs, np.float64
        )

    def set_drop_return_trips(self, drop):
        self.drop_return_trips = np.asarray(drop, bool)

    def set_skip_first_trips(self, skip):
        self.skip_first_trips = np.asarray(skip, bool)

    def add_capacity_dimension(self, name, demand, capacity):
        d = np.asarray(demand, dtype=np.float64)
        c = np.asarray(capacity, dtype=np.float64)
        if len(d) != self.n_orders:
            raise ValidationError("demand length mismatch")
        if len(c) != self.n_fleet:
            raise ValidationError("capacity length mismatch")
        self.capacity_dimensions[str(name)] = (d, c)

    def add_vehicle_order_match(self, vehicle_id, orders):
        self.vehicle_order_match[int(vehicle_id)] = np.asarray(
            orders, np.int64
        )

    def add_order_vehicle_match(self, order_id, vehicles):
        self.order_vehicle_match[int(order_id)] = np.asarray(
            vehicles, np.int64
        )

    def set_min_vehicles(self, min_vehicles):
        self.min_vehicles = int(min_vehicles)

    # -------------------------------------------------------------- breaks
    def set_break_locations(self, break_locations):
        self.break_locations = np.asarray(break_locations, np.int64)

    def add_break_dimension(self, earliest, latest, duration):
        self.break_dimensions.append(dict(
            earliest=np.asarray(earliest, np.float64),
            latest=np.asarray(latest, np.float64),
            duration=np.asarray(duration, np.float64),
        ))

    def add_vehicle_break(self, vehicle_id, earliest, latest, duration,
                          locations=None):
        self.vehicle_breaks.append(dict(
            vehicle_id=int(vehicle_id), earliest=float(earliest),
            latest=float(latest), duration=float(duration),
            locations=None if locations is None
            else np.asarray(locations, np.int64),
        ))

    # ----------------------------------------------------------- objective
    def set_objective_function(self, objectives, objective_weights):
        if len(list(objectives)) != len(list(objective_weights)):
            raise ValidationError(
                "objectives and objective_weights must have equal length"
            )
        self.objectives = [int(o) for o in objectives]
        self.objective_weights = [float(w) for w in objective_weights]

    # ---------------------------------------------------------- precedence
    def add_order_precedence(self, order_id, preceding_orders):
        """Order `order_id` must be scheduled after every order in
        `preceding_orders` (reference data_model_view.hpp:359-368;
        circular dependencies rejected at validate())."""
        order_id = int(order_id)
        preds = np.asarray(preceding_orders, np.int64).ravel()
        if order_id < 0 or order_id >= self.n_orders:
            raise ValidationError(
                f"precedence order id {order_id} out of range"
            )
        if np.any(preds < 0) or np.any(preds >= self.n_orders):
            raise ValidationError("preceding order id out of range")
        if np.any(preds == order_id):
            raise ValidationError(
                "an order cannot precede itself"
            )
        self.order_precedence[order_id] = preds

    def get_order_precedence(self):
        return dict(self.order_precedence)

    def add_initial_solutions(self, vehicle_ids, routes, types, sol_offsets):
        self.initial_solutions.append(
            (vehicle_ids, routes, types, sol_offsets)
        )

    # ------------------------------------------------------------- getters
    def get_num_locations(self):
        return self.n_locations

    def get_fleet_size(self):
        return self.n_fleet

    def get_num_orders(self):
        return self.n_orders

    def get_cost_matrix(self, vehicle_type=0):
        return self.cost_matrices.get(int(vehicle_type))

    def get_transit_time_matrix(self, vehicle_type=0):
        return self.transit_time_matrices.get(int(vehicle_type))

    def get_transit_time_matrices(self):
        return self.transit_time_matrices

    def get_order_locations(self):
        return self.order_locations

    def get_vehicle_types(self):
        return self.vehicle_types

    def get_pickup_delivery_pairs(self):
        return (self.pickup_indices, self.delivery_indices)

    def get_vehicle_time_windows(self):
        return self.vehicle_tw

    def get_vehicle_locations(self):
        return (self.vehicle_start, self.vehicle_return)

    def get_capacity_dimensions(self):
        return self.capacity_dimensions

    def get_order_time_windows(self):
        return self.order_tw

    def get_order_prizes(self):
        return self.order_prizes

    def get_order_service_times(self, vehicle_id=-1):
        return self.order_service_times.get(int(vehicle_id))

    def get_vehicle_max_costs(self):
        return self.vehicle_max_costs

    def get_vehicle_max_times(self):
        return self.vehicle_max_times

    def get_vehicle_fixed_costs(self):
        return self.vehicle_fixed_costs

    def get_min_vehicles(self):
        return self.min_vehicles

    def get_objective_function(self):
        return (self.objectives, self.objective_weights)

    def get_drop_return_trips(self):
        return self.drop_return_trips

    def get_skip_first_trips(self):
        return self.skip_first_trips

    def get_vehicle_order_match(self):
        return self.vehicle_order_match

    def get_order_vehicle_match(self):
        return self.order_vehicle_match

    def get_break_locations(self):
        return self.break_locations

    def get_break_dimensions(self):
        return self.break_dimensions

    def get_initial_solutions(self):
        return self.initial_solutions

    # ---------------------------------------------------------- validation
    def validate(self):
        if not self.cost_matrices:
            raise ValidationError("at least one cost matrix is required")
        if self.vehicle_types is not None:
            for t in np.unique(self.vehicle_types):
                if int(t) not in self.cost_matrices:
                    raise ValidationError(
                        f"no cost matrix for vehicle type {t}"
                    )
        if self.order_tw is not None and self.transit_time_matrices == {} \
                and len(self.cost_matrices) > 0:
            pass  # cost matrix doubles as time matrix (reference behavior)
        if self.pickup_indices is not None:
            both = np.concatenate(
                [self.pickup_indices, self.delivery_indices]
            )
            if len(np.unique(both)) != self.n_orders:
                raise ValidationError(
                    "pickup/delivery pairs must partition the orders"
                )
        if self.order_precedence:
            # reject circular dependencies (reference data_model_view.hpp:
            # "Currently circular dependencies are not accepted")
            color = {}  # 0 visiting, 1 done

            def _dfs(o, stack):
                if color.get(o) == 1:
                    return
                if color.get(o) == 0:
                    raise ValidationError(
                        "circular order precedence detected at order "
                        f"{o}"
                    )
                color[o] = 0
                for p in self.order_precedence.get(o, ()):  # noqa: B023
                    _dfs(int(p), stack)
                color[o] = 1

            for o in list(self.order_precedence):
                _dfs(int(o), [])
