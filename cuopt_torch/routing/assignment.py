"""Routing Assignment result object.

Mirrors reference cuopt.routing.Assignment
(python/cuopt/cuopt/routing/assignment.py:28: vehicle_count, objective
values, route dataframe with route/arrival_stamp/truck_id/location,
status SUCCESS/FAIL/TIMEOUT/EMPTY, infeasible orders). cuopt_tpu returns
the routes as a pandas DataFrame; the port returns a `RouteTable` of
numpy columns: the machine with the card has no pandas, and the port
imports none.
"""

from __future__ import annotations

from enum import Enum, IntEnum

import numpy as np

ROUTE_COLUMNS = ("route", "arrival_stamp", "truck_id", "location", "type")
_DTYPES = (np.int64, np.float64, np.int64, np.int64, object)


class RouteTable:
    """The route rows as numpy columns, by name: `table["location"]` is a
    column, and `table[mask]` (a boolean or index array) the table of
    those rows."""

    def __init__(self, rows=()):
        cols = list(zip(*rows)) if len(rows) else [()] * len(ROUTE_COLUMNS)
        self._cols = {
            name: np.asarray(col, dtype=dt)
            for name, col, dt in zip(ROUTE_COLUMNS, cols, _DTYPES)}

    @property
    def columns(self):
        return list(ROUTE_COLUMNS)

    def __len__(self):
        return len(self._cols["route"])

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        out = RouteTable()
        out._cols = {k: v[key] for k, v in self._cols.items()}
        return out

    def rows(self):
        """The rows as tuples in column order."""
        return list(zip(*(self._cols[c].tolist() for c in ROUTE_COLUMNS)))


class SolutionStatus(Enum):
    SUCCESS = 0
    FAIL = 1
    TIMEOUT = 2
    EMPTY = 3


class Objective(IntEnum):
    COST = 0
    TRAVEL_TIME = 1
    VARIANCE_ROUTE_SIZE = 2
    VARIANCE_ROUTE_SERVICE_TIME = 3
    PRIZE = 4
    VEHICLE_FIXED_COST = 5


class Assignment:
    def __init__(
        self,
        vehicle_count,
        total_objective_value,
        objective_values,
        route_df,
        accepted=None,
        status=SolutionStatus.SUCCESS.value,
        message="",
        error_status=0,
        error_message="",
        undeliverable_orders=None,
    ):
        self.vehicle_count = vehicle_count
        self.total_objective_value = total_objective_value
        self.objective_values = objective_values
        self.route = route_df
        self.accepted = accepted if accepted is not None else []
        self.status = status
        self.message = message
        self.error_status = error_status
        self.error_message = error_message
        self.undeliverable_orders = (
            undeliverable_orders if undeliverable_orders is not None else []
        )

    def get_vehicle_count(self):
        return self.vehicle_count

    def get_total_objective(self):
        return self.total_objective_value

    def get_objective_values(self):
        return self.objective_values

    def get_route(self):
        return self.route

    def get_status(self):
        return self.status

    def get_message(self):
        return self.message

    def get_error_status(self):
        return self.error_status

    def get_error_message(self):
        return self.error_message

    def get_infeasible_orders(self):
        return self.undeliverable_orders

    def get_accepted_solutions(self):
        return self.accepted

    def display_routes(self):
        t = self.route
        for truck in sorted(set(t["truck_id"].tolist())):
            sub = t[t["truck_id"] == truck]
            path = "->".join(str(int(r)) for r in sub["route"])
            print(f"Vehicle-{truck} starts at: {sub['arrival_stamp'][0]}"
                  f", route: {path}")
