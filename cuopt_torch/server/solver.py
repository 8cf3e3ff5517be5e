"""In-process solve functions used by the solver workers.

Counterpart of cuopt_torch/server/solver.py, which mirrors reference
python/cuopt_server/cuopt_server/utils/solver.py (solve_LP_sync :75,
solve_optimized_routes_sync :266): translate the validated JSON payloads
into DataModels, solve on `device`, translate results back into the
reference response shapes. The routes come from the port's numpy
RouteTable, not a pandas DataFrame.
"""

from __future__ import annotations

import math

import numpy as np

from cuopt_torch.server.data_definition import (
    LPData,
    OptimizedRoutingData,
    parse_bound_list,
)


def solve_lp_payload(payload: dict, incumbent_cb=None,
                     device="cuda") -> dict:
    data = LPData(**payload)
    from cuopt_torch.lp.settings import SolverSettings
    from cuopt_torch.linear_programming import Solve
    from cuopt_torch.problem.data_model import DataModel

    dm = DataModel()
    m = data.csr_constraint_matrix
    dm.set_csr_constraint_matrix(m.values, m.indices, m.offsets)
    if data.objective_data:
        dm.set_objective_coefficients(data.objective_data.coefficients)
        if data.objective_data.offset is not None:
            dm.set_objective_offset(data.objective_data.offset)
        if data.objective_data.scalability_factor is not None:
            dm.set_objective_scaling_factor(
                data.objective_data.scalability_factor
            )
    cb = data.constraint_bounds
    if cb and cb.types:
        dm.set_row_types(cb.types)
        dm.set_constraint_bounds(cb.bounds or [])
    elif cb and (cb.upper_bounds is not None or cb.lower_bounds is not None):
        n_rows = max(len(m.offsets) - 1, 0)
        ub = parse_bound_list(cb.upper_bounds)
        lb = parse_bound_list(cb.lower_bounds)
        dm.set_constraint_upper_bounds(
            ub if ub is not None else [math.inf] * n_rows
        )
        dm.set_constraint_lower_bounds(
            lb if lb is not None else [-math.inf] * n_rows
        )
    vb = data.variable_bounds
    if vb:
        if vb.lower_bounds is not None:
            dm.set_variable_lower_bounds(parse_bound_list(vb.lower_bounds))
        if vb.upper_bounds is not None:
            dm.set_variable_upper_bounds(parse_bound_list(vb.upper_bounds))
    if data.maximize:
        dm.set_maximize(True)
    if data.variable_types:
        dm.set_variable_types(data.variable_types)
    if data.variable_names:
        dm.set_variable_names(data.variable_names)

    settings = SolverSettings()
    sc = data.solver_config
    if sc:
        if sc.tolerances:
            t = sc.tolerances
            if t.optimality is not None:
                settings.set_optimality_tolerance(t.optimality)
            pt = settings.pdlp.tolerances
            for src, dst in (
                ("absolute_primal", "absolute_primal_tolerance"),
                ("absolute_dual", "absolute_dual_tolerance"),
                ("absolute_gap", "absolute_gap_tolerance"),
                ("relative_primal", "relative_primal_tolerance"),
                ("relative_dual", "relative_dual_tolerance"),
                ("relative_gap", "relative_gap_tolerance"),
                ("primal_infeasible", "primal_infeasible_tolerance"),
                ("dual_infeasible", "dual_infeasible_tolerance"),
            ):
                v = getattr(t, src)
                if v is not None:
                    setattr(pt, dst, v)
            mt = settings.mip.tolerances
            if t.mip_integrality_tolerance is not None:
                mt.integrality_tolerance = t.mip_integrality_tolerance
            if t.mip_absolute_gap is not None:
                mt.absolute_mip_gap = t.mip_absolute_gap
            if t.mip_relative_gap is not None:
                mt.relative_mip_gap = t.mip_relative_gap
        for name, attr in (
            ("infeasibility_detection", "detect_infeasibility"),
            ("time_limit", "time_limit"),
            ("iteration_limit", "iteration_limit"),
            ("pdlp_solver_mode", "pdlp_solver_mode"),
            ("method", "method"),
            ("crossover", "crossover"),
            ("log_to_console", "log_to_console"),
            ("solution_file", "solution_file"),
        ):
            v = getattr(sc, name)
            if v is not None:
                setattr(settings.pdlp, attr, v)
        if sc.time_limit is not None:
            settings.mip.time_limit = sc.time_limit
        if sc.mip_heuristics_only is not None:
            settings.mip.heuristics_only = sc.mip_heuristics_only
        if sc.num_cpu_threads is not None:
            settings.mip.num_cpu_threads = sc.num_cpu_threads
    if data.initial_solution:
        if data.initial_solution.primal:
            settings.pdlp.initial_primal_solution = np.asarray(
                data.initial_solution.primal
            )
        if data.initial_solution.dual:
            settings.pdlp.initial_dual_solution = np.asarray(
                data.initial_solution.dual
            )
    if data.warm_start_data:
        from cuopt_torch.lp.warm_start import PdlpWarmStartData

        settings.pdlp.set_pdlp_warm_start_data(
            PdlpWarmStartData.from_dict(data.warm_start_data)
        )
    if incumbent_cb is not None:
        from cuopt_torch.lp.internals import GetSolutionCallback

        class _Stream(GetSolutionCallback):
            def get_solution(self, solution, solution_cost):
                incumbent_cb(
                    np.asarray(solution, float).tolist(),
                    float(solution_cost[0]),
                )

        settings.set_mip_callback(_Stream())

    sol = Solve(dm, settings, device)
    info = sol.get_additional_termination_information()
    result = {
        "status": sol.get_termination_status(),
        "solution": {
            "primal_solution": _tolist(sol.get_primal_solution()),
            "dual_solution": _tolist(sol.get_dual_solution()),
            "reduced_cost": _tolist(sol.get_reduced_costs()),
            "primal_objective": info.get("primal_objective"),
            "dual_objective": info.get("dual_objective"),
            "solver_time": info.get("solve_time"),
            "nb_iterations": info.get("iterations"),
            "vars": sol.get_vars(),
            "lp_statistics": {
                "primal_residual": info.get("l2_primal_residual"),
                "dual_residual": info.get("l2_dual_residual"),
                "gap": info.get("gap"),
            },
            "termination_reason": sol.get_termination_reason(),
        },
    }
    if "mip_gap" in sol._raw:
        result["solution"]["milp_statistics"] = {
            "mip_gap": sol.get_mip_gap(),
            "solution_bound": sol.get_solution_bound(),
            "num_nodes": sol._raw.get("nodes", 0),
        }
    ws = sol.get_pdlp_warm_start_data()
    if ws is not None:
        # split off by the collector into its own store; served via
        # GET /cuopt/solution/{id}/warmstart (reference webserver.py:835)
        result["warmstart"] = ws.to_dict()
    return result


def _tolist(a):
    if a is None:
        return None
    return np.asarray(a, float).tolist()


def solve_routing_payload(payload: dict, device="cuda") -> dict:
    data = OptimizedRoutingData(**payload)
    from cuopt_torch.routing import DataModel, SolverSettings, Solve

    if not data.cost_matrix_data or not data.cost_matrix_data.data:
        raise ValueError(
            "cost_matrix_data is required (waypoint graphs route through "
            "the distance engine first)"
        )
    mats = {
        int(k): np.asarray(v, float)
        for k, v in data.cost_matrix_data.data.items()
    }
    n_loc = len(next(iter(mats.values())))
    fleet = data.fleet_data
    tasks = data.task_data
    n_fleet = len(fleet.vehicle_locations)
    n_orders = len(tasks.task_locations)
    dm = DataModel(n_loc, n_fleet, n_orders)
    for vt, mat in mats.items():
        dm.add_cost_matrix(mat, vt)
    if data.travel_time_matrix_data and data.travel_time_matrix_data.data:
        for vt, mat in data.travel_time_matrix_data.data.items():
            dm.add_transit_time_matrix(np.asarray(mat, float), int(vt))
    dm.set_order_locations(tasks.task_locations)
    starts = [v[0] for v in fleet.vehicle_locations]
    ends = [v[1] for v in fleet.vehicle_locations]
    dm.set_vehicle_locations(starts, ends)
    if fleet.vehicle_types is not None:
        dm.set_vehicle_types(fleet.vehicle_types)
    if fleet.vehicle_time_windows is not None:
        dm.set_vehicle_time_windows(
            [w[0] for w in fleet.vehicle_time_windows],
            [w[1] for w in fleet.vehicle_time_windows],
        )
    if fleet.capacities is not None and tasks.demand is not None:
        for k, (cap, dem) in enumerate(
            zip(fleet.capacities, tasks.demand)
        ):
            dm.add_capacity_dimension(f"dim{k}", dem, cap)
    if fleet.vehicle_max_costs is not None:
        dm.set_vehicle_max_costs(fleet.vehicle_max_costs)
    if fleet.vehicle_max_times is not None:
        dm.set_vehicle_max_times(fleet.vehicle_max_times)
    if fleet.vehicle_fixed_costs is not None:
        dm.set_vehicle_fixed_costs(fleet.vehicle_fixed_costs)
    if fleet.skip_first_trips is not None:
        dm.set_skip_first_trips(fleet.skip_first_trips)
    if fleet.drop_return_trips is not None:
        dm.set_drop_return_trips(fleet.drop_return_trips)
    if fleet.min_vehicles is not None:
        dm.set_min_vehicles(fleet.min_vehicles)
    if tasks.task_time_windows is not None:
        dm.set_order_time_windows(
            [w[0] for w in tasks.task_time_windows],
            [w[1] for w in tasks.task_time_windows],
        )
    if tasks.service_times is not None:
        dm.set_order_service_times(tasks.service_times)
    if tasks.prizes is not None:
        dm.set_order_prizes(tasks.prizes)
    if tasks.pickup_and_delivery_pairs is not None:
        dm.set_pickup_delivery_pairs(
            [p[0] for p in tasks.pickup_and_delivery_pairs],
            [p[1] for p in tasks.pickup_and_delivery_pairs],
        )

    settings = SolverSettings()
    if data.solver_config and data.solver_config.time_limit is not None:
        settings.set_time_limit(data.solver_config.time_limit)
    sol = Solve(dm, settings, device)

    table = sol.get_route()
    vehicle_data = {}
    task_ids = tasks.task_ids
    for v in sorted(set(table["truck_id"].tolist())):
        sub = table[table["truck_id"] == v]
        last = len(sub) - 1
        route_orders = []
        types = []
        for k, o in enumerate(sub["route"].tolist()):
            # a depot row is a 0 in the truck's first or last row
            if o == 0 and k in (0, last):
                types.append("Depot")
                route_orders.append("Depot")
            else:
                types.append("Delivery")
                route_orders.append(
                    task_ids[o] if task_ids and o < len(task_ids)
                    else str(o)
                )
        vid = fleet.vehicle_ids[v] if fleet.vehicle_ids else str(v)
        vehicle_data[vid] = {
            "task_id": route_orders,
            "arrival_stamp": sub["arrival_stamp"].tolist(),
            "route": sub["location"].tolist(),
            "type": types,
        }
    return {
        "status": 0 if sol.get_status() == 0 else 1,
        "num_vehicles": sol.get_vehicle_count(),
        "solution_cost": sol.get_total_objective(),
        "objective_values": {
            str(k): v for k, v in sol.get_objective_values().items()
        },
        "vehicle_data": vehicle_data,
        "dropped_tasks": {
            "task_id": [str(t) for t in sol.get_infeasible_orders()],
            "task_index": list(sol.get_infeasible_orders()),
        },
        "msg": sol.get_message(),
    }
