"""Inputs for the cuopt_torch surface tests (MPS parser, CLI, C API,
server), written in the tests from seeded generators: an MPS writer,
payload builders and a few fixed MPS texts. Nothing here reads a dataset
from outside the repository."""

import math

import numpy as np


def _num(v) -> str:
    return repr(float(v))


def write_mps(prob, name="TEST") -> str:
    """Free-format MPS text of an OptimizationProblem of either package:
    rows R<i> (E, G, L, or L with a RANGES entry when both bounds are
    finite and differ), columns C<j> with integer MARKERs, the objective
    offset as an RHS on the objective row, and BOUNDS. Numbers are written
    with repr, so they read back exactly."""
    n, m = prob.n_constraints, prob.n_variables
    lc = np.asarray(prob.constraint_lower_bounds, float)
    uc = np.asarray(prob.constraint_upper_bounds, float)
    lines = [f"NAME {name}"]
    if prob.maximize:
        lines += ["OBJSENSE", "    MAX"]
    lines += ["ROWS", " N  OBJ"]
    rhs, ranges = {}, {}
    for i in range(n):
        lo, hi = lc[i], uc[i]
        if math.isfinite(lo) and lo == hi:
            kind, rhs[i] = "E", lo
        elif math.isfinite(lo) and math.isfinite(hi):
            kind, rhs[i], ranges[i] = "L", hi, hi - lo
        elif math.isfinite(lo):
            kind, rhs[i] = "G", lo
        else:
            kind, rhs[i] = "L", hi
        lines.append(f" {kind}  R{i}")
    lines.append("COLUMNS")
    offsets = np.asarray(prob.offsets)
    rows = np.repeat(np.arange(n), np.diff(offsets))
    order = np.argsort(np.asarray(prob.indices), kind="stable")
    cols = np.asarray(prob.indices)[order]
    col_rows, col_vals = rows[order], np.asarray(prob.values, float)[order]
    starts = np.searchsorted(cols, np.arange(m + 1))
    c = np.asarray(prob.objective_coefficients, float)
    types = np.asarray(prob.variable_types)
    in_int = False
    for j in range(m):
        if (types[j] == "I") != in_int:
            in_int = not in_int
            lines.append(f"    M{j}  'MARKER'  "
                         f"'{'INTORG' if in_int else 'INTEND'}'")
        lines.append(f"    C{j}  OBJ  {_num(c[j])}")
        for k in range(starts[j], starts[j + 1]):
            lines.append(f"    C{j}  R{col_rows[k]}  {_num(col_vals[k])}")
    if in_int:
        lines.append(f"    M{m}  'MARKER'  'INTEND'")
    lines.append("RHS")
    if prob.objective_offset:
        lines.append(f"    RHS  OBJ  {_num(-prob.objective_offset)}")
    lines += [f"    RHS  R{i}  {_num(v)}" for i, v in rhs.items() if v != 0]
    if ranges:
        lines.append("RANGES")
        lines += [f"    RNG  R{i}  {_num(v)}" for i, v in ranges.items()]
    lines.append("BOUNDS")
    lb = np.asarray(prob.variable_lower_bounds, float)
    ub = np.asarray(prob.variable_upper_bounds, float)
    for j in range(m):
        lo, hi = lb[j], ub[j]
        if lo == -math.inf and hi == math.inf:
            lines.append(f" FR BND  C{j}")
            continue
        if math.isfinite(lo) and lo == hi:
            lines.append(f" FX BND  C{j}  {_num(lo)}")
            continue
        if lo == -math.inf:
            lines.append(f" MI BND  C{j}")
        elif lo != 0:
            lines.append(f" LO BND  C{j}  {_num(lo)}")
        if math.isfinite(hi):
            lines.append(f" UP BND  C{j}  {_num(hi)}")
    lines.append("ENDATA")
    return "\n".join(lines) + "\n"


def staircase(package_generate_lp, n=200, seed=123):
    return package_generate_lp(n, n, 6, seed=seed, band=48)


def lp_payload(prob, **solver_config) -> dict:
    """The server's LP JSON payload of an OptimizationProblem."""
    def bounds(a):
        return ["inf" if v == math.inf else "ninf" if v == -math.inf
                else float(v) for v in np.asarray(a, float)]

    payload = {
        "csr_constraint_matrix": {
            "offsets": np.asarray(prob.offsets).tolist(),
            "indices": np.asarray(prob.indices).tolist(),
            "values": np.asarray(prob.values, float).tolist(),
        },
        "objective_data": {
            "coefficients": np.asarray(prob.objective_coefficients,
                                       float).tolist(),
            "offset": float(prob.objective_offset),
        },
        "constraint_bounds": {
            "lower_bounds": bounds(prob.constraint_lower_bounds),
            "upper_bounds": bounds(prob.constraint_upper_bounds),
        },
        "variable_bounds": {
            "lower_bounds": bounds(prob.variable_lower_bounds),
            "upper_bounds": bounds(prob.variable_upper_bounds),
        },
        "maximize": bool(prob.maximize),
        "solver_config": dict(solver_config),
    }
    if (np.asarray(prob.variable_types) == "I").any():
        payload["variable_types"] = np.asarray(
            prob.variable_types).tolist()
    return payload


# test_server.py's payloads, by value, so that the port's tests do not
# import cuopt_tpu's test module
LP_PAYLOAD = {
    "csr_constraint_matrix": {
        "offsets": [0, 2, 4], "indices": [0, 1, 0, 1],
        "values": [3.0, 4.0, 2.7, 10.1],
    },
    "objective_data": {"coefficients": [-0.2, -0.1], "offset": 0.0},
    "constraint_bounds": {
        "upper_bounds": [5.4, 4.9], "lower_bounds": ["ninf", "ninf"],
    },
    "variable_bounds": {
        "lower_bounds": [0.0, 0.0], "upper_bounds": ["inf", "inf"],
    },
    "maximize": False,
    "solver_config": {"method": 1},
}

ROUTING_PAYLOAD = {
    "cost_matrix_data": {
        "data": {"0": [[0, 1, 5, 2], [2, 0, 7, 4],
                       [1, 5, 0, 9], [5, 6, 2, 0]]}
    },
    "fleet_data": {"vehicle_locations": [[0, 0], [0, 0]]},
    "task_data": {"task_locations": [1, 2, 3]},
    "solver_config": {"time_limit": 2},
}

MIP_PAYLOAD = {
    "csr_constraint_matrix": {
        "offsets": [0, 2], "indices": [0, 1], "values": [1.0, 1.0],
    },
    "objective_data": {"coefficients": [-1.0, -1.0], "offset": 0.0},
    "constraint_bounds": {
        "upper_bounds": [7.0], "lower_bounds": ["ninf"],
    },
    "variable_bounds": {
        "lower_bounds": [0.0, 0.0], "upper_bounds": [5.0, 5.0],
    },
    "variable_types": ["I", "I"],
    "solver_config": {"time_limit": 60},
}
