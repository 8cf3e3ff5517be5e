"""Request/response schemas for the solver service, validated without
pydantic.

Counterpart of cuopt_tpu/server/data_definition.py, which mirrors the
reference pydantic StrictModels:
  LP:      python/cuopt_server/cuopt_server/utils/linear_programming/
           data_definition.py:106-680 (CSRConstraintMatrix, ObjectiveData,
           Constraint/VariableBounds, Tolerances, SolverConfig, LPData)
  routing: python/cuopt_server/cuopt_server/utils/routing/
           data_definition.py:38-943 (CostMatrices, FleetData, TaskData,
           SolverSettingsConfig, OptimizedRoutingData)

The machine with the card has no pydantic, so each model here is a plain
class: its fields are declared with a type and a default, unknown keys
are rejected (pydantic's extra="forbid"), each value is converted by the
rules of pydantic v2's lax mode for the field's type (an int field takes
2.0 and "3" but not 2.5; a bool field takes 1 and "yes"), and `_check`
holds the same cross-field checks as cuopt_tpu's model validators. A
rejected payload raises PayloadError. 'inf'/'ninf' string sentinels in
bounds arrays are accepted like the reference.
"""

from __future__ import annotations

import copy
import math
import re


class PayloadError(ValueError):
    """A payload its schema rejects (pydantic's ValidationError in
    cuopt_tpu)."""


def parse_bound_list(vals):
    if vals is None:
        return None
    out = []
    for v in vals:
        if isinstance(v, str):
            s = v.lower()
            if s in ("inf", "+inf", "infinity"):
                out.append(math.inf)
            elif s in ("ninf", "-inf", "-infinity"):
                out.append(-math.inf)
            else:
                out.append(float(v))
        else:
            out.append(float(v))
    return out


# ------------------------------------------------------------ field types
# Each type is a function (value, path) -> converted value that raises
# PayloadError; the rules are pydantic v2's in lax mode.
_INT_TEXT = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?", re.ASCII)
_BOOL_TEXT = {"0": False, "off": False, "f": False, "false": False,
              "n": False, "no": False, "1": True, "on": True, "t": True,
              "true": True, "y": True, "yes": True}
_SEQUENCES = (list, tuple, set, frozenset)


def _fail(path, what, v):
    raise PayloadError(f"{path}: {what}, got {type(v).__name__} {v!r:.60}")


def _text(v, path):
    if isinstance(v, (bytes, bytearray)):
        try:
            return bytes(v).decode("utf-8")
        except UnicodeDecodeError:
            _fail(path, "invalid UTF-8", v)
    return v


def INT(v, path):
    v = _text(v, path)
    if isinstance(v, int):  # bool included: True is 1
        return int(v)
    if isinstance(v, float):
        if math.isfinite(v) and v.is_integer() and abs(v) < 2.0 ** 63:
            return int(v)
        _fail(path, "expected an integer", v)
    if isinstance(v, str) and _INT_TEXT.fullmatch(v.strip()):
        return int(v.strip().split(".")[0])
    _fail(path, "expected an integer", v)


def FLOAT(v, path):
    v = _text(v, path)
    if isinstance(v, (int, float)):
        try:
            return float(v)
        except OverflowError:
            _fail(path, "number out of range", v)
    if isinstance(v, str) and v.isascii():
        try:
            return float(v)
        except ValueError:
            pass
    _fail(path, "expected a number", v)


def STR(v, path):
    v = _text(v, path)
    if isinstance(v, str):
        return v
    _fail(path, "expected a string", v)


def BYTES(v, path):
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return v.encode("utf-8")
    _fail(path, "expected bytes", v)


def BOOL(v, path):
    v = _text(v, path)
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _BOOL_TEXT:
        return _BOOL_TEXT[v.lower()]
    _fail(path, "expected a boolean", v)


def ANY_LIST(v, path):
    if isinstance(v, _SEQUENCES):
        return list(v)
    _fail(path, "expected a list", v)


def ANY_DICT(v, path):
    if isinstance(v, dict):
        return dict(v)
    _fail(path, "expected an object", v)


def _ints(v):
    return list(v) if all(type(x) is int for x in v) else None


def _floats(v):
    if all(type(x) is float or type(x) is int for x in v):
        try:
            return [float(x) for x in v]
        except OverflowError:
            return None
    return None


def ListOf(item):
    # large arrays of plain numbers skip the per-item conversion
    fast = {INT: _ints, FLOAT: _floats}.get(item)

    def convert(v, path):
        if not isinstance(v, _SEQUENCES):
            _fail(path, "expected a list", v)
        out = fast(v) if fast is not None else None
        if out is None:
            out = [item(x, f"{path}[{k}]") for k, x in enumerate(v)]
        return out
    return convert


def DictOf(key, value):
    def convert(v, path):
        if not isinstance(v, dict):
            _fail(path, "expected an object", v)
        return {key(k, f"{path} key"): value(x, f"{path}[{k!r}]")
                for k, x in v.items()}
    return convert


def PairOf(first, second):
    def convert(v, path):
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            _fail(path, "expected a pair", v)
        return (first(v[0], f"{path}[0]"), second(v[1], f"{path}[1]"))
    return convert


def Opt(inner):
    """The field's type, or None."""
    def convert(v, path):
        return None if v is None else inner(v, path)
    return convert


def Model(cls):
    def convert(v, path):
        if isinstance(v, cls):
            return v
        if not isinstance(v, dict) or not all(isinstance(k, str) for k in v):
            _fail(path, f"expected a {cls.__name__} object", v)
        return cls(path, **v)
    return convert


REQUIRED = object()


class StrictModel:
    """A model: FIELDS maps each field to (type, default), REQUIRED for a
    field without one. Unknown keys are rejected; `_check` runs on the
    converted fields. Defaults are deep copies, never validated (as in
    pydantic)."""

    FIELDS: dict = {}

    def __init__(self, path: str | None = None, /, **values):
        path = path or type(self).__name__
        extra = sorted(set(values) - set(self.FIELDS))
        if extra:
            raise PayloadError(f"{path}: unknown fields {extra}")
        for name, (kind, default) in self.FIELDS.items():
            if name in values:
                value = kind(values[name], f"{path}.{name}")
            elif default is REQUIRED:
                raise PayloadError(f"{path}.{name}: field required")
            else:
                value = copy.deepcopy(default)
            setattr(self, name, value)
        try:
            self._check()
        except PayloadError:
            raise
        except ValueError as exc:
            raise PayloadError(f"{path}: {exc}") from None

    def _check(self):
        pass


# ----------------------------------------------------------------- LP
class CSRConstraintMatrix(StrictModel):
    FIELDS = dict(
        offsets=(ListOf(INT), [0]),
        indices=(ListOf(INT), []),
        values=(ListOf(FLOAT), []),
    )

    def _check(self):
        o = self.offsets
        if not o or o[0] != 0:
            raise ValueError("offsets must start at 0")
        if any(b < a for a, b in zip(o, o[1:])):
            raise ValueError("offsets must be non-decreasing")
        if len(self.indices) != len(self.values):
            raise ValueError("indices/values length mismatch")
        if o[-1] != len(self.values):
            raise ValueError(
                "offsets[-1] must equal the number of nonzeros"
            )
        if any(i < 0 for i in self.indices):
            raise ValueError("negative column index")


class ObjectiveData(StrictModel):
    FIELDS = dict(
        coefficients=(ListOf(FLOAT), []),
        scalability_factor=(Opt(FLOAT), None),
        offset=(Opt(FLOAT), 0.0),
    )


class ConstraintBounds(StrictModel):
    FIELDS = dict(
        upper_bounds=(Opt(ANY_LIST), None),
        lower_bounds=(Opt(ANY_LIST), None),
        bounds=(Opt(ListOf(FLOAT)), None),
        types=(Opt(ListOf(STR)), None),
    )


class VariableBounds(StrictModel):
    FIELDS = dict(
        upper_bounds=(Opt(ANY_LIST), None),
        lower_bounds=(Opt(ANY_LIST), None),
    )


class InitialSolution(StrictModel):
    FIELDS = dict(
        primal=(Opt(ListOf(FLOAT)), None),
        dual=(Opt(ListOf(FLOAT)), None),
    )


class Tolerances(StrictModel):
    FIELDS = dict(**{name: (Opt(FLOAT), None) for name in (
        "optimality", "absolute_primal", "absolute_dual", "absolute_gap",
        "relative_primal", "relative_dual", "relative_gap",
        "primal_infeasible", "dual_infeasible",
        "mip_integrality_tolerance", "mip_absolute_gap",
        "mip_relative_gap")})


class SolverConfig(StrictModel):
    FIELDS = dict(
        tolerances=(Opt(Model(Tolerances)), None),
        infeasibility_detection=(Opt(BOOL), None),
        time_limit=(Opt(FLOAT), None),
        iteration_limit=(Opt(INT), None),
        pdlp_solver_mode=(Opt(INT), None),
        method=(Opt(INT), None),
        mip_scaling=(Opt(BOOL), None),
        mip_heuristics_only=(Opt(BOOL), None),
        num_cpu_threads=(Opt(INT), None),
        crossover=(Opt(BOOL), None),
        log_to_console=(Opt(BOOL), None),
        solution_file=(Opt(STR), None),
        user_problem_file=(Opt(STR), None),
    )


class LPData(StrictModel):
    """Validated LP payload; cross-field shape checks mirror the
    reference's strict models (utils/linear_programming/
    data_definition.py:106-680)."""

    FIELDS = dict(
        csr_constraint_matrix=(Model(CSRConstraintMatrix),
                               CSRConstraintMatrix()),
        objective_data=(Opt(Model(ObjectiveData)), ObjectiveData()),
        constraint_bounds=(Opt(Model(ConstraintBounds)),
                           ConstraintBounds()),
        variable_bounds=(Opt(Model(VariableBounds)), VariableBounds()),
        initial_solution=(Opt(Model(InitialSolution)), None),
        maximize=(Opt(BOOL), False),
        variable_types=(Opt(ListOf(STR)), None),
        variable_names=(Opt(ListOf(STR)), None),
        solver_config=(Opt(Model(SolverConfig)), SolverConfig()),
        # full PDLP internal state from a prior solve (reference
        # data_definition.py WarmStartData; GET
        # /cuopt/solution/{id}/warmstart)
        warm_start_data=(Opt(ANY_DICT), None),
    )

    def _check(self):
        n_rows = len(self.csr_constraint_matrix.offsets) - 1
        n_vars = None
        if self.objective_data and self.objective_data.coefficients:
            n_vars = len(self.objective_data.coefficients)
        if self.csr_constraint_matrix.indices and n_vars is not None:
            if max(self.csr_constraint_matrix.indices) >= n_vars:
                raise ValueError("column index out of range")
        vb = self.variable_bounds
        if vb is not None and n_vars is not None:
            for name, b in (("variable lower", vb.lower_bounds),
                            ("variable upper", vb.upper_bounds)):
                if b is not None and len(b) != n_vars:
                    raise ValueError(
                        f"{name} bounds length {len(b)} != num "
                        f"variables {n_vars}"
                    )
        cb = self.constraint_bounds
        if cb is not None:
            for name, b in (("constraint lower", cb.lower_bounds),
                            ("constraint upper", cb.upper_bounds),
                            ("constraint rhs", cb.bounds)):
                if b is not None and len(b) != n_rows:
                    raise ValueError(
                        f"{name} bounds length {len(b)} != num "
                        f"constraints {n_rows}"
                    )
            if cb.types is not None:
                if len(cb.types) != n_rows:
                    raise ValueError("constraint types length mismatch")
                bad = set(cb.types) - {"L", "G", "E"}
                if bad:
                    raise ValueError(f"invalid constraint sense {bad}")
        if self.variable_types is not None:
            if n_vars is not None and len(self.variable_types) != n_vars:
                raise ValueError("variable_types length mismatch")
            bad = set(self.variable_types) - {"C", "I"}
            if bad:
                raise ValueError(f"invalid variable type {bad}")


class LPTupleData(StrictModel):
    FIELDS = dict(data_list=(ListOf(PairOf(STR, BYTES)), []))


# ------------------------------------------------------------- routing
class RoutingObjective(StrictModel):
    FIELDS = dict(
        cost=(Opt(FLOAT), 1.0),
        travel_time=(Opt(FLOAT), 0.0),
        variance_route_size=(Opt(FLOAT), 0.0),
        variance_route_service_time=(Opt(FLOAT), 0.0),
        prize=(Opt(FLOAT), 0.0),
        vehicle_fixed_cost=(Opt(FLOAT), 0.0),
    )


class CostMatrices(StrictModel):
    FIELDS = dict(
        data=(Opt(DictOf(INT, ListOf(ListOf(FLOAT)))), None),
    )


class VehicleBreak(StrictModel):
    FIELDS = dict(
        vehicle_id=(INT, REQUIRED),
        earliest=(FLOAT, REQUIRED),
        latest=(FLOAT, REQUIRED),
        duration=(FLOAT, REQUIRED),
        locations=(Opt(ListOf(INT)), None),
    )

    def _check(self):
        if self.vehicle_id < 0:
            raise ValueError("vehicle_id must be non-negative")
        if self.latest < self.earliest:
            raise ValueError("break latest < earliest")
        if self.duration < 0:
            raise ValueError("negative break duration")


class FleetData(StrictModel):
    FIELDS = dict(
        vehicle_locations=(ListOf(ListOf(INT)), REQUIRED),
        vehicle_ids=(Opt(ListOf(STR)), None),
        capacities=(Opt(ListOf(ListOf(INT))), None),
        vehicle_time_windows=(Opt(ListOf(ListOf(FLOAT))), None),
        vehicle_break_time_windows=(
            Opt(ListOf(ListOf(ListOf(FLOAT)))), None),
        vehicle_break_durations=(Opt(ListOf(ListOf(FLOAT))), None),
        vehicle_break_locations=(Opt(ListOf(INT)), None),
        vehicle_breaks=(Opt(ListOf(Model(VehicleBreak))), None),
        vehicle_types=(Opt(ListOf(INT)), None),
        vehicle_order_match=(Opt(ListOf(ANY_DICT)), None),
        skip_first_trips=(Opt(ListOf(BOOL)), None),
        drop_return_trips=(Opt(ListOf(BOOL)), None),
        min_vehicles=(Opt(INT), None),
        vehicle_max_costs=(Opt(ListOf(FLOAT)), None),
        vehicle_max_times=(Opt(ListOf(FLOAT)), None),
        vehicle_fixed_costs=(Opt(ListOf(FLOAT)), None),
    )

    def _check(self):
        nf = len(self.vehicle_locations)
        if nf == 0:
            raise ValueError("fleet must have at least one vehicle")
        for vl in self.vehicle_locations:
            if len(vl) != 2:
                raise ValueError(
                    "vehicle_locations entries must be [start, return]"
                )
            if any(x < 0 for x in vl):
                raise ValueError("negative vehicle location")
        for name, per_vehicle in (
            ("vehicle_time_windows", self.vehicle_time_windows),
            ("skip_first_trips", self.skip_first_trips),
            ("drop_return_trips", self.drop_return_trips),
            ("vehicle_max_costs", self.vehicle_max_costs),
            ("vehicle_max_times", self.vehicle_max_times),
            ("vehicle_fixed_costs", self.vehicle_fixed_costs),
            ("vehicle_types", self.vehicle_types),
        ):
            if per_vehicle is not None and len(per_vehicle) != nf:
                raise ValueError(f"{name} length != fleet size")
        if self.vehicle_time_windows is not None:
            for tw in self.vehicle_time_windows:
                if len(tw) != 2 or tw[1] < tw[0]:
                    raise ValueError("invalid vehicle time window")
        if self.capacities is not None:
            for dim in self.capacities:
                if len(dim) != nf:
                    raise ValueError("capacity row length != fleet size")


class TaskData(StrictModel):
    FIELDS = dict(
        task_locations=(ListOf(INT), REQUIRED),
        task_ids=(Opt(ListOf(STR)), None),
        demand=(Opt(ListOf(ListOf(INT))), None),
        pickup_and_delivery_pairs=(Opt(ListOf(ListOf(INT))), None),
        task_time_windows=(Opt(ListOf(ListOf(INT))), None),
        service_times=(Opt(ListOf(INT)), None),
        prizes=(Opt(ListOf(FLOAT)), None),
        order_vehicle_match=(Opt(ListOf(ANY_DICT)), None),
    )

    def _check(self):
        nt = len(self.task_locations)
        if nt == 0:
            raise ValueError("task_locations must be non-empty")
        if any(t < 0 for t in self.task_locations):
            raise ValueError("negative task location")
        for name, per_task in (
            ("task_time_windows", self.task_time_windows),
            ("service_times", self.service_times),
            ("prizes", self.prizes),
        ):
            if per_task is not None and len(per_task) != nt:
                raise ValueError(f"{name} length != number of tasks")
        if self.task_time_windows is not None:
            for tw in self.task_time_windows:
                if len(tw) != 2 or tw[1] < tw[0]:
                    raise ValueError("invalid task time window")
        if self.demand is not None:
            for dim in self.demand:
                if len(dim) != nt:
                    raise ValueError("demand row length != tasks")
        if self.pickup_and_delivery_pairs is not None:
            for pr in self.pickup_and_delivery_pairs:
                if len(pr) != 2 or pr[0] == pr[1] or \
                        any(x < 0 or x >= nt for x in pr):
                    raise ValueError("invalid pickup/delivery pair")


class SolverSettingsConfig(StrictModel):
    FIELDS = dict(
        time_limit=(Opt(FLOAT), None),
        objectives=(Opt(Model(RoutingObjective)), None),
        config_file=(Opt(STR), None),
        verbose_mode=(Opt(BOOL), None),
        error_logging=(Opt(BOOL), None),
    )


class OptimizedRoutingData(StrictModel):
    FIELDS = dict(
        cost_waypoint_graph_data=(Opt(ANY_DICT), None),
        travel_time_waypoint_graph_data=(Opt(ANY_DICT), None),
        cost_matrix_data=(Opt(Model(CostMatrices)), None),
        travel_time_matrix_data=(Opt(Model(CostMatrices)), None),
        fleet_data=(Model(FleetData), REQUIRED),
        task_data=(Model(TaskData), REQUIRED),
        solver_config=(Opt(Model(SolverSettingsConfig)), None),
        initial_solution=(Opt(ANY_LIST), None),
    )
