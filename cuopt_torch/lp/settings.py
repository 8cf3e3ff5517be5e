"""LP solver settings.

Mirrors the reference `pdlp_solver_settings_t`
(cpp/include/cuopt/linear_programming/pdlp/solver_settings.hpp:70, tolerance
defaults :179-188), the MIP settings (mip/solver_settings.hpp) and the
unified string-keyed registry `solver_settings_t`
(cpp/include/cuopt/linear_programming/solver_settings.hpp:38) behind
cuOptSetParameter and the CLI's autogenerated flags.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from cuopt_torch import constants as C
from cuopt_torch.utils.errors import ValidationError


@dataclass
class PdlpTolerances:
    # reference solver_settings.hpp:179-188
    absolute_dual_tolerance: float = 1e-4
    relative_dual_tolerance: float = 1e-4
    absolute_primal_tolerance: float = 1e-4
    relative_primal_tolerance: float = 1e-4
    absolute_gap_tolerance: float = 1e-4
    relative_gap_tolerance: float = 1e-4
    primal_infeasible_tolerance: float = 1e-8
    dual_infeasible_tolerance: float = 1e-8


@dataclass
class MipTolerances:
    # reference mip/solver_settings.hpp:75-80
    absolute_tolerance: float = 1e-4
    relative_tolerance: float = 1e-6
    integrality_tolerance: float = 1e-5
    absolute_mip_gap: float = 1e-10
    relative_mip_gap: float = 1e-4
    presolve_absolute_tolerance: float = 1e-6


@dataclass
class PDLPSolverSettings:
    tolerances: PdlpTolerances = field(default_factory=PdlpTolerances)
    detect_infeasibility: bool = False
    strict_infeasibility: bool = False
    iteration_limit: int = (1 << 31) - 1
    time_limit: float = math.inf
    pdlp_solver_mode: int = C.CUOPT_PDLP_SOLVER_MODE_STABLE2
    method: int = C.CUOPT_METHOD_CONCURRENT
    per_constraint_residual: bool = False
    save_best_primal_so_far: bool = False
    first_primal_feasible: bool = False
    log_file: str = ""
    log_to_console: bool = True
    crossover: bool = False
    solution_file: str = ""
    user_problem_file: str = ""  # stored only, as in cuopt_tpu
    # port-specific knobs (no reference equivalent)
    dtype: str = "float64"  # compute dtype: float64 | float32
    operator_kind: str = "auto"  # auto | dense | ell | csr | blockband | bandperm
    # warm start (reference solver_settings.hpp:138-163): a prior solve's
    # PdlpWarmStartData, or user-space starting points
    warm_start_data: object = None
    initial_primal_solution: object = None
    initial_dual_solution: object = None

    def set_pdlp_warm_start_data(self, data) -> None:
        """Feed a prior solve's full internal state back in (reference
        solver_settings.hpp:138-163)."""
        self.warm_start_data = data

    def set_initial_primal_solution(self, x) -> None:
        self.initial_primal_solution = x

    def set_initial_dual_solution(self, y) -> None:
        self.initial_dual_solution = y

    def set_optimality_tolerance(self, eps: float):
        """Set all absolute+relative optimality tolerances at once
        (reference solver_settings.hpp behavior)."""
        t = self.tolerances
        t.absolute_dual_tolerance = eps
        t.relative_dual_tolerance = eps
        t.absolute_primal_tolerance = eps
        t.relative_primal_tolerance = eps
        t.absolute_gap_tolerance = eps
        t.relative_gap_tolerance = eps


@dataclass
class MIPSolverSettings:
    tolerances: MipTolerances = field(default_factory=MipTolerances)
    time_limit: float = math.inf
    heuristics_only: bool = False
    num_cpu_threads: int = -1
    log_file: str = ""
    log_to_console: bool = True
    mip_scaling: bool = True
    solution_file: str = ""
    user_problem_file: str = ""
    dtype: str = "float64"
    # user initial solutions (reference mip solver_settings.hpp:55)
    initial_solutions: list = field(default_factory=list)
    # incumbent callbacks (reference internals.hpp:28-79; Python
    # solver_settings.py set_mip_callback :241)
    mip_callbacks: list = field(default_factory=list)

    def set_initial_solution(self, x) -> None:
        import numpy as np

        self.initial_solutions.append(np.asarray(x, float))

    def set_mip_callback(self, callback) -> None:
        self.mip_callbacks.append(callback)


# --------------------------------------------------------------------------
# Unified string-keyed registry (reference solver_settings_t :38-113)
# --------------------------------------------------------------------------
class SolverSettings:
    """String-keyed parameter facade over PDLP + MIP settings.

    set_parameter/get_parameter accept the CUOPT_* names in
    cuopt_torch.constants (parity with cuOptSetParameter / Python
    set_parameter / CLI autogen flags)."""

    def __init__(self):
        self.pdlp = PDLPSolverSettings()
        self.mip = MIPSolverSettings()
        self._float_params = {
            C.CUOPT_ABSOLUTE_DUAL_TOLERANCE:
                (self.pdlp.tolerances, "absolute_dual_tolerance"),
            C.CUOPT_RELATIVE_DUAL_TOLERANCE:
                (self.pdlp.tolerances, "relative_dual_tolerance"),
            C.CUOPT_ABSOLUTE_PRIMAL_TOLERANCE:
                (self.pdlp.tolerances, "absolute_primal_tolerance"),
            C.CUOPT_RELATIVE_PRIMAL_TOLERANCE:
                (self.pdlp.tolerances, "relative_primal_tolerance"),
            C.CUOPT_ABSOLUTE_GAP_TOLERANCE:
                (self.pdlp.tolerances, "absolute_gap_tolerance"),
            C.CUOPT_RELATIVE_GAP_TOLERANCE:
                (self.pdlp.tolerances, "relative_gap_tolerance"),
            C.CUOPT_PRIMAL_INFEASIBLE_TOLERANCE:
                (self.pdlp.tolerances, "primal_infeasible_tolerance"),
            C.CUOPT_DUAL_INFEASIBLE_TOLERANCE:
                (self.pdlp.tolerances, "dual_infeasible_tolerance"),
            C.CUOPT_TIME_LIMIT: (self.pdlp, "time_limit"),
            C.CUOPT_MIP_ABSOLUTE_TOLERANCE:
                (self.mip.tolerances, "absolute_tolerance"),
            C.CUOPT_MIP_RELATIVE_TOLERANCE:
                (self.mip.tolerances, "relative_tolerance"),
            C.CUOPT_MIP_INTEGRALITY_TOLERANCE:
                (self.mip.tolerances, "integrality_tolerance"),
            C.CUOPT_MIP_ABSOLUTE_GAP:
                (self.mip.tolerances, "absolute_mip_gap"),
            C.CUOPT_MIP_RELATIVE_GAP:
                (self.mip.tolerances, "relative_mip_gap"),
        }
        self._int_params = {
            C.CUOPT_ITERATION_LIMIT: (self.pdlp, "iteration_limit"),
            C.CUOPT_PDLP_SOLVER_MODE: (self.pdlp, "pdlp_solver_mode"),
            C.CUOPT_METHOD: (self.pdlp, "method"),
            C.CUOPT_NUM_CPU_THREADS: (self.mip, "num_cpu_threads"),
        }
        self._bool_params = {
            C.CUOPT_INFEASIBILITY_DETECTION:
                (self.pdlp, "detect_infeasibility"),
            C.CUOPT_STRICT_INFEASIBILITY: (self.pdlp, "strict_infeasibility"),
            C.CUOPT_PER_CONSTRAINT_RESIDUAL:
                (self.pdlp, "per_constraint_residual"),
            C.CUOPT_SAVE_BEST_PRIMAL_SO_FAR:
                (self.pdlp, "save_best_primal_so_far"),
            C.CUOPT_FIRST_PRIMAL_FEASIBLE:
                (self.pdlp, "first_primal_feasible"),
            C.CUOPT_CROSSOVER: (self.pdlp, "crossover"),
            C.CUOPT_LOG_TO_CONSOLE: (self.pdlp, "log_to_console"),
            C.CUOPT_MIP_HEURISTICS_ONLY: (self.mip, "heuristics_only"),
            C.CUOPT_MIP_SCALING: (self.mip, "mip_scaling"),
        }
        self._str_params = {
            C.CUOPT_LOG_FILE: (self.pdlp, "log_file"),
            C.CUOPT_SOLUTION_FILE: (self.pdlp, "solution_file"),
            C.CUOPT_USER_PROBLEM_FILE: (self.pdlp, "user_problem_file"),
        }

    # -- registry API --
    def parameter_names(self) -> list[str]:
        return sorted(
            list(self._float_params)
            + list(self._int_params)
            + list(self._bool_params)
            + list(self._str_params)
        )

    def parameter_type(self, name: str) -> type:
        if name in self._float_params:
            return float
        if name in self._int_params:
            return int
        if name in self._bool_params:
            return bool
        if name in self._str_params:
            return str
        raise ValidationError(f"Unknown parameter {name!r}")

    def set_parameter(self, name: str, value):
        for registry, cast in (
            (self._float_params, float),
            (self._int_params, int),
            (self._bool_params, self._to_bool),
            (self._str_params, str),
        ):
            if name in registry:
                obj, attr = registry[name]
                setattr(obj, attr, cast(value))
                # time_limit is shared LP/MIP
                if name == C.CUOPT_TIME_LIMIT:
                    self.mip.time_limit = float(value)
                if name == C.CUOPT_LOG_FILE:
                    self.mip.log_file = str(value)
                if name == C.CUOPT_LOG_TO_CONSOLE:
                    self.mip.log_to_console = self._to_bool(value)
                return
        raise ValidationError(f"Unknown parameter {name!r}")

    def get_parameter(self, name: str):
        for registry in (
            self._float_params, self._int_params,
            self._bool_params, self._str_params,
        ):
            if name in registry:
                obj, attr = registry[name]
                return getattr(obj, attr)
        raise ValidationError(f"Unknown parameter {name!r}")

    @staticmethod
    def _to_bool(v) -> bool:
        if isinstance(v, str):
            if v.lower() in ("1", "true", "yes", "on"):
                return True
            if v.lower() in ("0", "false", "no", "off"):
                return False
            raise ValidationError(f"Bad boolean value {v!r}")
        return bool(v)

    def set_optimality_tolerance(self, eps: float):
        self.pdlp.set_optimality_tolerance(eps)

    def set_mip_callback(self, callback) -> None:
        """Register a GetSolutionCallback / SetSolutionCallback (reference
        solver_settings.py:241)."""
        self.mip.set_mip_callback(callback)

    def set_initial_solution(self, x) -> None:
        self.mip.set_initial_solution(x)
