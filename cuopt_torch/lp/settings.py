"""LP solver settings.

Mirrors the reference `pdlp_solver_settings_t`
(cpp/include/cuopt/linear_programming/pdlp/solver_settings.hpp:70, tolerance
defaults :179-188). The string-keyed registry and MIP settings wait for
the slices that port those solvers (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from cuopt_torch import constants as C


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
