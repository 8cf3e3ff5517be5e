"""LP solver settings.

Mirrors the reference `pdlp_solver_settings_t`
(cpp/include/cuopt/linear_programming/pdlp/solver_settings.hpp:70, tolerance
defaults :179-188) and the MIP settings (mip/solver_settings.hpp). The
string-keyed registry waits for the slice that ports the surface (ROADMAP
Queue 1 item 11).
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
