"""LP solution object.

Mirrors the reference `optimization_problem_solution_t`
(cpp/include/cuopt/linear_programming/pdlp/solver_solution.hpp:55, status
enum :37) and the Python `Solution` wrapper
(python/cuopt/cuopt/linear_programming/solution/solution.py). Besides the
reference's keys, the termination information carries the port's timing
split (compile_s: the device problem's build plus the first major;
build_s: the build alone, inside compile_s; solve_loop_s, loop_steps,
loop_attempts: the majors after the first; graph_slots,
graph_count_reads: the PDHG step driver's slots, one an attempt, and
its step-count reads; step_kernel_slots: those of the slots that ran
the hand-written step kernels, every one on a card; restarts: the majors
whose tail restarted the iterates), a crossover's pivots, the
concurrent race's record ("race") and, when the PDLP leg of a race
failed, its error ("pdlp_error"). A member of a batch_solve batch
(solved_by "pdlp_batch") adds the batch's counters, the same in every
member: batch_size, batch_passes (attempt passes), batch_syncs (a read
a pass and a packed read a major), batch_steps (the stacked loop's
steps), and the walls batch_build_s and batch_loop_s. A MIP solve
adds its node count, gap and bound, the errors its heuristics caught
("heuristic_errors"), the engine of each LP of its tree ("mip_stats")
and its FJ climbers' device, chunks stepped, batch and scoring block
("fj").
"""

from __future__ import annotations

import numpy as np

from cuopt_torch import constants as C

_STATUS_STRINGS = {
    C.CUOPT_TERIMINATION_STATUS_NO_TERMINATION: "NoTermination",
    C.CUOPT_TERIMINATION_STATUS_OPTIMAL: "Optimal",
    C.CUOPT_TERIMINATION_STATUS_INFEASIBLE: "Infeasible",
    C.CUOPT_TERIMINATION_STATUS_UNBOUNDED: "Unbounded",
    C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT: "IterationLimit",
    C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT: "TimeLimit",
    C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR: "NumericalError",
    C.CUOPT_TERIMINATION_STATUS_PRIMAL_FEASIBLE: "PrimalFeasible",
    C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND: "FeasibleFound",
    C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT: "ConcurrentLimit",
}


class Solution:
    def __init__(self, prob, raw: dict):
        self._prob = prob
        self._raw = raw

    # --- termination ---
    def get_termination_status(self) -> int:
        return self._raw["status"]

    def get_termination_reason(self) -> str:
        return _STATUS_STRINGS.get(self._raw["status"], "Unknown")

    def get_termination_string(self) -> str:
        return self.get_termination_reason()

    # --- solutions ---
    def get_primal_solution(self) -> np.ndarray:
        return self._raw["primal_solution"]

    def get_dual_solution(self) -> np.ndarray:
        return self._raw.get("dual_solution")

    def get_reduced_costs(self) -> np.ndarray:
        return self._raw.get("reduced_cost")

    def get_primal_objective(self) -> float:
        return self._raw["primal_objective"]

    def get_dual_objective(self) -> float:
        return self._raw.get("dual_objective", float("nan"))

    def get_objective_value(self) -> float:
        return self.get_primal_objective()

    # --- stats ---
    def get_solve_time(self) -> float:
        return self._raw.get("solve_time", 0.0)

    def get_nb_iterations(self) -> int:
        return self._raw.get("iterations", 0)

    def get_additional_termination_information(self) -> dict:
        keys = (
            "primal_objective", "dual_objective", "gap",
            "l2_primal_residual", "l2_dual_residual",
            "linf_primal_residual", "linf_dual_residual",
            "iterations", "attempts", "restarts", "solve_time", "solved_by",
            "compile_s", "build_s", "solve_loop_s", "loop_steps",
            "loop_attempts", "graph_slots", "graph_count_reads",
            "step_kernel_slots", "crossover_iterations", "crossover_status",
            "race", "pdlp_error",
            "nodes", "mip_gap", "solution_bound", "heuristic_errors",
            "mip_stats", "fj",
        )
        return {k: self._raw[k] for k in keys if k in self._raw}

    def get_pdlp_warm_start_data(self):
        """Full PDLP internal state for re-solves (reference
        pdlp_warm_start_data.hpp; settable via
        PDLPSolverSettings.set_pdlp_warm_start_data), captured on first
        access."""
        ws = self._raw.get("warm_start_data")
        if ws is None:
            fn = self._raw.get("warm_start_data_fn")
            if fn is not None:
                ws = self._raw["warm_start_data"] = fn()
        return ws

    # --- MIP extras (set by mip/solve.py) ---
    def get_mip_gap(self) -> float:
        return self._raw.get("mip_gap", float("nan"))

    def get_solution_bound(self) -> float:
        return self._raw.get("solution_bound", float("nan"))

    def get_vars(self) -> dict:
        x = self._raw["primal_solution"]
        return dict(zip(self._prob.variable_names, x.tolist()))

    def get_lp_stats(self) -> dict:
        return self.get_additional_termination_information()

    # --- .sol file (reference solver_solution write_to_sol_file) ---
    def write_to_sol_file(self, path: str):
        with open(path, "w") as f:
            status = self.get_termination_reason()
            if self._raw["status"] in (
                C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
                C.CUOPT_TERIMINATION_STATUS_PRIMAL_FEASIBLE,
                C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND,
            ):
                f.write(f"# Status: {status}\n")
                f.write(
                    f"# Objective value = {self.get_primal_objective():.17g}\n"
                )
                for name, v in zip(
                    self._prob.variable_names, self._raw["primal_solution"]
                ):
                    f.write(f"{name} {v:.17g}\n")
            else:
                f.write(f"# Status: {status}\n")
