"""Crossover: polish a PDLP interior solution to a basic (vertex) solution.

Counterpart of cuopt_tpu/dual_simplex/crossover.py, which mirrors the
reference `crossover()` (cpp/src/dual_simplex/crossover.hpp:38): the
interior PDLP point (x*, y*) IS the input. The native dual simplex
receives it as a crossover hint: nonbasic placements come from the sign of
the PDLP reduced costs d* = c - A^T y*, ties broken toward the bound nearer
to x*_j (cpp/dual_simplex/simplex.cpp InitBasis y_hint branch). Since the
PDLP duals are near-optimal, the placements are near-final and the dual
simplex typically needs few pivots to reach the optimal vertex.

Unlike cuopt_tpu, a simplex library that fails to build or load raises
here instead of keeping the PDLP point in silence.
"""

from __future__ import annotations

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.utils.logger import get_logger

# what the vertex result keeps of the PDLP run: its steps and attempts
# (cuopt_tpu keeps the steps only), its timing split and its warm-start
# state
_PDLP_KEYS = ("iterations", "attempts", "restarts", "compile_s",
              "build_s", "solve_loop_s", "loop_steps", "loop_attempts",
              "graph_slots", "graph_count_reads", "step_kernel_slots",
              "warm_start_data", "warm_start_data_fn")


def crossover(prob, pdlp_raw, settings, timer):
    """Push the PDLP solution in `pdlp_raw` to an exact vertex. If the
    simplex ends short of OPTIMAL, the PDLP solution is kept, with the
    simplex's status as crossover_status."""
    log = get_logger()
    raw = solve_lp_simplex(
        prob, settings, timer,
        x_hint=pdlp_raw.get("primal_solution"),
        y_hint=pdlp_raw.get("dual_solution"),
        want_vstat=True,
    )
    if raw["status"] != C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
        # e.g. NUMERICAL_ERROR when the crash basis does not factorize
        # (the port's copy of the simplex returns it there, where the
        # shared source reads a vector it never filled: kernels/build.py
        # SIMPLEX_PATCHES)
        log.warning("crossover failed (simplex status "
                    f"{raw['status']}); keeping the PDLP solution")
        out = dict(pdlp_raw)
        out["crossover_status"] = raw["status"]
        return out
    raw["solved_by"] = "pdlp+crossover"
    raw["crossover_iterations"] = raw["iterations"]
    for k in _PDLP_KEYS:
        if k in pdlp_raw:
            raw[k] = pdlp_raw[k]
    log.info(
        f"crossover: vertex objective {raw['primal_objective']:.10g} "
        f"in {raw['crossover_iterations']} simplex iterations "
        f"(PDLP {pdlp_raw['primal_objective']:.10g})")
    return raw
