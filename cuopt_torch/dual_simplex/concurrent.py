"""Concurrent LP: the host dual simplex racing PDLP on the device.

Counterpart of cuopt_tpu/dual_simplex/concurrent.py, which mirrors the
reference run_concurrent (cpp/src/linear_programming/solve.cu:467-537):
the dual simplex on a thread of its own (std::thread, :492), PDLP on the
caller's thread, a shared halt flag (`global_concurrent_halt`, :222)
stopping the loser, the winner's solution returned.

  - The simplex leg is the native library (bindings.py). It polls the
    halt int every 32 pivots; the ctypes call releases the GIL, so both
    legs run at once.
  - Both legs start at once, as in the reference. cuopt_tpu's PDLP leg
    first waits up to 3 s for the simplex, so that a simplex win is not
    stuck behind its XLA compile; the port has no compile, and
    `PdlpSolver.run` checks the stop predicate before it builds the
    device problem and again once the CUDA kernels are loaded.
  - The PDLP leg is `PdlpSolver.run` itself, with a stop predicate checked
    between majors, so it honours every setting. (cuopt_tpu copies the
    major loop here instead, and the copy ignores detect_infeasibility,
    per_constraint_residual, save_best_primal_so_far and
    first_primal_feasible.)
  - The simplex wins with OPTIMAL, INFEASIBLE or UNBOUNDED; any other
    ending leaves the race to PDLP.

Where this differs from cuopt_tpu, without changing a result:
  - a CUDA solve without a card raises before the race, even when the
    simplex would have won;
  - the legs are isolated: if the PDLP leg raises, the simplex's answer is
    returned, with the error logged and kept under "pdlp_error"; only if
    both legs fail does the race raise (the PDLP leg's exception);
  - the simplex thread is halted and joined before the race returns, so
    none outlives it.

The result carries a record of the race under "race": the grace allowed
(0) and the seconds before the PDLP leg started, the simplex's own
status, and the seconds from setting halt to the simplex thread's
return.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex.bindings import load_library, solve_lp_simplex
from cuopt_torch.dual_simplex.crossover import crossover
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.utils.logger import get_logger

SIMPLEX_THREAD = "cuopt-torch-dual-simplex"
_SIMPLEX_WINS = (C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
                 C.CUOPT_TERIMINATION_STATUS_INFEASIBLE,
                 C.CUOPT_TERIMINATION_STATUS_UNBOUNDED)


class _SimplexLeg:
    """The native simplex on a thread of its own, stopped through `halt`."""

    def __init__(self, prob, settings, timer):
        self.halt = ctypes.c_int(0)
        self.done = threading.Event()
        self.raw = None
        self.error = None
        self.thread = threading.Thread(
            target=self._run, args=(prob, settings, timer),
            name=SIMPLEX_THREAD, daemon=True)
        self.thread.start()

    def _run(self, prob, settings, timer):
        try:
            self.raw = solve_lp_simplex(prob, settings, timer,
                                        halt=ctypes.pointer(self.halt))
        except Exception as exc:  # noqa: BLE001 — the other leg goes on
            self.error = exc
        finally:
            self.done.set()

    def won(self) -> bool:
        return self.done.is_set() and self.raw is not None and \
            self.raw["status"] in _SIMPLEX_WINS

    def stop(self) -> float:
        """Set halt and join the thread; returns the seconds between."""
        t0 = time.perf_counter()
        self.halt.value = 1
        self.thread.join()
        return time.perf_counter() - t0


def run_concurrent(prob, settings, timer, device="cuda"):
    log = get_logger()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a concurrent solve on 'cuda' needs a CUDA card; pass "
            "device='cpu' to run the PDLP leg on the CPU")
    load_library()  # built here, so that a failed build raises here
    t0 = time.perf_counter()
    leg = _SimplexLeg(prob, settings, timer)
    waited = time.perf_counter() - t0  # no grace: PDLP starts at once
    pdlp_raw = pdlp_error = None
    try:
        pdlp_raw = PdlpSolver(prob, settings, device).run(
            timer, stop=leg.won)
    except Exception as exc:  # noqa: BLE001 — the simplex may still answer
        pdlp_error = exc
        log.warning(f"Concurrent: the PDLP leg failed ({exc!r}); waiting "
                    "for the dual simplex", exc_info=True)
        leg.thread.join()
    finally:
        halt_latency = leg.stop()
    race = {
        "grace_s": 0.0,
        "grace_waited_s": waited,
        "simplex_status": None if leg.raw is None else leg.raw["status"],
        "simplex_iterations": None if leg.raw is None
        else leg.raw["iterations"],
        "halt_latency_s": halt_latency,
    }
    if leg.error is not None:
        race["simplex_error"] = repr(leg.error)
    if pdlp_error is not None:
        if leg.raw is None:  # both legs failed
            raise pdlp_error
        return {**leg.raw, "race": race, "pdlp_error": repr(pdlp_error)}
    if pdlp_raw["status"] == C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT:
        log.info("Concurrent: dual simplex finished first")
        return {**leg.raw, "race": race}
    log.info("Concurrent: PDLP finished first")
    raw = {**pdlp_raw, "solved_by": "pdlp"}
    if settings.crossover and \
            raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
        raw = crossover(prob, raw, settings, timer)
    raw["race"] = race
    return raw
