"""Driver for configurations whose requests are LP solves through the
program's public entry, `cuopt_torch.lp.solve.solve_lp`.

A request is a distinct LP made from the run's seed and the request's
index (`perfbench.lpgen`: the configuration's `generator` sizes, shuffled
when the traffic says so). Making it is the client's work; `call` times
only the solve, from the call into solve_lp to the solution on the host.
`judge` holds each answer against the plain reference
(`perfbench.reference.kkt`), which works from the LP's own arrays.

A driver module gives the harness one class, `Driver(config, traffic,
device)`, with `setup`, `make`, `call`, `shape`, `judge` and `summary`;
see perfbench/README.md.
"""

from __future__ import annotations

import numpy as np

from perfbench import lpgen
from perfbench.reference import kkt

# statuses that make a claim about the LP: every benchmark LP is feasible
# and bounded, so either claim is a wrong answer
WRONG_CLAIMS = {"Infeasible", "Unbounded"}


def lp_seed(seed: int, *path: int) -> int:
    """A generator seed for one LP of the run: the same (seed, path)
    always gives the same LP, different paths different LPs."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0])


class Driver:
    """One run's client of the program: makes the requests, calls the
    entry, and hands the answers to the reference."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from cuopt_torch import constants as C
        from cuopt_torch.lp.settings import PDLPSolverSettings

        solver = config["solver"]
        s = PDLPSolverSettings()
        s.method = getattr(C, f"CUOPT_METHOD_{solver['method']}")
        s.dtype = solver["dtype"]
        s.set_optimality_tolerance(solver["optimality_tolerance"])
        s.operator_kind = solver["operator_kind"]
        s.log_to_console = False
        self.settings = s
        self.eps = solver["optimality_tolerance"]
        self.kkt_limit = config["check"]["kkt_limit"]
        self.gen = config["generator"]
        self.shuffle = bool(traffic["shuffle"])
        self.device = device

    def setup(self, seed: int) -> None:
        """The warm-up: one solve of the cell's shape on an LP that no
        request uses. On a checkout's first run the program builds its
        row-pass library here."""
        self.call(self.make(seed, -1))

    def lp(self, seed: int, index: int) -> dict:
        """The LP of request `index` (-1: the warm-up's)."""
        path = (0,) if index < 0 else (1, index)
        lp = lpgen.staircase(self.gen["n_rows"], self.gen["n_cols"],
                             self.gen["nnz_per_row"], self.gen["band"],
                             lp_seed(seed, *path))
        if self.shuffle:
            rng = np.random.default_rng(lp_seed(seed, 2, *path))
            lp = lpgen.shuffle(lp, rng)
        return lp

    def request(self, lp: dict) -> dict:
        """A request over `lp`: its arrays and the program's problem
        object over them."""
        from cuopt_torch.problem.data_model import OptimizationProblem

        return {"lp": lp, "problem": OptimizationProblem(
            offsets=lp["offsets"], indices=lp["indices"],
            values=lp["values"], objective_coefficients=lp["c"],
            constraint_lower_bounds=lp["lc"],
            constraint_upper_bounds=lp["uc"],
            variable_lower_bounds=lp["lv"],
            variable_upper_bounds=lp["uv"])}

    def make(self, seed: int, index: int) -> dict:
        """Request `index` of the run with `seed`."""
        return self.request(self.lp(seed, index))

    def call(self, request: dict) -> dict:
        """Solve the request through solve_lp; returns the answer: status,
        objective, x and y on the host, and the program's raw counters
        and times. The problem object, and the program's state on it,
        goes once solved."""
        from cuopt_torch.lp.solve import solve_lp

        sol = solve_lp(request.pop("problem"), self.settings,
                       device=self.device)
        raw = sol._raw
        return {
            "status": sol.get_termination_reason(),
            "objective": float(sol.get_primal_objective()),
            "x": np.asarray(sol.get_primal_solution()),
            "y": np.asarray(sol.get_dual_solution()),
            "raw": {k: raw[k] for k in (
                "iterations", "attempts", "compile_s", "solve_loop_s",
                "loop_steps", "loop_attempts", "l2_primal_residual",
                "l2_dual_residual", "gap", "primal_objective",
                "dual_objective") if k in raw},
        }

    def shape(self, request: dict) -> tuple[int, int, int]:
        """(rows, columns, nonzeros): the sizes the yardstick reads."""
        lp = request["lp"]
        return len(lp["lc"]), len(lp["c"]), len(lp["values"])

    def share(self, lp: dict, answer: dict) -> float:
        """The reference's worst share of the tolerance for an answer."""
        return kkt.worst(kkt.shares(lp, answer["x"], answer["y"],
                                    answer["objective"], self.eps))

    def judge(self, requests: list, answers: list) -> tuple[int, dict]:
        """(failed, checks). `checks` holds each number compared beside
        its limit: the worst KKT share over the optimal answers, the
        claims that a feasible bounded LP is infeasible or unbounded, and
        the solves that ended without an optimal answer (an iteration,
        time or numerical stop). `failed` counts the requests whose
        answer is not an optimal one within the limit."""
        worst, wrong, not_optimal, failed = None, 0, 0, 0
        for req, answer in zip(requests, answers):
            if answer["status"] == "Optimal":
                share = self.share(req["lp"], answer)
                worst = share if worst is None else max(worst, share)
                failed += share > self.kkt_limit
                continue
            failed += 1
            if answer["status"] in WRONG_CLAIMS:
                wrong += 1
            else:
                not_optimal += 1
        return failed, {
            "kkt_worst": {"value": worst, "limit": self.kkt_limit},
            "wrong_claims": {"value": wrong, "limit": 0},
            "not_optimal": {"value": not_optimal, "limit": 0},
        }

    def summary(self, answers: list) -> str:
        """The program's per-solve counters, for the run's solves line."""
        return (f"steps {[a['raw'].get('iterations') for a in answers]}, "
                f"first majors {[a['raw'].get('compile_s') for a in answers]}"
                f", statuses {sorted({a['status'] for a in answers})}")
