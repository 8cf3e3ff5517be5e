"""Driver for configurations whose requests are batches of LPs solved in
one call of the program's batch entry, `cuopt_torch.lp.batch.batch_solve`.

A request is one batch of `members` LPs that share one matrix and differ
in their variable bounds, as a MIP frontier's node LPs or a user's sweep
over the bounds of one model do. Its base LP is the one
`drivers/lp_solve.py` makes for the same seed and index (banded order);
member b copies the base and, with a generator of its own, draws
`moved_share` of the columns, of which a coin sends each to lv = `lower`
or to uv = `upper`. The base's CSR, objective and row bounds are shared
by every member. Making the batch and its problem objects is the
client's work; `call` times one batch_solve, from the call to the last
member's solution on the host.

`judge` holds every member's answer to its own LP (the shared arrays
with its own bounds) against the plain reference
(`perfbench.reference.kkt`), and holds its reported objective to c.x
computed in float64 from its x.
"""

from __future__ import annotations

import collections

import numpy as np

from perfbench.drivers import lp_solve
from perfbench.drivers.lp_solve import WRONG_CLAIMS, lp_seed

# the batch's own counters, the same in every member's raw result; a
# program without them gives none
COUNTERS = ("batch_size", "batch_passes", "batch_syncs", "batch_steps",
            "batch_build_s", "batch_loop_s")


def objective_drift(lp: dict, objective: float, x) -> float:
    """|objective - c.x| / (1 + |c.x|), with c.x in float64."""
    cx = float(np.asarray(lp["c"], np.float64)
               @ np.asarray(x, np.float64).reshape(-1))
    return abs(float(objective) - cx) / (1.0 + abs(cx))


class Driver(lp_solve.Driver):
    """One run's client of the program: makes the batches, calls the
    batch entry, and hands every member's answer to the reference. The
    settings, the warm-up, the base LP (`lp`) and the KKT share are
    those of drivers/lp_solve.py."""

    def __init__(self, config: dict, traffic: dict, device: str):
        super().__init__(config, traffic, device)
        self.drift_limit = config["check"]["objective_drift_limit"]
        self.members = int(traffic["members"])
        self.moved_share = float(traffic["moved_share"])
        self.lower = float(traffic["lower"])
        self.upper = float(traffic["upper"])

    def lps(self, seed: int, index: int) -> list[dict]:
        """The members of request `index`: the base's arrays, each with
        its own column bounds."""
        base = self.lp(seed, index)
        n = len(base["c"])
        out = []
        for b in range(self.members):
            path = (4, b) if index < 0 else (3, index, b)
            rng = np.random.default_rng(lp_seed(seed, *path))
            cols = rng.choice(n, int(round(n * self.moved_share)),
                              replace=False)
            low = rng.random(len(cols)) < 0.5
            lv, uv = base["lv"].copy(), base["uv"].copy()
            lv[cols[low]] = self.lower
            uv[cols[~low]] = self.upper
            out.append(dict(base, lv=lv, uv=uv))
        return out

    def make(self, seed: int, index: int) -> dict:
        """Request `index` of the run with `seed`: the members' arrays
        and the program's problem objects over them."""
        lps = self.lps(seed, index)
        return {"lps": lps, "problems": [self.request(lp)["problem"]
                                         for lp in lps]}

    def call(self, request: dict) -> dict:
        """Solve the request's members in one batch_solve; returns each
        member's status, objective, x and y on the host, and under `raw`
        each member's steps, attempts and engine, with the batch's own
        counters. The problem objects, and the device problems the
        program keeps on them, go once solved."""
        from cuopt_torch.lp.batch import batch_solve

        sols = batch_solve(request.pop("problems"), self.settings,
                           self.device)
        raws = [sol._raw for sol in sols]
        members = [{"status": sol.get_termination_reason(),
                    "objective": float(sol.get_primal_objective()),
                    "x": np.asarray(sol.get_primal_solution()),
                    "y": np.asarray(sol.get_dual_solution())}
                   for sol in sols]
        raw = {"iterations": [r.get("iterations") for r in raws],
               "attempts": [r.get("attempts") for r in raws],
               "solved_by": [r.get("solved_by") for r in raws]}
        raw.update({k: raws[0][k] for k in COUNTERS if k in raws[0]})
        return {"members": members, "raw": raw}

    def shape(self, request: dict) -> tuple[int, int, int, int]:
        """(rows, columns, nonzeros, members): the sizes the yardstick
        reads."""
        lp = request["lps"][0]
        return (len(lp["lc"]), len(lp["c"]), len(lp["values"]),
                len(request["lps"]))

    def judge(self, requests: list, answers: list) -> tuple[int, dict]:
        """(failed, checks). Every member is held to its own LP:
        `kkt_worst` is the worst KKT share over the optimal members,
        `objective_drift` the worst drift of a reported objective from
        c.x over them; `wrong_claims` and `not_optimal` count members.
        `failed` counts the requests with a member whose answer is not
        an optimal one within both limits."""
        worst = drift = None
        wrong = not_optimal = failed = 0
        for req, answer in zip(requests, answers):
            bad = False
            for lp, m in zip(req["lps"], answer["members"]):
                if m["status"] != "Optimal":
                    bad = True
                    if m["status"] in WRONG_CLAIMS:
                        wrong += 1
                    else:
                        not_optimal += 1
                    continue
                share = self.share(lp, m)
                d = objective_drift(lp, m["objective"], m["x"])
                worst = share if worst is None else max(worst, share)
                drift = d if drift is None else max(drift, d)
                bad |= share > self.kkt_limit or d > self.drift_limit
            failed += bad
        return failed, {
            "kkt_worst": {"value": worst, "limit": self.kkt_limit},
            "wrong_claims": {"value": wrong, "limit": 0},
            "not_optimal": {"value": not_optimal, "limit": 0},
            "objective_drift": {"value": drift, "limit": self.drift_limit},
        }

    def summary(self, answers: list) -> str:
        """The members' steps per request and who solved them, for the
        run's solves line."""
        by = collections.Counter(s for a in answers
                                 for s in a["raw"]["solved_by"])
        return (f"member steps {[a['raw']['iterations'] for a in answers]}"
                f", solved_by {dict(by)}, statuses "
                f"{sorted({m['status'] for a in answers for m in a['members']})}")
