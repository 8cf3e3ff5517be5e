#!/usr/bin/env python3
"""chip_smoke.py phase 20's two routing solves, counted, for one checkout.

    python scripts/torch_pd_recheck.py                        # the card
    python scripts/torch_pd_recheck.py --device cpu --limit 5
    python scripts/torch_pd_recheck.py --root .checkout/parent

Solves phase 20's GHC_200_1-pd (`gh200_pd`) for --limit seconds and its
GHC_200_1 with 20 precedence chains (`gh200_chains`) for --chains-limit
seconds, seed 0, with the cuopt_torch package of --root (this checkout by
default; a parent commit's, to compare the two in one run). The instances,
the counting (`counted_solve`) and the host recheck (`host_model_check`)
are chip_smoke.py's of this checkout. Prints one JSON line per solve: the
package's root, the device (and the card's name and power limit from
nvidia-smi), status, vehicles, cost, orders undeliverable, the largest
excess of the load carried after a stop over the capacity, the local
search's host rechecks of device moves (checked, passed on cost and
feasibility, rejected) and the diversity loop's children.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit", type=float, default=10.0)
    ap.add_argument("--chains-limit", type=float, default=6.0)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = None
    if a.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    for name, dm, limit in (
            ("GHC_200_1-pd", smoke.gh200_pd(), a.limit),
            (f"GHC_200_1 + {smoke.CHAINS} chains", smoke.gh200_chains()[0],
             a.chains_limit)):
        sol, wall, st = smoke.counted_solve(dm, limit, a.device)
        chk = smoke.host_model_check(dm, sol.get_route())
        print(json.dumps(dict(
            solve=name, root=root, device=a.device, card=card,
            limit_s=limit, wall_s=round(wall, 3), status=sol.get_status(),
            vehicles=sol.get_vehicle_count(),
            cost=sol.get_total_objective(),
            undeliverable=len(sol.get_infeasible_orders()),
            carried_excess=chk["carried"], recheck_checked=st["checked"],
            recheck_passed=st["passed"],
            recheck_rejected=st["checked"] - st["passed"],
            children=st["children"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
