"""Drive every distribution axis once, at tiny shapes.

    python -m cuopt_torch.parallel.dryrun 4                 # four cards
    python -m cuopt_torch.parallel.dryrun 4 --devices cuda:0,cuda:0,cuda:0,cuda:0
    python -m cuopt_torch.parallel.dryrun 8 --devices cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu

The counterpart of cuopt_tpu's __graft_entry__.dryrun_multichip: one
sharded PDLP major on a block-band operator (rows), a frontier batch of
node relaxations split over the shards (batch), one routing island epoch
(islands) and, for an even n of at least 4, the 2 x (n/2) hierarchical
psum (slices x rows). Shards on one card check the code, not scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run each axis on a mesh of n_devices shards (the first n cards, or
    the entries of `devices`) and return what each produced; a failed
    check raises."""
    from cuopt_torch import constants as C
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.lp.batch import batch_solve
    from cuopt_torch.lp.pdlp import (
        PdlpSolver,
        build_device_problem,
        initial_state,
        make_major_fn,
    )
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.parallel.sharding import (
        hierarchical_psum,
        make_mesh,
        make_mesh_2d,
        shard_problem_and_state,
    )
    from cuopt_torch.problem.synthetic import generate_lp
    from cuopt_torch.routing.construction import cheapest_insertion
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.islands import island_epoch, make_island_members
    from cuopt_torch.routing.local_search import build_ls_problem

    mesh = make_mesh(n_devices, devices=devices)
    home = mesh.devices[0]
    out = {"shards": mesh.size, "devices": sorted({str(d) for d in
                                                   mesh.devices})}

    # rows: one PDLP major, at least two row tiles per shard
    n_rows = 128 * max(2 * n_devices, 8)
    prob = generate_lp(n_rows, n_rows, 8, seed=7, band=192)
    s = PDLPSolverSettings()
    s.dtype = "float32"
    solver = PdlpSolver(prob, s, home)
    dev = build_device_problem(prob, solver.hp, torch.float32, "blockband",
                               home)
    state = initial_state(dev, solver.hp, torch.float32)
    sdev, sstate = shard_problem_and_state(dev, state, mesh)
    _, report = make_major_fn(solver.cfg)(sdev, sstate)
    steps = int(report["total_steps"])
    kkt = float(report["kkt_cur"])
    if steps <= 0 or not np.isfinite(kkt):
        raise RuntimeError(f"sharded major: {steps} steps, kkt {kkt}")
    out["rows"] = dict(n=n_rows, steps=steps, kkt=kkt,
                       halo=sdev.shards[0].op.halo_meta is not None,
                       collectives=report["collectives"])

    # batch: a frontier of node relaxations, one member per shard
    base = generate_lp(256, 256, 6, seed=3, band=96)
    rng = np.random.default_rng(0)
    nodes = []
    for _ in range(n_devices):
        uv = base.variable_upper_bounds.copy()
        uv[rng.integers(0, base.n_variables, 4)] = 0.5
        nodes.append(dataclasses.replace(base, variable_upper_bounds=uv))
    sb = PDLPSolverSettings()
    sb.method = C.CUOPT_METHOD_PDLP
    sb.set_optimality_tolerance(1e-3)
    sb.iteration_limit = 2000
    sols = batch_solve(nodes, sb, home, mesh=mesh)
    if len(sols) != n_devices:
        raise RuntimeError(f"batch: {len(sols)} answers for {n_devices}")
    out["batch"] = [s_.get_termination_reason() for s_ in sols]

    # islands: two members per island, three sweep steps
    rprob = build_problem(synth_gh_instance(24, "C", seed=3).to_data_model())
    routes, unserved = cheapest_insertion(rprob)
    if unserved:
        raise RuntimeError(f"islands: construction left {unserved}")
    F = rprob.n_fleet
    L = max(8, max((len(r) for r in routes.values()), default=0) + 4)
    R0 = -np.ones((F, L), np.int64)
    lens0 = np.zeros(F, np.int64)
    for v, r in routes.items():
        R0[v, :len(r)] = r
        lens0[v] = len(r)
    base_cost = sum(rprob.route_cost(v, r) for v, r in routes.items() if r)
    lsp = build_ls_problem(rprob, device=home)
    Rs, lenss = make_island_members(rprob, R0, lens0, n_devices * 2)
    _, _, costs, best = island_epoch(lsp, torch.as_tensor(Rs, device=home),
                                     torch.as_tensor(lenss, device=home),
                                     mesh, n_steps=3)
    if not (float(best) <= base_cost + 1e-6 and
            bool(torch.isfinite(costs).all())):
        raise RuntimeError(f"islands: best {float(best)} against "
                           f"construction {base_cost}")
    out["islands"] = dict(best=float(best), construction=base_cost)

    # slices x rows: the two-stage sum
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh_2d(2, n_devices // 2, devices=devices)
        v = torch.arange(1024, dtype=torch.float32, device=home)
        got = float(hierarchical_psum(v, mesh2))
        if abs(got - float(v.sum())) >= 1e-3:
            raise RuntimeError(f"hierarchical psum {got} != {float(v.sum())}")
        out["mesh2d"] = dict(shape=list(mesh2.shape), sum=got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, help="shards")
    ap.add_argument("--devices", help="comma-separated devices, one per "
                    "shard (default: the first n cards)")
    a = ap.parse_args(argv)
    devices = a.devices.split(",") if a.devices else None
    print(json.dumps(dryrun_multichip(a.n, devices)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
