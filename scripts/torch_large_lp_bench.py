#!/usr/bin/env python3
"""Large-LP run of cuopt_torch on one card: 1M x 1M, 50M nonzeros.

    python scripts/torch_large_lp_bench.py                 # 1,000,000 rows
    python scripts/torch_large_lp_bench.py --device cpu --rows 3000 --nnz 8

cuopt_torch's counterpart of scripts/large_lp_bench.py:
generate_lp(rows, rows, nnz, seed=11, band=256) and its copy under a
default_rng(4) row and column permutation (which the operator must
reorder back into a band), each solved by PDLP alone in float32 to --tol
(1e-4, iteration limit 200,000): once cold (the device problem's build
and the kernels' nvcc build at first use included), then again warm
(the device problem cached on the problem object). Above 2^18 columns
every step attempt runs row_pass_partials; each solve's launches of both
row-pass kernels are counted from 0. Recorded per solve: status,
objective, steps, walls, steps/s, the row and column slabs' bytes, and
the device's peak allocated memory (torch.cuda.max_memory_allocated after
reset_peak_memory_stats) and free / total memory (mem_get_info). One JSON
line per solve, the whole record last; --out writes it to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def memory(device):
    """Peak allocated and free / total bytes of a CUDA device."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return {"max_allocated_bytes": int(torch.cuda.max_memory_allocated(
        device)), "free_bytes": int(free), "total_bytes": int(total)}


def solve_one(prob, label, tol, device):
    import torch

    from cuopt_torch import constants as C
    from cuopt_torch.lp import pdhg_fused
    from cuopt_torch.lp.pdlp import cached_device_problem
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.set_optimality_tolerance(tol)
    s.iteration_limit = 200_000
    s.dtype = "float32"  # the fused row pass
    s.log_to_console = False
    cuda = torch.device(device).type == "cuda"
    out = {"label": label}
    for when in ("cold", "warm"):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        pdhg_fused.reset_counts()
        t0 = time.perf_counter()
        sol = solve_lp(prob, s, device=device)
        x = sol.get_primal_solution()  # a host copy: the device is done
        wall = time.perf_counter() - t0
        raw = sol._raw
        out[when] = {
            "status": int(sol.get_termination_status()),
            "objective": float(sol.get_primal_objective()),
            "iterations": int(raw.get("iterations", 0)),
            "wall_s": round(wall, 3),
            "compile_s": raw.get("compile_s"),
            "solve_loop_s": raw.get("solve_loop_s"),
            "iters_per_s": round(int(raw.get("iterations", 0))
                                 / max(wall, 1e-9), 1),
            "launches": {k.name: k.launches for k in pdhg_fused.KERNELS},
            "device_memory": memory(device),
            "finite": bool(np.all(np.isfinite(x))),
        }
    op = cached_device_problem(prob).op
    out["operator"] = type(op).__name__
    if hasattr(op, "row_slabs"):
        out["row_slab_bytes"] = int(op.row_slabs.numel()) * 4
        out["col_slab_bytes"] = int(op.col_slabs.numel()) * 4
        out["row_slab_shape"] = list(op.row_slabs.shape)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--nnz", type=int, default=50)
    ap.add_argument("--band", type=int, default=256)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch.problem.synthetic import generate_lp
    from cuopt_torch.sparse.reorder import permute_csr
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    N = a.rows
    t0 = time.perf_counter()
    prob = generate_lp(N, N, a.nnz, seed=11, band=a.band)
    gen_s = time.perf_counter() - t0
    print(f"generated {N}x{N} nnz={prob.nnz} in {gen_s:.1f}s", flush=True)
    results = {"device": card["name"], "power_limit": card["power_limit"],
               "rows": N, "cols": N, "nnz": int(prob.nnz),
               "tolerance": a.tol, "generate_s": round(gen_s, 3)}

    r = solve_one(prob, "banded", a.tol, a.device)
    print(json.dumps(r), flush=True)
    results["banded"] = r

    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    rp, cp = rng.permutation(N), rng.permutation(N)
    o, i, v = permute_csr(
        np.asarray(prob.offsets), np.asarray(prob.indices),
        np.asarray(prob.values, np.float64), rp, cp, N, N)
    shuffled = dataclasses.replace(
        prob, offsets=o, indices=i, values=v,
        constraint_lower_bounds=prob.constraint_lower_bounds[rp],
        constraint_upper_bounds=prob.constraint_upper_bounds[rp],
        rhs=prob.rhs[rp], row_types=prob.row_types[rp],
        objective_coefficients=prob.objective_coefficients[cp],
        variable_lower_bounds=prob.variable_lower_bounds[cp],
        variable_upper_bounds=prob.variable_upper_bounds[cp])
    results["shuffle_s"] = round(time.perf_counter() - t0, 3)
    r = solve_one(shuffled, "shuffled_unstructured", a.tol, a.device)
    print(json.dumps(r), flush=True)
    results["shuffled"] = r
    results["row_pass_partials_launches"] = sum(
        results[k][w]["launches"]["row_pass_partials"]
        for k in ("banded", "shuffled") for w in ("cold", "warm"))
    line = json.dumps(results)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    cuda = a.device.startswith("cuda")
    if cuda and N > 1 << 18 and results["row_pass_partials_launches"] == 0:
        print("row_pass_partials was never launched", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
