"""Command-line solver, mirroring the reference `cuopt_cli`
(cpp/cuopt_cli.cpp): parses an MPS file, auto-generates `--<param>` flags
from the settings parameter registry (cuopt_cli.cpp:185-240), supports
`--initial-solution` and `--relaxation`, solves LP or MIP and prints the
solution summary / writes a .sol file.

Counterpart of cuopt_tpu/cli.py. The solve runs on the device that
CUOPT_TORCH_DEVICE names (utils/device.py): the card unless it says
"cpu"; without a card the solve raises.

Usage:  python -m cuopt_torch.cli <file.mps> [--param value ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from cuopt_torch.lp.settings import SolverSettings

    p = argparse.ArgumentParser(
        prog="cuopt_cli",
        description="cuOpt CLI on PyTorch/CUDA: solve an LP/MIP from an "
        "MPS file",
    )
    p.add_argument("mps_file", help="path to the MPS file")
    p.add_argument(
        "--initial-solution", default=None,
        help="path to a .sol file with an initial solution",
    )
    p.add_argument(
        "--relaxation", action="store_true",
        help="solve the LP relaxation of a MIP",
    )
    # flags autogenerated from the unified parameter registry
    reg = SolverSettings()
    for name in reg.parameter_names():
        ptype = reg.parameter_type(name)
        if ptype is bool:
            p.add_argument(
                f"--{name}", type=str, default=None,
                metavar="BOOL",
            )
        else:
            p.add_argument(f"--{name}", type=ptype, default=None)
    return p


def _read_initial_solution(path, prob):
    values = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                try:
                    values[parts[0]] = float(parts[1])
                except ValueError:
                    continue
    x = np.zeros(prob.n_variables)
    for j, name in enumerate(prob.variable_names):
        if name in values:
            x[j] = values[name]
    return x


def main(argv=None) -> int:
    from cuopt_torch import constants as C
    from cuopt_torch.io import parse_mps
    from cuopt_torch.linear_programming import Solve
    from cuopt_torch.lp.settings import SolverSettings
    from cuopt_torch.utils.device import entry_device
    from cuopt_torch.utils.errors import CuOptTorchError

    parser = build_parser()
    args = parser.parse_args(argv)
    settings = SolverSettings()
    for name in settings.parameter_names():
        val = getattr(args, name.replace("-", "_"), None)
        if val is not None:
            settings.set_parameter(name, val)
    try:
        prob = parse_mps(args.mps_file)
    except (CuOptTorchError, OSError) as exc:
        print(f"Error reading {args.mps_file}: {exc}", file=sys.stderr)
        return C.CUOPT_MPS_FILE_ERROR
    if args.relaxation:
        prob.variable_types = np.full(prob.n_variables, "C", "U1")
    if args.initial_solution:
        settings.pdlp.initial_primal_solution = _read_initial_solution(
            args.initial_solution, prob
        )
    try:
        sol = Solve(prob, settings, entry_device())
    except CuOptTorchError as exc:
        print(f"Solve error: {exc}", file=sys.stderr)
        return C.CUOPT_VALIDATION_ERROR
    info = sol.get_additional_termination_information()
    print(f"Status:    {sol.get_termination_reason()}")
    print(f"Objective: {sol.get_primal_objective():.10g}")
    if "iterations" in info:
        print(f"Iterations: {info['iterations']}")
    if "solve_time" in info:
        print(f"Time:      {info['solve_time']:.3f}s")
    return C.CUOPT_SUCCESS


if __name__ == "__main__":
    sys.exit(main())
