"""Host dual simplex (C++), mirroring reference cpp/src/dual_simplex/.

Counterpart of cuopt_tpu/dual_simplex. The native library is built from
cpp/dual_simplex at first use (kernels/build.py); a failed build raises.
"""

from __future__ import annotations


def is_available() -> bool:
    """Whether the native library builds and loads here. Nothing branches
    on it: the solvers build the library themselves and raise if they
    cannot."""
    from cuopt_torch.dual_simplex.bindings import load_library

    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def solve_with_dual_simplex(prob, settings, timer):
    from cuopt_torch.dual_simplex.bindings import solve_lp_simplex

    return solve_lp_simplex(prob, settings, timer)


def run_concurrent_lp(prob, settings, timer, device="cuda"):
    from cuopt_torch.dual_simplex.concurrent import run_concurrent

    return run_concurrent(prob, settings, timer, device)
