"""PDLP warm-start data: the solver's full internal state, out and back in.

Counterpart of cuopt_tpu/lp/warm_start.py, with role parity with the
reference `pdlp_warm_start_data_t`
(cpp/include/cuopt/linear_programming/pdlp/pdlp_warm_start_data.hpp;
populated at pdlp.cu:470-488, consumed via solver_settings.hpp:138-163):
current and averaged primal/dual iterates, restart snapshots, KKT scores,
step size, primal weight and counters. The state is stored as float64
numpy arrays in the solver's scaled space together with the scaling
diagonals, so it is valid for re-solves of the same problem (matrix
unchanged; bounds and objective may move, since the scaling depends only
on A). The field names and `to_dict` layout are cuopt_tpu's, so data
captured by either package restores in the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cuopt_torch.lp.pdlp import SolverState


@dataclass
class PdlpWarmStartData:
    current_primal_solution: np.ndarray
    current_dual_solution: np.ndarray
    current_ATY: np.ndarray
    current_AX: np.ndarray
    initial_primal_average: np.ndarray
    initial_dual_average: np.ndarray
    average_AX: np.ndarray
    average_ATY: np.ndarray
    last_restart_primal_solution: np.ndarray
    last_restart_dual_solution: np.ndarray
    row_scale: np.ndarray
    col_scale: np.ndarray
    initial_step_size: float
    initial_primal_weight: float
    sum_solution_weight: float
    last_restart_kkt_score: float
    last_candidate_kkt_score: float
    iterations_since_last_restart: int
    total_pdhg_iterations: int
    total_pdlp_iterations: int

    def to_dict(self) -> dict:
        """JSON-friendly representation (lists and Python scalars)."""
        return {k: v.tolist() if isinstance(v, np.ndarray) else v
                for k, v in self.__dict__.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "PdlpWarmStartData":
        return cls(**{
            f: np.asarray(d[f], float) if isinstance(d[f], list) else d[f]
            for f in cls.__dataclass_fields__})


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def capture_warm_start(dev, state) -> PdlpWarmStartData:
    """Snapshot a SolverState (device -> host). `dev` is anything with the
    device problem's row_scale and col_scale."""
    return PdlpWarmStartData(
        current_primal_solution=_host(state.x),
        current_dual_solution=_host(state.y),
        current_ATY=_host(state.aty),
        current_AX=_host(state.ax),
        initial_primal_average=_host(state.avg_x),
        initial_dual_average=_host(state.avg_y),
        average_AX=_host(state.avg_ax),
        average_ATY=_host(state.avg_aty),
        last_restart_primal_solution=_host(state.x_last_restart),
        last_restart_dual_solution=_host(state.y_last_restart),
        row_scale=_host(dev.row_scale),
        col_scale=_host(dev.col_scale),
        initial_step_size=float(state.step_size),
        initial_primal_weight=float(state.primal_weight),
        sum_solution_weight=float(state.sum_weights),
        last_restart_kkt_score=float(state.last_restart_kkt),
        last_candidate_kkt_score=float(state.last_candidate_kkt),
        iterations_since_last_restart=int(state.iters_since_restart),
        total_pdhg_iterations=int(state.total_attempts),
        total_pdlp_iterations=int(state.total_steps),
    )


def restore_state(ws: PdlpWarmStartData, dev, dtype):
    """Rebuild a SolverState from warm-start data for a re-solve, in
    `dtype` on the device problem's device.

    The stored iterates live in the scaled space of the ORIGINAL solve; if
    the new device problem uses different scaling diagonals (it should
    not, for the same matrix), the iterates are rebased through user
    space: x_new = x_old * (C_old / C_new).
    """
    device = dev.c.device
    rs_new, cs_new = _host(dev.row_scale), _host(dev.col_scale)
    # x_scaled = x_user / C ; y_scaled = y_user / R (build_device_problem)
    cx = ws.col_scale / cs_new
    ry = ws.row_scale / rs_new
    # (Ax)_user = ax_scaled / R ; (A^T y)_user = aty_scaled / C
    rx = rs_new / ws.row_scale
    cy = cs_new / ws.col_scale

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    def i(v):
        return torch.tensor(int(v), dtype=torch.int64, device=device)

    return SolverState(
        x=f(ws.current_primal_solution * cx),
        y=f(ws.current_dual_solution * ry),
        ax=f(ws.current_AX * rx),
        aty=f(ws.current_ATY * cy),
        step_size=f(ws.initial_step_size),
        primal_weight=f(ws.initial_primal_weight),
        sum_weights=f(ws.sum_solution_weight),
        avg_x=f(ws.initial_primal_average * cx),
        avg_y=f(ws.initial_dual_average * ry),
        avg_ax=f(ws.average_AX * rx),
        avg_aty=f(ws.average_ATY * cy),
        x_last_restart=f(ws.last_restart_primal_solution * cx),
        y_last_restart=f(ws.last_restart_dual_solution * ry),
        last_restart_kkt=f(ws.last_restart_kkt_score),
        last_candidate_kkt=f(ws.last_candidate_kkt_score),
        iters_since_restart=i(ws.iterations_since_last_restart),
        total_steps=i(ws.total_pdlp_iterations),
        total_attempts=i(ws.total_pdhg_iterations),
        numerical_error=torch.zeros((), dtype=torch.bool, device=device),
    )
