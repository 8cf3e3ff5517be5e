"""f64_steps_per_solve: `lp_steps_per_solve` in the float64 cell."""

from perfbench.metrics.lp_steps_per_solve import read  # noqa: F401
