"""f64_loop_steps_per_s: `lp_loop_steps_per_s` in the float64 cell."""

from perfbench.metrics.lp_loop_steps_per_s import read  # noqa: F401
