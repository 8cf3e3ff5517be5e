"""Routing SolverSettings, mirroring reference
cpp/include/cuopt/routing/solver_settings.hpp:46-97 and the Python
cuopt.routing.SolverSettings (vehicle_routing.py:1405)."""

from __future__ import annotations


class SolverSettings:
    def __init__(self):
        self.time_limit: float | None = None
        self.verbose = False
        self.error_logging = True
        self.best_results_file_path: str | None = None
        self.best_results_interval: float | None = None
        self.config_file: str | None = None
        # TPU-specific knobs
        self.seed: int = 0
        self.dtype: str = "float32"

    def set_time_limit(self, seconds):
        self.time_limit = float(seconds)

    def set_verbose_mode(self, verbose):
        self.verbose = bool(verbose)

    def set_error_logging_mode(self, logging):
        self.error_logging = bool(logging)

    def dump_best_results(self, file_path, interval):
        self.best_results_file_path = str(file_path)
        self.best_results_interval = float(interval)

    def dump_config_file(self, file_name):
        self.config_file = str(file_name)

    def get_time_limit(self):
        return self.time_limit

    def get_best_results_file_path(self):
        return self.best_results_file_path

    def get_best_results_interval(self):
        return self.best_results_interval

    def get_config_file_name(self):
        return self.config_file


def default_time_limit(n_orders: int, n_fleet: int) -> float:
    """Reference heuristic when no limit set (solver_settings.hpp:46-97
    documents an instance-size-based default)."""
    return max(2.0, 0.05 * n_orders + 0.01 * n_fleet)
