"""Public routing API, mirroring `cuopt.routing`
(python/cuopt/cuopt/routing/): DataModel, SolverSettings, Solve,
Assignment, SolutionStatus, Objective.
"""

from cuopt_torch.routing.assignment import (  # noqa: F401
    Assignment,
    Objective,
    SolutionStatus,
)
from cuopt_torch.routing.data_model import DataModel  # noqa: F401
from cuopt_torch.routing.generator import (  # noqa: F401
    DatasetParams,
    generate_dataset,
)
from cuopt_torch.routing.re_routing import (  # noqa: F401
    construct_rerouting_model,
)
from cuopt_torch.routing.settings import SolverSettings  # noqa: F401
from cuopt_torch.routing.solver import Solve  # noqa: F401

__all__ = [
    "DataModel", "SolverSettings", "Solve", "Assignment",
    "SolutionStatus", "Objective", "DatasetParams", "generate_dataset",
    "construct_rerouting_model",
]
