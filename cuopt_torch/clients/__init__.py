from cuopt_torch.clients.self_hosted import (
    CuOptServiceSelfHostClient,
    ThinClientSolverSettings,
)

__all__ = ["CuOptServiceSelfHostClient", "ThinClientSolverSettings"]
