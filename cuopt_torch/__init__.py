"""cuopt_torch — the PyTorch/CUDA port of cuopt_tpu for NVIDIA Hopper.

LP by restarted PDHG (PDLP) on the block-band operator, with the fused
row pass (Ax -> dual prox -> A^T y) as a hand-written sm_90a CUDA kernel
(csrc/row_pass.cu); batches of LPs as one stacked program (`batch_solve`);
MIP by branch-and-bound beside feasibility-jump climbers on the card
(`solve_mip`). Plain tensor code is PyTorch; every entry point runs on
`cuda` unless the caller passes `device="cpu"`, where each kernel's plain
PyTorch version serves instead.

The package imports neither JAX nor cuopt_tpu: cuopt_tpu stays beside it
as the reference that the tests hold it against.
"""

__version__ = "0.1.0"

from cuopt_torch.utils.errors import (  # noqa: E402
    CuOptTorchError,
    InputValidationError,
    MpsParseError,
    OutOfMemoryError,
    RuntimeError_,
    ValidationError,
)



def __getattr__(name):
    # the solvers load torch when first named, so that the thin client
    # and the service's front process, which solve nothing, start without
    # it
    if name == "batch_solve":
        from cuopt_torch.lp.batch import batch_solve

        return batch_solve
    if name == "solve_mip":
        from cuopt_torch.mip.solve import solve_mip

        return solve_mip
    raise AttributeError(f"module 'cuopt_torch' has no attribute {name!r}")


__all__ = [
    "batch_solve",
    "solve_mip",
    "CuOptTorchError",
    "InputValidationError",
    "MpsParseError",
    "ValidationError",
    "OutOfMemoryError",
    "RuntimeError_",
    "__version__",
]
