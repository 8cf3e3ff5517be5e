"""The device of the port's process entry points.

The CLI, the C ABI and the solver service's workers take no `device=`
argument: they solve on the device `entry_device()` names, read from the
environment variable CUOPT_TORCH_DEVICE. Unset, it is "cuda", so that a
process started without a card refuses to solve instead of carrying on on
the CPU; "cpu" is the one other value (the counterpart of the
JAX_PLATFORMS=cpu under which cuopt_tpu's processes run in its tests).
"""

from __future__ import annotations

import os

ENV = "CUOPT_TORCH_DEVICE"


def entry_device() -> str:
    value = os.environ.get(ENV)
    if value is None or value == "cuda":
        return "cuda"
    if value == "cpu":
        return "cpu"
    raise ValueError(f"{ENV}={value!r}: expected 'cuda' or 'cpu'")
