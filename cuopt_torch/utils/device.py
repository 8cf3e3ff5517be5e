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


def describe_device(device) -> dict:
    """What a measurement ran on. For a CUDA device: the card's name and
    power limit, as `nvidia-smi --query-gpu=name,power.limit` reports
    them, and torch's name for it; for the CPU: {"name": "cpu"} and no
    power limit. Raises when a CUDA device is asked for and there is no
    card: a measurement never carries on on the CPU."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"name": str(device), "power_limit": None, "smi": None}
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{device}: no CUDA card (torch.cuda.is_available() is False);"
            " pass --device cpu to run on the CPU")
    index = device.index if device.index is not None else 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": line.rsplit(",", 1)[-1].strip(), "smi": line}
