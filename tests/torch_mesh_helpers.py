"""Shared helpers of the port's multi-device tests.

cuopt_tpu's side of each comparison runs on an 8-device CPU mesh: in the
test's process when JAX already has 8 devices (tests/conftest.py forces
them before JAX is imported), else in a subprocess with the same
environment as tests/test_multichip.py. Either way it returns a flat dict
of numpy arrays, so the two paths hand the port the same inputs.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8_ENV = {
    "JAX_PLATFORMS": "cpu",
    "JAX_PLATFORM_NAME": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                 "--xla_cpu_multi_thread_eigen=false",
}


def flatten(prefix: str, obj, out: dict) -> dict:
    """A dataclass (or dict) of arrays, numbers, tuples and nested ones as
    {"prefix/field/...": numpy array}; None fields are left out."""
    items = (((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
             if dataclasses.is_dataclass(obj) else obj.items())
    if dataclasses.is_dataclass(obj):
        out[f"{prefix}/kind"] = np.asarray(type(obj).__name__)
    for k, v in items:
        if v is None or k in ("mesh", "ext_row_slabs", "ext_row_starts",
                              "halo_meta"):
            continue
        if dataclasses.is_dataclass(v) or isinstance(v, dict):
            flatten(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of `flatten`'s output under `prefix`: 0-d integer
    and string arrays become Python values, the rest stay arrays."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        v = np.asarray(v)
        if v.ndim == 0 and v.dtype.kind in "iuU":
            v = v.item()
        d[parts[-1]] = v
    return out


def run_tpu(module_file: str, fn, *args) -> dict:
    """cuopt_tpu's side `fn(*args)` (a function of `module_file` that
    returns a flat dict of arrays) on an 8-device CPU mesh."""
    import jax

    if len(jax.devices()) >= 8:
        return fn(*args)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.npz")
        env = {**os.environ, **CPU8_ENV,
               "PYTHONPATH": ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", "")}
        r = subprocess.run([sys.executable, module_file, fn.__name__, path,
                            *map(str, args)], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        with np.load(path) as z:
            return dict(z)


def serve(namespace: dict) -> None:
    """Entry point of a test module run as a subprocess by run_tpu:
    argv = [fn name, output path, args...]."""
    fn = namespace[sys.argv[1]]
    args = [int(a) if a.lstrip("-").isdigit() else a for a in sys.argv[3:]]
    np.savez(sys.argv[2], **fn(*args))
