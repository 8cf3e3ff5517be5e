"""Build the port's native code at first use.

Two kinds of library, both with a plain C interface that the Python side
loads with ctypes and both cached in cuopt_torch/_build/ under a name that
carries a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is:

  - the CUDA sources cuopt_torch/csrc/<name>.cu, compiled by nvcc for
    sm_90a (`Builder.library(name)`);
  - the host dual simplex, cpp/dual_simplex/simplex.cpp (shared with
    cuopt_tpu, which builds it into a library of its own), compiled by
    g++ under cuopt_tpu's flags (`Builder.simplex_library()`; see
    HOST_FLAGS).

Nothing here runs at import time; a missing compiler or a failed compile
raises, with the compiler's output in the message. Several processes may
build one library at once: each writes a file of its own and renames it
into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SIMPLEX_DIR = Path(__file__).resolve().parents[2] / "cpp" / "dual_simplex"
SIMPLEX_SOURCES = ("simplex.cpp", "sparse_lu.hpp")
# cuopt_tpu's flags, plus -fno-gnu-unique: the simplex options are C++
# inline variables, which g++ otherwise binds once per process across
# every library that defines them, so this library would share its options
# with cuopt_tpu's copy. The flag changes the symbols' binding only; the
# machine code is the same (objdump -d of both builds is identical).
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-fno-gnu-unique")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of cuopt_torch "
        "are compiled from cuopt_torch/csrc at first use")


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the host dual simplex of cuopt_torch is "
            "compiled from cpp/dual_simplex/simplex.cpp at first use")
    return found


def target(name: str) -> Path:
    """Library path for csrc/<name>.cu at its current content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def simplex_target() -> Path:
    """Library path for the host simplex at its sources' current content."""
    h = hashlib.sha256()
    for f in SIMPLEX_SOURCES:
        h.update((SIMPLEX_DIR / f).read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"libsimplex-{h.hexdigest()[:16]}.so"


class Builder:
    """Compiles sources on demand and keeps the loaded libraries and the
    compilers' output (for nvcc, ptxas' registers, shared memory and
    spills per kernel)."""

    SIMPLEX = "simplex"

    def __init__(self):
        self.libs: dict[str, ctypes.CDLL] = {}
        self.log: dict[str, str] = {}
        self._locks: dict[str, threading.Lock] = {}

    def _compile(self, name: str, lib: Path, command: list[str],
                 source: Path) -> float | None:
        """Run `command -o <tmp> source` unless `lib` exists, then rename
        the output into place. Returns the compile's seconds, or None when
        the library was already built."""
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([*command, "-o", str(tmp), str(source)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        self.log[name] = r.stdout
        if r.returncode != 0:
            raise RuntimeError(
                f"{Path(command[0]).name} failed on {source}:\n{r.stdout}")
        os.replace(tmp, lib)  # atomic against concurrent builds
        return time.perf_counter() - t0

    def build(self, name: str) -> float | None:
        """Compile csrc/<name>.cu unless its library exists."""
        return self._compile(name, target(name), [nvcc(), *FLAGS],
                             CSRC / f"{name}.cu")

    def build_simplex(self) -> float | None:
        """Compile cpp/dual_simplex/simplex.cpp unless its library exists,
        with the flags cuopt_tpu builds it under."""
        return self._compile(self.SIMPLEX, simplex_target(),
                             [gxx(), *HOST_FLAGS], SIMPLEX_DIR / "simplex.cpp")

    def _load(self, name: str, build, path) -> ctypes.CDLL:
        # one lock per library: the simplex of a concurrent solve must not
        # wait behind the CUDA build of the other leg
        with self._locks.setdefault(name, threading.Lock()):
            lib = self.libs.get(name)
            if lib is None:
                build()
                lib = self.libs[name] = ctypes.CDLL(str(path()))
            return lib

    def library(self, name: str) -> ctypes.CDLL:
        return self._load(name, lambda: self.build(name),
                          lambda: target(name))

    def simplex_library(self) -> ctypes.CDLL:
        return self._load(self.SIMPLEX, self.build_simplex, simplex_target)


BUILDER = Builder()
