"""Build the port's native code at first use.

Libraries with a plain C interface that the Python side loads with
ctypes, each cached in cuopt_torch/_build/ under a name that carries a
hash of its sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is:

  - the CUDA sources cuopt_torch/csrc/<name>.cu, compiled by nvcc for
    sm_90a (`Builder.library(name)`);
  - the host dual simplex, cpp/dual_simplex/simplex.cpp, and the native
    MPS parser, cpp/mps_parser/mps_parser.cpp (both shared with
    cuopt_tpu, which builds them into libraries of its own), compiled by
    g++ under cuopt_tpu's flags (`Builder.simplex_library()`,
    `Builder.mps_library()`; see HOST_FLAGS); the simplex from a copy
    with its exits before x_B exists, its infeasibility and shortcut
    optimality claims and its rank repair's attempt count repaired
    (SIMPLEX_PATCHES);
  - the C ABI, cpp/c_api/cuopt_c.c (`Builder.capi_library()`), built
    from a copy that imports cuopt_torch.c_api_embed where the source
    names cuopt_tpu's bridge (and with one argument format repaired, see
    CAPI_PATCHES). It is not linked against libpython: loaded
    into a Python process it takes that interpreter's symbols, and a
    second libpython in one process would be a second interpreter. A C
    program links libpython itself, as the port's own caller
    csrc/c_api_check.c does (`Builder.c_api_check()`).

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
import site
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
REPO = Path(__file__).resolve().parents[2]
SIMPLEX_DIR = REPO / "cpp" / "dual_simplex"
SIMPLEX_SOURCES = ("simplex.cpp", "sparse_lu.hpp")
MPS_SOURCE = REPO / "cpp" / "mps_parser" / "mps_parser.cpp"
CAPI_DIR = REPO / "cpp" / "c_api"
CAPI_HEADER = REPO / "cpp" / "include" / "cuopt_c.h"
# (text in cpp/c_api/cuopt_c.c, the port's text, times it must occur):
# the Python bridge the library embeds, and the argument format of
# cuOptCreateProblem and cuOptCreateRangedProblem, which gives 13
# conversions ("iid...") for their 14 arguments, so the bridge receives
# objective_offset as the sense, the sense as the offset and no nnz, and
# both calls fail in cuopt_tpu's build (ROADMAP Queue 3)
CAPI_PATCHES = (
    ('"cuopt_tpu.c_api_embed"', '"cuopt_torch.c_api_embed"', 1),
    ('"(iidLLLLLLLLLi)"', '"(iiidLLLLLLLLLi)"', 2),
)
# (text in cpp/dual_simplex/simplex.cpp, the port's text, times): when
# the starting basis cannot be factorized (a crossover's crash basis can
# fail even after rank repair), Solve returns Finish(kNumerical, ...) at
# :99 and :120 before ComputeXb, and Finish reads the empty x_B, duals and
# reduced costs (:885), which kills the process (ROADMAP Queue 3). The
# port's copy returns NUMERICAL there with zero vectors of the right
# sizes, which the C entry point copies out as it copies any result.
SIMPLEX_PATCHES = (
    ("Finish(kNumerical, 0, x_out, y_out, dj_out,",
     "FinishUnfactored(kNumerical, 0, x_out, y_out, dj_out,", 2),
    ("  int Finish(int status, int iter, std::vector<double>* x_out,\n",
     "  // cuopt_torch's copy: a basis that never factorized has no x_B,\n"
     "  // duals or reduced costs to report\n"
     "  int FinishUnfactored(int status, int iter,\n"
     "                       std::vector<double>* x_out,\n"
     "                       std::vector<double>* y_out,\n"
     "                       std::vector<double>* dj_out,\n"
     "                       std::vector<int8_t>* vstat_out,\n"
     "                       int* iters_out) {\n"
     "    if (iters_out) *iters_out = iter;\n"
     "    x_out->assign(p_.n, 0.0);\n"
     "    y_out->assign(m_, 0.0);\n"
     "    dj_out->assign(p_.n, 0.0);\n"
     "    if (vstat_out) vstat_out->clear();\n"
     "    return status;\n"
     "  }\n\n"
     "  int Finish(int status, int iter, std::vector<double>* x_out,\n", 1),
    # Rank repair: Refactorize (:676-725) makes 8 attempts, each a
    # factorization followed, if it fails, by a repair that swaps the
    # dependent columns for slacks; the 8th repair's basis is never
    # factorized. From a crossover's crash basis (the 2k staircase's
    # float32 start 1 at 1e-4) the repairs swap 6, 6, 3, 2, 2, 2, 2 and 2
    # columns, and Solve gives up at :99 one factorization short. Every
    # such basis met so far (40 float32 points of four staircases)
    # factorizes at the 9th or 10th attempt; the port's copy allows 16.
    # The first 8 are the source's, so a basis that factorizes within them
    # is repaired as it was.
    ("    for (int attempt = 0; attempt < 8; ++attempt) {\n",
     "    for (int attempt = 0; attempt < 16; ++attempt) {\n", 1),
    # The two INFEASIBLE exits (:249 no entering candidate, :289 every
    # candidate bound-flips) take the row's ray as a certificate, but a
    # free column parked fixed at 0 (fake_bound_ 2, InitBasis :622-645 and
    # Refactorize :712-716) has no such bounds in the LP: the ray holds
    # only with them in place, and feasible LPs came back INFEASIBLE.
    # ReleaseParkedFree (:653) ran only on the optimality path (:199).
    # Before either exit the port's copy restores the true costs and
    # releases every parked column whatever its reduced cost
    # (ReviseInfeasibleClaim); if that changed anything the loop goes on.
    ("        if (std::getenv(\"DS_DEBUG\"))\n"
     "          std::fprintf(stderr, \"[ds] iter %d infeasible:",
     "        if (ReviseInfeasibleClaim()) continue;\n"
     "        if (std::getenv(\"DS_DEBUG\"))\n"
     "          std::fprintf(stderr, \"[ds] iter %d infeasible:", 2),
    ("  bool ReleaseParkedFree() {\n",
     "  bool ReleaseParkedFree(double min_dj = 1e-7) {\n", 1),
    ("      if (std::fabs(dj_[j]) <= 1e-7) continue;\n",
     "      if (std::fabs(dj_[j]) <= min_dj) continue;\n", 1),
    ("  bool Refactorize() {\n",
     "  // cuopt_torch's copy: before an infeasibility claim, the true\n"
     "  // costs and every parked free column back (released with\n"
     "  // ReleaseParkedFree's big bound, whatever its reduced cost; each\n"
     "  // release moves fake_bound_ from 2 to 1, so the claims end). True\n"
     "  // when the state changed and the claim must be made again.\n"
     "  bool ReviseInfeasibleClaim() {\n"
     "    bool changed = false;\n"
     "    if (perturbed_) {\n"
     "      perturbed_ = false;\n"
     "      RestoreCosts();\n"
     "      ComputeDualsAndPrices();\n"
     "      RepairDualFeasibility();\n"
     "      changed = true;\n"
     "    }\n"
     "    if (ReleaseParkedFree(-1.0)) {\n"
     "      ComputeXb();\n"
     "      changed = true;\n"
     "    }\n"
     "    return changed;\n"
     "  }\n\n"
     "  bool Refactorize() {\n", 1),
    # The shortcut (:245) that takes a violation under 1e-6 with no
    # entering candidate as optimal skipped the optimality claim's steps
    # (:184-211): it could answer under shifted costs (RepairDualFeasibility
    # shifts by the full dual infeasibility) with free columns still parked.
    # The port's copy takes those steps there too; the fresh factorization
    # they start from is the one just above it (:238-244).
    ("        if (violation < 1e-6) { status = kOptimal; break; }\n",
     "        if (violation < 1e-6) {\n"
     "          // cuopt_torch's copy: the optimality claim of the r < 0\n"
     "          // path, on the fresh factorization made just above\n"
     "          if (perturbed_) {\n"
     "            perturbed_ = false;\n"
     "            RestoreCosts();\n"
     "            ComputeDualsAndPrices();\n"
     "            RepairDualFeasibility();\n"
     "            continue;\n"
     "          }\n"
     "          if (ReleaseParkedFree()) {\n"
     "            ComputeXb();\n"
     "            continue;\n"
     "          }\n"
     "          status = kOptimal;\n"
     "          for (int i = 0; i < m_; ++i)\n"
     "            if (!std::isfinite(xb_[i])) {\n"
     "              status = kNumerical;\n"
     "              break;\n"
     "            }\n"
     "          break;\n"
     "        }\n", 1),
)
CHECK_SOURCE = CSRC / "c_api_check.c"
# cuopt_tpu's flags, plus -fno-gnu-unique: the simplex options are C++
# inline variables, which g++ otherwise binds once per process across
# every library that defines them, so this library would share its options
# with cuopt_tpu's copy. The flag changes the symbols' binding only; the
# machine code is the same (objdump -d of both builds is identical).
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-fno-gnu-unique")
# -I cpp/dual_simplex finds sparse_lu.hpp from the simplex's copy in _build/
SIMPLEX_FLAGS = HOST_FLAGS + ("-I", str(SIMPLEX_DIR))
# -I cpp/c_api keeps the source's #include "../include/cuopt_c.h" working
# from its copy in _build/
CAPI_FLAGS = ("-O2", "-fPIC", "-shared", "-I", str(CAPI_DIR), "-I",
              sysconfig.get_paths()["include"])


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
            "g++ not found: the host libraries of cuopt_torch are "
            "compiled from cpp/ at first use")
    return found


def gcc() -> str:
    found = shutil.which("gcc")
    if found is None:
        raise RuntimeError(
            "gcc not found: the C ABI of cuopt_torch is compiled from "
            "cpp/c_api/cuopt_c.c at first use")
    return found


def embed_ldflags() -> list[str]:
    """What `python3-config --ldflags --embed` prints for this
    interpreter, from the sysconfig values that script reads (a venv has
    no python3-config of its own), and an rpath to libpython's
    directory."""
    cv = sysconfig.get_config_var
    flags = [f"-L{cv('LIBDIR')}"]
    if not cv("Py_ENABLE_SHARED"):
        flags.append(f"-L{cv('LIBPL')}")
    flags += [f"-lpython{cv('LDVERSION')}", *cv("LIBS").split(),
              *cv("SYSLIBS").split(), f"-Wl,-rpath,{cv('LIBDIR')}"]
    return flags


def embed_env() -> dict:
    """Environment for a C program that embeds this interpreter through
    the C ABI: its import path reaches this checkout and this
    interpreter's packages (torch), which an embedded interpreter started
    from its build prefix would not see in a venv."""
    paths = [str(REPO), *site.getsitepackages()]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    return {**os.environ, "PYTHONPATH": os.pathsep.join(paths)}


def target(name: str) -> Path:
    """Library path for csrc/<name>.cu at its current content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _digest(parts, flags) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else part.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _patch(text: str, patches, source: str) -> tuple[str, list[str]]:
    """`text` with `patches` applied, and what did not match: each
    (old, new, times) must find `old` exactly `times` times."""
    wrong = []
    for old, new, times in patches:
        if text.count(old) != times:
            wrong.append(f"{source} holds {old!r} {text.count(old)} times, "
                         f"not {times}: the port's copy cannot be made")
        text = text.replace(old, new)
    return text, wrong


def simplex_source() -> tuple[bytes, list[str]]:
    """cpp/dual_simplex/simplex.cpp with SIMPLEX_PATCHES applied, and the
    patches that did not match (raised after the compile, so that a
    source that does not compile reports the compiler's output)."""
    text, wrong = _patch((SIMPLEX_DIR / "simplex.cpp").read_text(),
                         SIMPLEX_PATCHES, "cpp/dual_simplex/simplex.cpp")
    return text.encode(), wrong


def simplex_target() -> Path:
    """Library path for the host simplex at its sources' current content
    and patches."""
    parts = [simplex_source()[0]] + [SIMPLEX_DIR / f
                                     for f in SIMPLEX_SOURCES[1:]]
    return BUILD_DIR / f"libsimplex-{_digest(parts, SIMPLEX_FLAGS)}.so"


def mps_target() -> Path:
    return BUILD_DIR / f"libmps-{_digest([MPS_SOURCE], HOST_FLAGS)}.so"


def capi_source(patches=CAPI_PATCHES) -> bytes:
    """cpp/c_api/cuopt_c.c with `patches` applied: the port's bridge in
    place of cuopt_tpu's, and the create calls' argument format
    repaired."""
    text, wrong = _patch((CAPI_DIR / "cuopt_c.c").read_text(), patches,
                         "cpp/c_api/cuopt_c.c")
    if wrong:
        raise RuntimeError("; ".join(wrong))
    return text.encode()


def capi_target() -> Path:
    digest = _digest([capi_source(), CAPI_HEADER], CAPI_FLAGS)
    return BUILD_DIR / f"libcuopt_torch_c-{digest}.so"


def check_target() -> Path:
    """Path of the standalone C caller, linked against the C ABI library
    at capi_target()."""
    digest = _digest([CHECK_SOURCE, CAPI_HEADER, str(capi_target()).encode()],
                     embed_ldflags())
    return BUILD_DIR / f"c_api_check-{digest}"


class Builder:
    """Compiles sources on demand and keeps the loaded libraries and the
    compilers' output (for nvcc, ptxas' registers, shared memory and
    spills per kernel)."""

    SIMPLEX = "simplex"
    MPS = "mps"
    CAPI = "cuopt_torch_c"
    CHECK = "c_api_check"

    def __init__(self):
        self.libs: dict[str, ctypes.CDLL] = {}
        self.log: dict[str, str] = {}
        self._locks: dict[str, threading.Lock] = {}

    def _compile(self, name: str, lib: Path, command: list[str],
                 source: Path, after=()) -> float | None:
        """Run `command -o <tmp> source *after` unless `lib` exists, then
        rename the output into place. Returns the compile's seconds, or
        None when the library was already built."""
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([*command, "-o", str(tmp), str(source), *after],
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
        """Write the port's copy of cpp/dual_simplex/simplex.cpp (with
        SIMPLEX_PATCHES) to _build/ and compile it unless its library
        exists, with the flags cuopt_tpu builds it under."""
        lib = simplex_target()
        if lib.exists():
            return None
        text, wrong = simplex_source()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        copy = lib.with_name(lib.name[3:].replace(".so", ".cpp"))
        tmp = copy.with_name(
            f"{copy.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(text)
        os.replace(tmp, copy)
        took = self._compile(self.SIMPLEX, lib,
                             [gxx(), *SIMPLEX_FLAGS], copy)
        if wrong:
            lib.unlink()
            raise RuntimeError("; ".join(wrong))
        return took

    def build_mps(self) -> float | None:
        """Compile cpp/mps_parser/mps_parser.cpp unless its library
        exists, with the flags cuopt_tpu builds it under."""
        return self._compile(self.MPS, mps_target(), [gxx(), *HOST_FLAGS],
                             MPS_SOURCE)

    def build_capi(self) -> float | None:
        """Write the port's copy of cpp/c_api/cuopt_c.c to _build/ and
        compile it unless its library exists."""
        lib = capi_target()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        copy = lib.with_name(lib.name[3:].replace(".so", ".c"))
        tmp = copy.with_name(
            f"{copy.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(capi_source())
        os.replace(tmp, copy)
        return self._compile(self.CAPI, lib, [gcc(), *CAPI_FLAGS], copy)

    def build_check(self) -> float | None:
        """Compile csrc/c_api_check.c, linked against the C ABI library
        and libpython, unless it exists."""
        self.build_capi()
        return self._compile(
            self.CHECK, check_target(),
            [gcc(), "-O2", "-I", str(CAPI_HEADER.parent)], CHECK_SOURCE,
            after=[str(capi_target()), *embed_ldflags()])

    def c_api_check(self) -> Path:
        """Path of the built standalone C caller; run it with
        embed_env()."""
        with self._locks.setdefault(self.CHECK, threading.Lock()):
            self.build_check()
        return check_target()

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

    def mps_library(self) -> ctypes.CDLL:
        return self._load(self.MPS, self.build_mps, mps_target)

    def capi_library(self) -> ctypes.CDLL:
        return self._load(self.CAPI, self.build_capi, capi_target)


BUILDER = Builder()
