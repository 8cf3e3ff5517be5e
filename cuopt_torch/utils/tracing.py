"""Tracing/profiling hooks — the NVTX-range analogue.

The reference scatters raft::common::nvtx::range through solver hot
paths (mip/solve.cu:60, pdlp.cu) and relies on Nsight for timelines.
Here:

  - trace_scope(name): a torch.profiler.record_function span (host and,
    under a CUDA profiler, the device work launched inside it) while a
    profiler is active, and one shared do-nothing context otherwise, so
    a span costs one flag check when nobody listens. Under Nsight, wrap
    the run in torch.autograd.profiler.emit_nvtx(): it turns the
    profiler on, so every span is then also an NVTX range.
  - The LP path's spans, by layer (lp/pdlp.py, sparse/ops.py):
      pdlp_run               PdlpSolver.run after its early stop return
      pdlp_build             build_device_problem, inside pdlp_run
      sparse_band_layout     build_block_band's layout on the build's
                             device: the window search, the transpose
                             and both slab sets (one per band try)
      sparse_layout_fold     inside sparse_band_layout, the adds of a
                             repeated (row, column)'s later entries; only
                             for a CSR that repeats one
      sparse_reorder         the bandwidth permutation and the permuted
                             CSR, when the unpermuted band fails
      device_upload          the build's host-to-device copies: the
                             vectors and offset, the CSR once per band
                             try, the permutations
      pdlp_scaling           compute_scaling
      pdlp_pdhg_steps        a major's PDHG steps
      pdlp_step_sync         a host wait inside a major's steps: a
                             round's read of the major's step count
      pdlp_graph_capture     the step driver's first slot and the
                             capture of its two graphs, once a solve on
                             a card
      pdlp_termination       a major's termination information
      pdlp_restart           a major's restart decision
      pdlp_major_readback    a major's one packed read of its scalars
      pdlp_answer            the solution vectors to the host, the
                             inverse permutation and the sign flip
  - The float64 LP path runs no fused row pass: each attempt's
    BlockBandOp.matvec and rmatvec (sparse/ops.py) are a window gather,
    a torch.bmm over the slabs and, where entries spill, a segment sum.
    On a card the attempts are CUDA-graph replays with no host code, so
    no span times the pair: the device trace does, by kernel name
    (cuBLAS's batched double gemv, `gemv2T_kernel_val<int, int,
    double, ...>`, carries the two products). The host's part of a
    float64 solve is its spans above: pdlp_pdhg_steps and
    pdlp_step_sync for the replays, pdlp_termination and pdlp_restart
    for each major's eager tail. The raw result counts the majors that
    restarted (`restarts`, read in pdlp_major_readback).
  - The batch LP's spans (lp/batch.py, `batch_solve` of same-shape
    members stacked on a leading axis). The batch runs no CUDA graph
    and no step kernel: each attempt pass is eager, the vmapped
    `_attempt` over the stacked operator, so the host launches every
    product and vector op of every pass.
      pdlp_batch_build       the members' build_device_problem (each
                             with its pdlp_scaling, device_upload and
                             sparse_band_layout spans), their initial
                             states, the ELL widths and the stack
      pdlp_batch_steps       a batched major's steps: its passes
      pdlp_batch_sync        a pass's one read, whether every member
                             has accepted its step
      pdlp_batch_tail        the vmapped major tail (its
                             pdlp_termination and pdlp_restart inside)
      pdlp_batch_readback    a major's one packed read of the members'
                             scalars and the answers of the members it
                             ends
    Every member's raw result counts the batch's passes, syncs and
    steps and times its build and major loop (`batch_*`).
  - CUOPT_PROFILE_DIR=<dir>: when set, the first solve starts a
    torch.profiler trace and atexit writes it as a Chrome trace into
    <dir>.

Debug asserts — the cuopt_assert / ASSERT_MODE analogue
(cpp/src/utilities/macros.cuh:17-31): debug_assert() checks a predicate
on the host when CUOPT_DEBUG_ASSERTS=1 (one device sync per check) and
is a no-op otherwise.
"""

from __future__ import annotations

import atexit
import contextlib
import os

import torch
from torch._C._autograd import _profiler_enabled

_profiler = None
# what trace_scope returns with no profiler active: stateless, so one
# instance serves every span and thread
_CLOSED = contextlib.nullcontext()


def asserts_enabled() -> bool:
    return os.environ.get("CUOPT_DEBUG_ASSERTS", "0") == "1"


def maybe_start_profile() -> None:
    """Idempotent: start a torch.profiler trace when CUOPT_PROFILE_DIR is
    set (called at the top of every solve entry)."""
    global _profiler
    d = os.environ.get("CUOPT_PROFILE_DIR")
    if not d or _profiler is not None:
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=acts)
    _profiler.start()
    atexit.register(_stop_profile, d)


def _stop_profile(d: str) -> None:
    global _profiler
    if _profiler is None:
        return
    try:
        _profiler.stop()
        os.makedirs(d, exist_ok=True)
        _profiler.export_chrome_trace(
            os.path.join(d, f"cuopt_torch_{os.getpid()}.json"))
    finally:
        _profiler = None


def trace_scope(name: str):
    """Named span on the profiler's timeline while a profiler is active
    (torch.profiler, or emit_nvtx for Nsight); otherwise a shared
    do-nothing context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _CLOSED


def debug_assert(pred, msg: str) -> None:
    """Invariant check, active only under CUOPT_DEBUG_ASSERTS=1
    (reference cuopt_assert, macros.cuh:17). `pred` is a scalar boolean
    tensor or Python bool; reading it syncs the device."""
    if asserts_enabled() and not bool(pred):
        raise AssertionError(f"cuopt_torch debug_assert failed: {msg}")
