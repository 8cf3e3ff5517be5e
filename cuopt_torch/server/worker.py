"""Solver worker process.

Counterpart of cuopt_tpu/server/worker.py, which mirrors reference
process_handler.py (create_process :83-104) + the per-job flow in
utils/solver.py (process_async_solve :332 with device health check :386
and incumbent streaming :337). Each worker solves on the device its
JobQueue gives it. It posts {"type": "ready"} once its start-up health
check has passed, which /v2/health/ready waits for; a failed check
posts nothing, and its error goes into each job's error and log.
"""

from __future__ import annotations

import os
import queue as queue_mod
import traceback


def device_health_check(device: str) -> None:
    """Reference cuda_health_check: the device still answers a small
    computation. Raises what the device raised."""
    import torch

    d = torch.device(device)
    out = torch.zeros(8, device=d) + 1
    if d.type == "cuda":
        torch.cuda.synchronize(d)
    if not bool((out == 1).all()):
        raise RuntimeError(f"device {device} computed a wrong sum")


def worker_main(worker_id, device, jobs, results, abort_list, current):
    """Serve jobs on `device` until the server goes. `current[worker_id]`
    holds the request being solved, for the JobQueue's watchdog."""
    parent = os.getppid()
    try:  # make the device's context at start, as the reference does
        device_health_check(device)
    except Exception:  # noqa: BLE001  (reported with the first job)
        pass
    else:
        results.put({"type": "ready", "worker": worker_id,
                     "pid": os.getpid()})
    while True:
        try:
            req_id, kind, payload = jobs.get(timeout=0.5)
        except queue_mod.Empty:
            if os.getppid() != parent:
                return  # the server is gone
            continue
        if isinstance(payload, tuple) and len(payload) == 3 and \
                payload[0] == "shm":
            # large payload stashed in shared memory (reference
            # job_queue.py:225-240): read + unlink
            import pickle
            from multiprocessing import shared_memory

            _, name, size = payload
            shm = shared_memory.SharedMemory(name=name)
            try:
                payload = pickle.loads(bytes(shm.buf[:size]))
            finally:
                shm.close()
                shm.unlink()
        if req_id in abort_list:
            continue
        current[worker_id] = req_id
        results.put({"type": "running", "req_id": req_id})
        try:
            try:
                device_health_check(device)
            except Exception as exc:  # noqa: BLE001
                raise RuntimeError(
                    f"device health check failed on {device}: "
                    f"{type(exc).__name__}: {exc}") from exc
            if kind == "lp":
                from cuopt_torch.server.solver import solve_lp_payload

                def incumbent_cb(solution, cost, _rid=req_id):
                    results.put({
                        "type": "incumbent", "req_id": _rid,
                        "incumbent": {"solution": solution, "cost": cost},
                    })

                result = solve_lp_payload(payload, incumbent_cb, device)
            elif kind == "routing":
                from cuopt_torch.server.solver import solve_routing_payload

                result = solve_routing_payload(payload, device)
            else:
                raise ValueError(f"unknown job kind {kind!r}")
            current.pop(worker_id, None)
            results.put({
                "type": "result", "req_id": req_id, "result": result,
            })
        except Exception as exc:  # noqa: BLE001  (the worker keeps serving)
            results.put({
                "type": "error", "req_id": req_id,
                "error": f"{type(exc).__name__}: {exc}",
            })
            results.put({
                "type": "log", "req_id": req_id,
                "line": traceback.format_exc(),
            })
            current.pop(worker_id, None)
