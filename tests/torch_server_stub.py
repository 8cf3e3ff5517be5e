"""A stand-in solver worker for the JobQueue tests of
test_torch_server.py: it serves jobs as cuopt_torch's worker_main does,
but a payload {"crash": true} kills its process with SIGSEGV, as the
shared C++ crossover does (ROADMAP Queue 3), and any other payload is
answered {"echo": payload} at once."""

import os
import queue
import signal


def crashing_worker(worker_id, device, jobs, results, abort_list, current):
    parent = os.getppid()
    while True:
        try:
            req_id, kind, payload = jobs.get(timeout=0.5)
        except queue.Empty:
            if os.getppid() != parent:
                return
            continue
        current[worker_id] = req_id
        results.put({"type": "running", "req_id": req_id})
        if payload.get("crash"):
            os.kill(os.getpid(), signal.SIGSEGV)
        current.pop(worker_id, None)
        results.put({"type": "result", "req_id": req_id,
                     "result": {"echo": payload, "pid": os.getpid()}})
