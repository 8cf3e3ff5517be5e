"""Stand-in solver workers for the JobQueue tests of
test_torch_server.py. `crashing_worker` serves jobs as cuopt_torch's
worker_main does, reporting ready READY_DELAY seconds after it starts,
but a payload {"crash": true} kills its process with SIGSEGV, as the
shared C++ crossover does (ROADMAP Queue 3), and any other payload is
answered {"echo": payload} at once. `unhealthy_worker` is worker_main on
a device that fails its health check."""

import os
import queue
import signal
import time

READY_DELAY = 1.0


def crashing_worker(worker_id, device, jobs, results, abort_list, current):
    parent = os.getppid()
    time.sleep(READY_DELAY)
    results.put({"type": "ready", "worker": worker_id, "pid": os.getpid()})
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


def unhealthy_worker(worker_id, device, jobs, results, abort_list, current):
    from cuopt_torch.server.worker import worker_main

    worker_main(worker_id, "no-such-device", jobs, results, abort_list,
                current)
