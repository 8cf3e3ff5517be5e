"""Multiprocessing job queue + result store.

Counterpart of cuopt_tpu/server/job_queue.py, which mirrors reference
python/cuopt_server/cuopt_server/job_queue.py (jobs/results/abort
multiprocessing queues, result cache, AbortList :299-337) and
process_handler.py (one solver Process per device, watch_solvers respawn
:107). The worker count comes from CUOPT_GPU_COUNT (reference
cuopt_service.py:134-141), default 1; worker i solves on cuda:i, or on the
CPU when CUOPT_TORCH_DEVICE says "cpu" (utils/device.py). A worker that
dies while it solves is respawned, and its request ends as an error.
The queue is ready once a live worker has passed its start-up health
check (`is_ready`); a respawned worker is not ready until it has passed
its own.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import threading
import uuid

from cuopt_torch.server.result_store import (
    BillingData,
    MemoryResultStore,
)
from cuopt_torch.utils.device import entry_device

# payloads above this stash in multiprocessing.shared_memory instead of
# riding the pickle through the job queue (reference webserver.py:9 +
# job_queue.py:225-240 SharedMemory path for large models)
SHM_THRESHOLD = int(os.environ.get("CUOPT_SHM_THRESHOLD", 1 << 19))


class JobQueue:
    def __init__(self, n_workers: int | None = None, worker=None):
        """worker: the function each solver process runs (worker_main; a
        test passes a stub)."""
        ctx = mp.get_context("spawn")
        self.ctx = ctx
        if n_workers is None:
            n_workers = int(os.environ.get("CUOPT_GPU_COUNT", "1"))
        self.n_workers = max(1, n_workers)
        base = entry_device()
        self.devices = [f"cuda:{i}" if base == "cuda" else "cpu"
                        for i in range(self.n_workers)]
        if worker is None:
            from cuopt_torch.server.worker import worker_main as worker
        self.worker = worker
        self.jobs = ctx.Queue()
        self.results = ctx.Queue()
        self.manager = ctx.Manager()
        self.abort_list = self.manager.list()
        self.store = MemoryResultStore()
        self.billing = BillingData()
        # worker -> the request it solves, set by the worker before it
        # starts (a synchronous call, unlike a queue message, which a
        # worker that dies at once may never send)
        self.current = self.manager.dict()
        self.incumbents: dict[str, list] = {}
        self.logs: dict[str, list] = {}
        # worker -> pid of the process that reported ready: a respawned
        # worker has another pid, so it is not ready until it reports
        self.ready_pids: dict[int, int] = {}
        self._lock = threading.Lock()  # incumbents and logs
        self.procs: list = []
        self._collector = None
        self._watchdog = None
        self._shutdown = threading.Event()

    # -------------------------------------------------------------- jobs
    def submit(self, kind: str, payload: dict) -> str:
        req_id = uuid.uuid4().hex
        self.store.put(req_id, {"status": "queued"})
        blob = pickle.dumps(payload)
        self.billing.start_event(req_id, kind, len(blob))
        if len(blob) >= SHM_THRESHOLD:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(create=True, size=len(blob))
            shm.buf[: len(blob)] = blob
            name, size = shm.name, len(blob)
            shm.close()
            self.jobs.put((req_id, kind, ("shm", name, size)))
        else:
            self.jobs.put((req_id, kind, payload))
        return req_id

    def abort(self, req_id: str) -> bool:
        entry = self.store.get(req_id)
        if entry is not None and entry.get("status") in (
            "queued", "running",
        ):
            self.abort_list.append(req_id)
            self.store.put(req_id, {"status": "aborted"})
            self.billing.end_event(req_id, "aborted")
            return True
        return False

    def get_result(self, req_id: str):
        return self.store.get(req_id)

    def get_incumbents(self, req_id: str):
        with self._lock:
            return list(self.incumbents.get(req_id, []))

    def get_log(self, req_id: str):
        with self._lock:
            return list(self.logs.get(req_id, []))

    def delete_log(self, req_id: str):
        with self._lock:
            self.logs.pop(req_id, None)

    # ----------------------------------------------------------- workers
    def _spawn(self, i: int):
        p = self.ctx.Process(
            target=self.worker,
            args=(i, self.devices[i], self.jobs, self.results,
                  self.abort_list, self.current),
            daemon=True,
        )
        p.start()
        return p

    def start(self):
        self.procs = [self._spawn(i) for i in range(self.n_workers)]
        self._collector = threading.Thread(
            target=self._collect, daemon=True
        )
        self._collector.start()
        self._watchdog = threading.Thread(
            target=self._watch_solvers, daemon=True
        )
        self._watchdog.start()

    def is_ready(self) -> bool:
        """True once a live worker process has passed its start-up
        health check."""
        return any(p.is_alive() and self.ready_pids.get(i) == p.pid
                   for i, p in enumerate(self.procs))

    def _collect(self):
        while not self._shutdown.is_set():
            try:
                msg = self.results.get(timeout=0.25)
            except queue_mod.Empty:
                continue
            if msg["type"] == "ready":  # a worker's, not a request's
                self.ready_pids[msg["worker"]] = msg["pid"]
                continue
            req_id = msg["req_id"]
            if msg["type"] == "result":
                if (self.store.get(req_id) or {}).get("status") != \
                        "aborted":
                    res = msg["result"]
                    ws = res.pop("warmstart", None) \
                        if isinstance(res, dict) else None
                    self.store.put(req_id, {
                        "status": "done", "result": res,
                        "warmstart": ws,
                    })
                    self.billing.end_event(req_id, "done")
            elif msg["type"] == "error":
                self.store.put(req_id, {
                    "status": "error", "error": msg["error"],
                })
                self.billing.end_event(req_id, "error")
            elif msg["type"] == "running":
                if (self.store.get(req_id) or {}).get("status") == \
                        "queued":
                    self.store.put(req_id, {"status": "running"})
            elif msg["type"] == "incumbent":
                with self._lock:
                    self.incumbents.setdefault(req_id, []).append(
                        msg["incumbent"]
                    )
            elif msg["type"] == "log":
                with self._lock:
                    self.logs.setdefault(req_id, []).append(msg["line"])

    def _watch_solvers(self):
        """Respawn dead solver processes (reference process_handler.py
        watch_solvers :107). The request a dead worker was solving ends
        as an error; cuopt_tpu leaves it running for ever."""
        while not self._shutdown.wait(1.0):
            for i, p in enumerate(self.procs):
                if p.is_alive():
                    continue
                req_id = self.current.pop(i, None)
                if (self.store.get(req_id) or {}).get("status") in (
                        "queued", "running"):
                    self.store.put(req_id, {
                        "status": "error",
                        "error": f"the solver process exited with code "
                                 f"{p.exitcode} while solving",
                    })
                    self.billing.end_event(req_id, "error")
                self.procs[i] = self._spawn(i)

    def shutdown(self):
        """Stop the threads and the workers, and wait for them."""
        self._shutdown.set()
        for t in (self._collector, self._watchdog):
            if t is not None:
                t.join(timeout=10)
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.join(timeout=10)
        self.manager.shutdown()
