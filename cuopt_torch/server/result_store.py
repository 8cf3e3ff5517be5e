"""Result store abstraction + billing accounting + client-version gate.

Reference server aux (SURVEY.md §2.8):
  - result_store.py / mock_store.py: the result cache behind an
    interface so tests can double it (mock_store.py:21);
  - billing_data.py: usage accounting events per solve;
  - job_queue.py:104: client-version compatibility check.
"""

from __future__ import annotations

import threading
import time


class ResultStore:
    """Interface for request-result storage."""

    def put(self, req_id: str, entry: dict) -> None:
        raise NotImplementedError

    def get(self, req_id: str):
        raise NotImplementedError

    def delete(self, req_id: str) -> None:
        raise NotImplementedError

    def ids(self):
        raise NotImplementedError


class MemoryResultStore(ResultStore):
    """In-process dict store (the reference's default cache)."""

    def __init__(self):
        self._d: dict[str, dict] = {}
        self._lock = threading.Lock()

    def put(self, req_id, entry):
        with self._lock:
            self._d[req_id] = entry

    def get(self, req_id):
        with self._lock:
            return self._d.get(req_id)

    def delete(self, req_id):
        with self._lock:
            self._d.pop(req_id, None)

    def ids(self):
        with self._lock:
            return list(self._d)


class MockStore(MemoryResultStore):
    """Test double recording every operation (reference
    utils/mock_store.py:21)."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple] = []

    def put(self, req_id, entry):
        self.ops.append(("put", req_id))
        super().put(req_id, entry)

    def get(self, req_id):
        self.ops.append(("get", req_id))
        return super().get(req_id)

    def delete(self, req_id):
        self.ops.append(("delete", req_id))
        super().delete(req_id)


class BillingData:
    """Usage accounting (reference billing_data.py): one event per solve
    with kind, problem size, wall time and final status."""

    def __init__(self):
        self._events: list[dict] = []
        self._lock = threading.Lock()

    def start_event(self, req_id: str, kind: str, size: int) -> None:
        with self._lock:
            self._events.append({
                "req_id": req_id, "kind": kind, "size": int(size),
                "start": time.time(), "end": None, "status": None,
            })

    def end_event(self, req_id: str, status: str) -> None:
        with self._lock:
            for ev in reversed(self._events):
                if ev["req_id"] == req_id and ev["end"] is None:
                    ev["end"] = time.time()
                    ev["status"] = status
                    return

    def events(self):
        with self._lock:
            return [dict(e) for e in self._events]

    def summary(self):
        evs = self.events()
        done = [e for e in evs if e["end"] is not None]
        return {
            "total_requests": len(evs),
            "completed": len(done),
            "billed_seconds": round(
                sum(e["end"] - e["start"] for e in done), 3
            ),
        }


# client-version compatibility (reference job_queue.py:104): same major
# version required; empty/None accepted for same-package clients
SERVER_VERSION = "25.10"


def check_client_version(version: str | None):
    """Returns (ok, message)."""
    if not version or version == "custom":
        return True, ""
    try:
        major = str(version).split(".", 1)[0]
    except Exception:  # noqa: BLE001
        return False, f"unparseable client version {version!r}"
    if major != SERVER_VERSION.split(".", 1)[0]:
        return False, (
            f"client version {version} is incompatible with server "
            f"{SERVER_VERSION}; please upgrade the client"
        )
    return True, ""
