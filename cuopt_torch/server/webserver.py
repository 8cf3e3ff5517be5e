"""HTTP solver service on the standard library's ThreadingHTTPServer.

Counterpart of cuopt_tpu/server/webserver.py (aiohttp), with the same
routes, bodies and status codes, mirroring the reference FastAPI server
(python/cuopt_server/cuopt_server/webserver.py):

  GET  /cuopt/health                      :152
  GET  /v2/health/ready, /v2/health/live  :158-164
  POST /cuopt/request                     :874  (async submit -> reqId)
  GET  /cuopt/solution/{id}               :805  (poll result)
  GET  /cuopt/solution/{id}/incumbents    :368
  GET  /cuopt/log/{id}                    :314
  DELETE /cuopt/log/{id}                  :422
  DELETE /cuopt/request/{id}              :594  (abort)
  DELETE /cuopt/solution/{id}             :635
  POST /cuopt/solution                    :467  (sync-style solve)

`/v2/health/ready` answers 503 until a worker has passed its start-up
health check (cuopt_tpu answers 200 at once); `/cuopt/health` and
`/v2/health/live` report liveness, 200 as in the reference.

Payloads: JSON, msgpack and zlib-compressed JSON or msgpack, chosen by
Content-Type or the zlib magic bytes; msgpack is read by the port's own
decoder (utils/msgpack_codec.py) and payloads are validated by
server/data_definition.py, since the machine with the card has neither
aiohttp, msgpack nor pydantic. Pickle is refused with 415, as cuopt_tpu
does (the reference needs a SafeUnpickler to restrict it,
job_queue.py:138-173).
"""

from __future__ import annotations

import json
import re
import signal
import time
import traceback
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from cuopt_torch.server.data_definition import (
    LPData,
    OptimizedRoutingData,
    PayloadError,
)
from cuopt_torch.server.job_queue import JobQueue
from cuopt_torch.server.result_store import check_client_version
from cuopt_torch.utils.msgpack_codec import unpackb

MAX_BODY = 1024 * 1024 * 1024  # cuopt_tpu's client_max_size


class HttpError(Exception):
    """An answer other than 200 with a text body (aiohttp's HTTPException
    in cuopt_tpu)."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


def content_type(header: str | None) -> str:
    """The media type of a Content-Type header, lower case and without
    parameters, as aiohttp's request.content_type gives it."""
    if not header:
        return "application/octet-stream"
    mime = header.split(";", 1)[0].strip().lower()
    return mime if "/" in mime else "text/plain"


def decode_body(raw: bytes, ctype: str):
    if "zlib" in ctype or raw[:2] == b"\x78\x9c":
        raw = zlib.decompress(raw)
    if "msgpack" in ctype:
        return unpackb(raw)
    if "pickle" in ctype:
        raise HttpError(415, "pickle payloads are not supported")
    return json.loads(raw)


def job_kind(payload) -> str:
    if "csr_constraint_matrix" in payload:
        return "lp"
    if "task_data" in payload or "fleet_data" in payload:
        return "routing"
    raise HttpError(422, "payload is neither an LP nor a routing problem")


def validate(payload: dict, kind: str) -> None:
    try:
        if kind == "lp":
            LPData(**payload)
        else:
            OptimizedRoutingData(**payload)
    except PayloadError as exc:
        raise HttpError(422, json.dumps({"error": str(exc)})) from None


class Routes:
    """The service's handlers over one JobQueue. Each returns
    (status, JSON body or None); `dispatch` finds the handler of a method
    and path."""

    def __init__(self, jq: JobQueue):
        self.jq = jq
        self.table = [
            ("GET", r"/cuopt/health", self.health),
            ("GET", r"/cuopt/billing", self.billing),
            ("GET", r"/v2/health/ready", self.ready),
            ("GET", r"/v2/health/live", self.empty),
            ("POST", r"/cuopt/request", self.submit),
            ("GET", r"/cuopt/solution/(?P<req_id>[^{}/]+)", self.poll),
            ("POST", r"/cuopt/solution", self.sync_solve),
            ("DELETE", r"/cuopt/request/(?P<req_id>[^{}/]+)", self.abort),
            ("DELETE", r"/cuopt/solution/(?P<req_id>[^{}/]+)",
             self.delete_solution),
            ("GET", r"/cuopt/solution/(?P<req_id>[^{}/]+)/incumbents",
             self.incumbents),
            ("GET", r"/cuopt/solution/(?P<req_id>[^{}/]+)/warmstart",
             self.warmstart),
            ("GET", r"/cuopt/log/(?P<req_id>[^{}/]+)", self.get_log),
            ("DELETE", r"/cuopt/log/(?P<req_id>[^{}/]+)", self.delete_log),
            # legacy managed-service endpoint (webserver.py:1224)
            ("POST", r"/cuopt/cuopt", self.sync_solve),
        ]

    def dispatch(self, method: str, path: str):
        """(handler, path arguments), or raises 404 / 405."""
        allowed = False
        for m, pattern, handler in self.table:
            match = re.fullmatch(pattern, path)
            if match:
                if m == method:
                    return handler, match.groupdict()
                allowed = True
        if allowed:
            raise HttpError(405, "405: Method Not Allowed")
        raise HttpError(404, "404: Not Found")

    # ------------------------------------------------------- handlers
    def health(self, request):
        return 200, {"status": "RUNNING", "version": "0.1.0"}

    def billing(self, request):
        return 200, self.jq.billing.summary()

    def empty(self, request):
        return 200, None

    def ready(self, request):
        """200 once a worker can solve: it has passed its start-up
        health check. cuopt_tpu answers 200 at once, and the first
        request waits out the worker's start."""
        if self.jq.is_ready():
            return 200, None
        return 503, {"error": "no solver worker is ready"}

    def _payload(self, request):
        payload = decode_body(request.body(), request.content_type)
        kind = job_kind(payload)
        validate(payload, kind)
        return kind, payload

    def submit(self, request):
        # client-version gate (reference job_queue.py:104)
        ok, msg = check_client_version(request.headers.get("CLIENT-VERSION"))
        if not ok:
            return 426, {"error": msg}
        kind, payload = self._payload(request)
        return 200, {"reqId": self.jq.submit(kind, payload)}

    def poll(self, request, req_id):
        res = self.jq.get_result(req_id)
        if res is None:
            return 404, {"error": f"unknown request {req_id}"}
        if res["status"] in ("queued", "running"):
            return 202, {"reqId": req_id}
        if res["status"] == "error":
            return 500, {"error": res["error"]}
        if res["status"] == "aborted":
            return 410, {"error": "request aborted"}
        return 200, {"response": {"solver_response": res["result"]}}

    def sync_solve(self, request):
        kind, payload = self._payload(request)
        req_id = self.jq.submit(kind, payload)
        while True:
            res = self.jq.get_result(req_id)
            if res and res["status"] in ("done", "error", "aborted"):
                break
            time.sleep(0.05)
        if res["status"] == "error":
            return 500, {"error": res["error"]}
        return 200, {"response": {"solver_response": res["result"]}}

    def abort(self, request, req_id):
        return 200, {"aborted": self.jq.abort(req_id)}

    def incumbents(self, request, req_id):
        return 200, {"incumbents": self.jq.get_incumbents(req_id)}

    def warmstart(self, request, req_id):
        # reference webserver.py:835 (PDLP warm-start retrieval)
        res = self.jq.store.get(req_id)
        if res is None:
            return 404, {"error": f"unknown request {req_id}"}
        if res.get("status") != "done":
            return 202, {"reqId": req_id}
        ws = res.get("warmstart")
        if ws is None:
            return 404, {"error": "no warm start data for this solve"}
        return 200, {"warmstart": ws}

    def get_log(self, request, req_id):
        return 200, {"log": self.jq.get_log(req_id)}

    def delete_log(self, request, req_id):
        self.jq.delete_log(req_id)
        return 204, None

    def delete_solution(self, request, req_id):
        # cuopt_tpu calls a pop() its store lacks and answers 500
        self.jq.store.delete(req_id)
        return 200, {"deleted": req_id}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    routes: Routes  # set on the subclass that serve() makes

    def log_message(self, format, *args):  # noqa: A002  (the base's name)
        pass  # no access log, as cuopt_tpu's run_app(print=None)

    @property
    def content_type(self) -> str:
        return content_type(self.headers.get("Content-Type"))

    def body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY:
            raise HttpError(413, "413: Request Entity Too Large")
        return self.rfile.read(n)

    def _send(self, status: int, body: bytes, ctype: str):
        self.send_response(status)
        if status != 204:
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if status != 204:
            self.wfile.write(body)

    def _serve(self):
        try:
            handler, args = self.routes.dispatch(
                self.command, urlsplit(self.path).path)
            status, payload = handler(self, **args)
            body = b"" if payload is None else json.dumps(payload).encode()
            self._send(status, body, "application/json; charset=utf-8")
        except HttpError as exc:
            self._send(exc.status, exc.text.encode(),
                       "text/plain; charset=utf-8")
        except Exception:  # noqa: BLE001  (the server keeps serving)
            traceback.print_exc()
            self._send(500, b"500 Internal Server Error",
                       "text/plain; charset=utf-8")

    do_GET = do_POST = do_DELETE = do_PUT = do_PATCH = _serve


def make_server(host: str, port: int, jq: JobQueue) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"routes": Routes(jq)})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def run(host="0.0.0.0", port=5000, n_workers=None):
    """Serve until SIGTERM or SIGINT, then stop the workers."""
    jq = JobQueue(n_workers)
    jq.start()
    server = make_server(host, port, jq)

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        jq.shutdown()
