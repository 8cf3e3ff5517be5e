"""Thin client for the self-hosted solver service.

Counterpart of cuopt_tpu/clients/self_hosted.py, on the standard
library's urllib.request and the port's MessagePack encoder (the machine
with the card has neither of the HTTP or MessagePack packages cuopt_tpu
uses). Mirrors the reference `CuOptServiceSelfHostClient`
(python/cuopt_self_hosted/cuopt_sh_client/cuopt_self_host_client.py:244-912:
sync/async submit, poll with repoll, abort, incumbent fetch, msgpack/zlib
payloads) and `ThinClientSolverSettings`
(thin_client_solver_settings.py:22-80 — settings mirror without device
deps).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
import zlib

from cuopt_torch.utils.msgpack_codec import packb

# seconds one HTTP call may take; polling has its own deadline
HTTP_TIMEOUT = 60.0


class _Response:
    """Status, body and json() of one HTTP answer (what cuopt_tpu's
    client reads of its HTTP library's response)."""

    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)


def _call(method: str, url: str, data: bytes | None = None,
          headers: dict | None = None) -> _Response:
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return _Response(r.status, r.read())
    except urllib.error.HTTPError as exc:
        with exc:
            return _Response(exc.code, exc.read())


class ThinClientSolverSettings:
    """Settings mirror usable without the solver installed."""

    def __init__(self):
        self._params = {}

    def set_parameter(self, name, value):
        self._params[str(name)] = value

    def get_parameter(self, name):
        return self._params.get(str(name))

    def set_optimality_tolerance(self, eps):
        for k in (
            "absolute_dual_tolerance", "relative_dual_tolerance",
            "absolute_primal_tolerance", "relative_primal_tolerance",
            "absolute_gap_tolerance", "relative_gap_tolerance",
        ):
            self._params[k] = eps

    def to_solver_config(self):
        tol_keys = {
            "absolute_primal_tolerance": "absolute_primal",
            "absolute_dual_tolerance": "absolute_dual",
            "absolute_gap_tolerance": "absolute_gap",
            "relative_primal_tolerance": "relative_primal",
            "relative_dual_tolerance": "relative_dual",
            "relative_gap_tolerance": "relative_gap",
        }
        cfg: dict = {}
        tols = {}
        for k, v in self._params.items():
            if k in tol_keys:
                tols[tol_keys[k]] = v
            else:
                cfg[k] = v
        if tols:
            cfg["tolerances"] = tols
        return cfg


class CuOptServiceSelfHostClient:
    def __init__(
        self,
        ip: str = "0.0.0.0",
        port: int = 5000,
        use_https: bool = False,
        polling_interval: float = 1.0,
        request_excess_timeout: float = 600.0,
        timeout_exception: bool = True,
    ):
        scheme = "https" if use_https else "http"
        self.base = f"{scheme}://{ip}:{port}"
        self.polling_interval = polling_interval
        self.timeout = request_excess_timeout
        self.timeout_exception = timeout_exception

    # ------------------------------------------------------------- http
    def _post(self, path, payload, compress=False, use_msgpack=False):
        if use_msgpack:
            data = packb(payload)
            ctype = "application/vnd.msgpack"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        if compress:
            data = zlib.compress(data)
            ctype += "+zlib"
        return _call("POST", self.base + path, data,
                     {"Content-Type": ctype})

    def _poll(self, req_id):
        deadline = time.monotonic() + self.timeout
        while True:
            r = _call("GET", f"{self.base}/cuopt/solution/{req_id}")
            if r.status_code == 200:
                return r.json()
            if r.status_code not in (202,):
                raise RuntimeError(
                    f"solve failed: {r.status_code} {r.text}"
                )
            if time.monotonic() > deadline:
                if self.timeout_exception:
                    raise TimeoutError(
                        f"request {req_id} still running"
                    )
                return {"reqId": req_id}
            time.sleep(self.polling_interval)

    # ------------------------------------------------------------ solves
    def get_LP_solve(self, data, solver_config=None, response_type="dict",
                     compress=False, use_msgpack=False,
                     warmstart_id=None):
        """Submit an LP/MIP. warmstart_id: a prior request id whose PDLP
        state should seed this solve (reference thin client warm-start
        re-use, cuopt_self_host_client.py)."""
        payload = dict(data)
        if solver_config is not None:
            if isinstance(solver_config, ThinClientSolverSettings):
                payload["solver_config"] = solver_config.to_solver_config()
            else:
                payload["solver_config"] = solver_config
        if warmstart_id is not None:
            ws = self.get_warmstart(warmstart_id)
            if ws is not None:
                payload["warm_start_data"] = ws
        r = self._post("/cuopt/request", payload, compress, use_msgpack)
        if r.status_code != 200:
            raise RuntimeError(f"submit failed: {r.status_code} {r.text}")
        req_id = r.json()["reqId"]
        return self._poll(req_id)

    def get_optimized_routes(self, data, response_type="dict",
                             compress=False, use_msgpack=False):
        r = self._post("/cuopt/request", dict(data), compress, use_msgpack)
        if r.status_code != 200:
            raise RuntimeError(f"submit failed: {r.status_code} {r.text}")
        req_id = r.json()["reqId"]
        return self._poll(req_id)

    # --------------------------------------------------------- auxiliary
    def delete(self, req_id):
        r = _call("DELETE", f"{self.base}/cuopt/request/{req_id}")
        return r.json()

    def get_incumbents(self, req_id):
        r = _call("GET", f"{self.base}/cuopt/solution/{req_id}/incumbents")
        return r.json().get("incumbents", [])

    def get_warmstart(self, req_id):
        """Fetch a finished solve's PDLP warm-start data (reference
        GET /cuopt/solution/{id}/warmstart, webserver.py:835)."""
        r = _call("GET", f"{self.base}/cuopt/solution/{req_id}/warmstart")
        if r.status_code != 200:
            return None
        return r.json().get("warmstart")

    def get_log(self, req_id):
        r = _call("GET", f"{self.base}/cuopt/log/{req_id}")
        return r.json().get("log", [])

    def health(self):
        return _call("GET", f"{self.base}/cuopt/health").json()
