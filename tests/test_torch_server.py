"""cuopt_torch's solver service against cuopt_tpu's.

- The payload solvers (server/solver.py) in process, in both packages, on
  the same LP, MIP (incumbents streamed) and routing payloads: the same
  keys, objectives within 1e-6, the same routes.
- The validator (server/data_definition.py, no pydantic) against
  cuopt_tpu's pydantic models: test_server.py:251-310's malformed
  payloads and a seeded corpus of mutations of valid payloads, accepted or
  rejected alike.
- The MessagePack codec (utils/msgpack_codec.py) against the msgpack
  package on seeded nested payloads.
- The port's server, started on a free port with one CPU worker: a table
  of requests and the status codes cuopt_tpu's webserver gives them, the
  request flows, the thin client and cuopt_sh.
- The job queue's watchdog with a stub worker that crashes, and the
  refusal to solve without a card.
- Readiness, a departure: /v2/health/ready answers 503 until a worker
  has passed its start-up health check (cuopt_tpu answers 200 at once).
Every wait has its own deadline.
"""

import copy
import json
import math
import os
import random
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import msgpack
import numpy as np
import pydantic
import pytest
import torch

import cuopt_tpu.server.data_definition as tpu_dd
from cuopt_tpu.server.solver import (
    solve_lp_payload as tpu_solve_lp,
    solve_routing_payload as tpu_solve_routing,
)
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.server import data_definition as port_dd
from cuopt_torch.server.job_queue import JobQueue
from cuopt_torch.server.solver import (
    solve_lp_payload as port_solve_lp,
    solve_routing_payload as port_solve_routing,
)
from cuopt_torch.utils.msgpack_codec import MsgpackError, packb, unpackb
from torch_mip_instances import twelve_binaries
from torch_surface_instances import (
    LP_PAYLOAD,
    MIP_PAYLOAD,
    ROUTING_PAYLOAD,
    lp_payload,
    staircase,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DEADLINE = 60.0


# ------------------------------------------------- payload solvers
def _same_shape(a, b, path="result"):
    """The same keys all the way down, and lists of the same lengths."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(a), sorted(b))
        for k in a:
            _same_shape(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9)


def _dual_simplex(payload):
    out = copy.deepcopy(payload)
    out.setdefault("solver_config", {})["method"] = 2
    return out


LP_CASES = {
    "two-rows": _dual_simplex(LP_PAYLOAD),
    "staircase-200": lp_payload(staircase(generate_lp), method=2),
}


@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_lp_payload_equals_cuopt_tpu(case):
    payload = LP_CASES[case]
    port = port_solve_lp(copy.deepcopy(payload), device="cpu")
    tpu = tpu_solve_lp(copy.deepcopy(payload))
    _same_shape(port, tpu)
    assert port["status"] == tpu["status"] == 1
    ps, ts = port["solution"], tpu["solution"]
    assert ps["termination_reason"] == ts["termination_reason"] == "Optimal"
    for key in ("primal_objective", "dual_objective"):
        assert _close(ps[key], ts[key]), key
    np.testing.assert_allclose(ps["primal_solution"], ts["primal_solution"],
                               rtol=1e-6, atol=1e-9)
    assert ps["vars"].keys() == ts["vars"].keys()


@pytest.mark.parametrize("case", ["two-integers", "twelve-binaries"])
def test_mip_payload_streams_incumbents(case):
    payload = MIP_PAYLOAD if case == "two-integers" else lp_payload(
        twelve_binaries(OptimizationProblem), time_limit=30)
    streamed = {"port": [], "tpu": []}
    port = port_solve_lp(copy.deepcopy(payload),
                         lambda x, c: streamed["port"].append(c),
                         device="cpu")
    tpu = tpu_solve_lp(copy.deepcopy(payload),
                       lambda x, c: streamed["tpu"].append(c))
    _same_shape(port, tpu)
    want = -7.0 if case == "two-integers" else -82.0
    assert port["solution"]["primal_objective"] == \
        tpu["solution"]["primal_objective"] == want
    assert "milp_statistics" in port["solution"]
    assert streamed["port"] and streamed["tpu"]
    assert min(streamed["port"]) == min(streamed["tpu"]) == want


def test_routing_payload_equals_cuopt_tpu():
    """A brute-forceable instance (test_server.py's): the same cost,
    vehicles and routes, each truck's first and last rows the depot."""
    port = port_solve_routing(copy.deepcopy(ROUTING_PAYLOAD), device="cpu")
    tpu = tpu_solve_routing(copy.deepcopy(ROUTING_PAYLOAD))
    _same_shape(port, tpu)
    for key in ("status", "num_vehicles", "vehicle_data", "dropped_tasks"):
        assert port[key] == tpu[key], key
    assert _close(port["solution_cost"], tpu["solution_cost"])
    for truck in port["vehicle_data"].values():
        assert truck["type"][0] == truck["type"][-1] == "Depot"


def test_routing_payload_task_and_vehicle_ids():
    payload = copy.deepcopy(ROUTING_PAYLOAD)
    payload["task_data"]["task_ids"] = ["a", "b", "c"]
    payload["fleet_data"]["vehicle_ids"] = ["van", "truck"]
    port = port_solve_routing(copy.deepcopy(payload), device="cpu")
    tpu = tpu_solve_routing(payload)
    assert port["vehicle_data"] == tpu["vehicle_data"]
    served = [t for v in port["vehicle_data"].values() for t in v["task_id"]
              if t != "Depot"]
    assert sorted(served) == ["a", "b", "c"]


# ---------------------------------------------------------- validator
def _verdict(package, model, payload):
    cls = getattr(package, model)
    try:
        cls(**copy.deepcopy(payload))
        return True
    except (pydantic.ValidationError, port_dd.PayloadError):
        return False


# test_server.py:251-310
MALFORMED = [
    ("LPData", {"csr_constraint_matrix": {
        "offsets": [0, 2, 1], "indices": [0, 1], "values": [1, 1]}}),
    ("LPData", {"csr_constraint_matrix": {
        "offsets": [0, 3], "indices": [0, 1], "values": [1, 1]}}),
    ("LPData", {"csr_constraint_matrix": {
        "offsets": [0, 1], "indices": [5], "values": [1.0]},
        "objective_data": {"coefficients": [1.0, 2.0]}}),
    ("LPData", {"csr_constraint_matrix": {
        "offsets": [0, 1], "indices": [0], "values": [1.0]},
        "objective_data": {"coefficients": [1.0]},
        "constraint_bounds": {"bounds": [1.0], "types": ["X"]}}),
    ("LPData", {"not_a_field": 1}),
    ("FleetData", {"vehicle_locations": [[0, 0]],
                   "vehicle_time_windows": [[10, 5]]}),
    ("FleetData", {"vehicle_locations": [[0, 0], [0, 0]],
                   "capacities": [[5]]}),
    ("TaskData", {"task_locations": [1, 2],
                  "pickup_and_delivery_pairs": [[0, 7]]}),
    ("VehicleBreak", {"vehicle_id": 0, "earliest": 10, "latest": 5,
                      "duration": 1}),
]


@pytest.mark.parametrize("model,payload", MALFORMED)
def test_malformed_payloads_rejected_alike(model, payload):
    assert _verdict(tpu_dd, model, payload) is False
    assert _verdict(port_dd, model, payload) is False


RICH_ROUTING = {
    "cost_matrix_data": {"data": {"0": [[0, 1, 2], [1, 0, 3], [2, 3, 0]],
                                  "1": [[0, 2, 2], [2, 0, 1], [2, 1, 0]]}},
    "travel_time_matrix_data": {"data": {"0": [[0, 1, 2], [1, 0, 3],
                                               [2, 3, 0]]}},
    "fleet_data": {
        "vehicle_locations": [[0, 0], [0, 1]],
        "vehicle_ids": ["v0", "v1"],
        "capacities": [[5, 6]],
        "vehicle_time_windows": [[0, 100], [0, 90]],
        "vehicle_breaks": [{"vehicle_id": 1, "earliest": 10, "latest": 20,
                            "duration": 2, "locations": [0]}],
        "vehicle_types": [0, 1],
        "skip_first_trips": [False, True],
        "drop_return_trips": [False, False],
        "min_vehicles": 1,
        "vehicle_max_costs": [50.0, 60.0],
        "vehicle_max_times": [80.0, 70.0],
        "vehicle_fixed_costs": [1.0, 2.0],
    },
    "task_data": {
        "task_locations": [1, 2, 1],
        "task_ids": ["a", "b", "c"],
        "demand": [[1, 2, 1]],
        "pickup_and_delivery_pairs": [[0, 1]],
        "task_time_windows": [[0, 50], [5, 60], [0, 80]],
        "service_times": [1, 2, 0],
        "prizes": [1.0, 2.0, 0.5],
    },
    "solver_config": {"time_limit": 2, "objectives": {"cost": 1,
                                                      "travel_time": 0.5},
                      "verbose_mode": False},
}

RICH_LP = {
    "csr_constraint_matrix": {"offsets": [0, 2, 3], "indices": [0, 1, 1],
                              "values": [1.0, 2.0, 3.0]},
    "objective_data": {"coefficients": [1.0, -1.0], "offset": 0.5,
                       "scalability_factor": 2.0},
    "constraint_bounds": {"bounds": [4.0, 5.0], "types": ["L", "G"]},
    "variable_bounds": {"lower_bounds": [0, "ninf"],
                        "upper_bounds": ["inf", 10]},
    "initial_solution": {"primal": [0.0, 1.0], "dual": [0.0, 0.0]},
    "maximize": False,
    "variable_types": ["C", "I"],
    "variable_names": ["x", "y"],
    "solver_config": {
        "tolerances": {"optimality": 1e-4, "absolute_primal": 1e-5,
                       "mip_relative_gap": 1e-3},
        "infeasibility_detection": True, "time_limit": 10,
        "iteration_limit": 1000, "method": 1, "crossover": False,
        "solution_file": "x.sol"},
    "warm_start_data": {"anything": [1, 2]},
}

BASES = [("LPData", LP_PAYLOAD), ("LPData", MIP_PAYLOAD),
         ("LPData", RICH_LP), ("OptimizedRoutingData", ROUTING_PAYLOAD),
         ("OptimizedRoutingData", RICH_ROUTING),
         ("FleetData", RICH_ROUTING["fleet_data"]),
         ("TaskData", RICH_ROUTING["task_data"])]

# values a mutation puts in place of another: numbers as text, the
# bounds' sentinels, wrong kinds, edges of the lax conversions
POOL = [None, True, False, 0, 1, -1, 2, 2.0, 2.5, -0.0, 1e20, 10 ** 20,
        math.inf, -math.inf, math.nan, "3", " 3 ", "3.0", "3.5", "1e3",
        "inf", "ninf", "-inf", "nan", "true", "yes", "off", "abc", "",
        "L", "I", "C", "X", b"3", b"yes", [], [1], [1, 2], [[0, 0]],
        ["1", "2"], [1.5], [True], {}, {"a": 1}, {"0": [[1.0]]}]


def _paths(obj, prefix=()):
    yield prefix
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(obj, list):
        for k, v in enumerate(obj):
            yield from _paths(v, prefix + (k,))


def _mutate(payload, rng):
    out = copy.deepcopy(payload)
    paths = [p for p in _paths(out) if p]
    path = rng.choice(paths)
    parent = out
    for k in path[:-1]:
        parent = parent[k]
    key = path[-1]
    kind = rng.randrange(5)
    if kind == 0 and isinstance(parent, dict):
        del parent[key]  # missing key
    elif kind == 1 and isinstance(parent, dict):
        parent[f"extra_{rng.randrange(3)}"] = rng.choice(POOL)
    elif kind == 2 and isinstance(parent[key], list) and parent[key]:
        if rng.random() < 0.5:
            parent[key].pop()  # wrong length
        else:
            parent[key].append(copy.deepcopy(parent[key][-1]))
    elif kind == 3 and isinstance(parent[key], (int, float)) and \
            not isinstance(parent[key], bool):
        parent[key] = str(parent[key])  # a number as text
    else:
        parent[key] = copy.deepcopy(rng.choice(POOL))
    return out


def _corpus(seed, n=60):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        model, base = rng.choice(BASES)
        payload = base
        for _ in range(rng.choice((1, 1, 2))):
            payload = _mutate(payload, rng)
        out.append((model, payload))
    return out


def test_bases_accepted_alike():
    for model, payload in BASES:
        assert _verdict(tpu_dd, model, payload) is True, model
        assert _verdict(port_dd, model, payload) is True, model


@pytest.mark.parametrize("seed", range(12))
def test_mutation_corpus_accepted_alike(seed):
    corpus = _corpus(seed)
    verdicts = [(_verdict(tpu_dd, m, p), _verdict(port_dd, m, p))
                for m, p in corpus]
    wrong = [(m, p, v) for (m, p), v in zip(corpus, verdicts)
             if v[0] != v[1]]
    assert not wrong, wrong[:3]
    # the corpus holds both verdicts
    assert {v[0] for v in verdicts} == {True, False}


def test_converted_values_match_pydantic():
    payload = copy.deepcopy(RICH_LP)
    payload["csr_constraint_matrix"]["indices"] = ["0", 1.0, " 1 "]
    payload["solver_config"]["infeasibility_detection"] = "yes"
    payload["solver_config"]["iteration_limit"] = "1_000"
    port, tpu = port_dd.LPData(**payload), tpu_dd.LPData(**payload)
    assert port.csr_constraint_matrix.indices == \
        tpu.csr_constraint_matrix.indices == [0, 1, 1]
    assert port.solver_config.infeasibility_detection is True
    assert port.solver_config.iteration_limit == \
        tpu.solver_config.iteration_limit == 1000
    assert port.variable_bounds.lower_bounds == [0, "ninf"]


# ------------------------------------------------------------ msgpack
def _nested(rng, depth=0):
    kind = rng.randrange(9 if depth < 4 else 6)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind == 1:
        return rng.choice([0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                           2 ** 64 - 1, -1, -32, -33, -128, -129, -32769,
                           -2 ** 31 - 1, -2 ** 63,
                           rng.randrange(-10 ** 9, 10 ** 9)])
    if kind == 2:
        return rng.choice([0.0, -1.5, 1e300, math.inf, rng.random()])
    if kind == 3:
        return "".join(rng.choice("ab€😀")
                       for _ in range(rng.choice([0, 5, 31, 32, 300])))
    if kind == 4:
        return rng.randbytes(rng.choice([0, 3, 256, 70000]))
    if kind == 5:
        return [rng.random() for _ in range(rng.choice([0, 15, 16, 5000]))]
    if kind in (6, 7):
        return [_nested(rng, depth + 1) for _ in range(rng.choice([0, 3, 16]))]
    return {f"k{i}": _nested(rng, depth + 1)
            for i in range(rng.choice([0, 3, 15, 16, 17]))}


@pytest.mark.parametrize("seed", range(6))
def test_msgpack_codec_equals_msgpack(seed):
    rng = random.Random(seed)
    for _ in range(40):
        obj = {"csr_constraint_matrix": _nested(rng), "x": _nested(rng)}
        data = msgpack.packb(obj)
        assert unpackb(data) == msgpack.unpackb(data, raw=False)
        assert packb(obj) == data


@pytest.mark.parametrize("data", [
    msgpack.packb({1: 2}),                       # map key not str
    msgpack.packb([1, 2])[:-1],                  # truncated
    msgpack.packb(1) + b"\x00",                  # trailing bytes
    b"\xc1",                                     # never used
    b"\xa2\xff\xfe",                             # str not UTF-8
])
def test_msgpack_codec_refuses_what_msgpack_refuses(data):
    with pytest.raises(MsgpackError):
        unpackb(data)
    with pytest.raises(ValueError):
        msgpack.unpackb(data, raw=False)


# ------------------------------------------------------------- server
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUOPT_TORCH_DEVICE": "cpu", **extra}
    return env


def http(base, method, path, body=None, ctype="application/json",
         headers=None):
    """(status, body bytes) of one request, with its own deadline."""
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=body, method=method,
        headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read()


def poll(base, req_id, deadline=DEADLINE):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        status, body = http(base, "GET", f"/cuopt/solution/{req_id}")
        if status != 202:
            return status, json.loads(body)
        time.sleep(0.1)
    pytest.fail(f"request {req_id} still running after {deadline} s")


@pytest.fixture(scope="module")
def server():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuopt_torch.server", "-p", str(port),
         "-i", "127.0.0.1", "-d", "1"], cwd=ROOT, env=_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    end = time.monotonic() + DEADLINE
    while True:
        try:
            if http(base, "GET", "/cuopt/health")[0] == 200:
                break
        except (urllib.error.URLError, ConnectionError):
            pass
        if time.monotonic() > end or proc.poll() is not None:
            proc.kill()
            pytest.fail("the server did not start")
        time.sleep(0.2)
    yield base
    proc.terminate()
    try:
        proc.wait(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=DEADLINE)
        pytest.fail("the server did not stop on SIGTERM")


def _submit(base, payload, ctype="application/json"):
    status, body = http(base, "POST", "/cuopt/request", payload, ctype)
    assert status == 200, body
    return json.loads(body)["reqId"]


# (name, method, path, body, content type, headers, status): the status
# cuopt_tpu's webserver (cuopt_tpu/server/webserver.py) answers, by line
REQUESTS = [
    ("health", "GET", "/cuopt/health", None, None, {}, 200),      # :87
    ("live", "GET", "/v2/health/live", None, None, {}, 200),      # :93
    ("billing", "GET", "/cuopt/billing", None, None, {}, 200),    # :84
    ("submit-lp", "POST", "/cuopt/request", LP_PAYLOAD,
     "application/json", {}, 200),                                # :110
    ("submit-routing", "POST", "/cuopt/request", ROUTING_PAYLOAD,
     "application/json", {}, 200),                                # :110
    ("old-client", "POST", "/cuopt/request", LP_PAYLOAD,
     "application/json", {"CLIENT-VERSION": "99.99"}, 426),       # :104
    ("same-major-client", "POST", "/cuopt/request", LP_PAYLOAD,
     "application/json", {"CLIENT-VERSION": "25.02"}, 200),       # :110
    ("pickle", "POST", "/cuopt/request", b"x", "application/pickle",
     {}, 415),                                                    # :45
    ("neither-lp-nor-routing", "POST", "/cuopt/request", {"foo": 1},
     "application/json", {}, 422),                                # :56
    ("extra-key", "POST", "/cuopt/request",
     {**LP_PAYLOAD, "bogus": 1}, "application/json", {}, 422),    # :73
    ("bad-csr", "POST", "/cuopt/request",
     {"csr_constraint_matrix": {"bogus": 1}}, "application/json", {},
     422),                                                        # :73
    ("bad-fleet", "POST", "/cuopt/request",
     {**ROUTING_PAYLOAD, "fleet_data": {"vehicle_locations": []}},
     "application/json", {}, 422),                                # :73
    ("invalid-json", "POST", "/cuopt/request", b"{nope",
     "application/json", {}, 500),                # json.loads raises, :49
    ("msgpack-zlib", "POST", "/cuopt/request",
     zlib.compress(msgpack.packb(LP_PAYLOAD)),
     "application/vnd.msgpack+zlib", {}, 200),                    # :110
    ("zlib-magic-json", "POST", "/cuopt/request",
     zlib.compress(json.dumps(LP_PAYLOAD).encode()),
     "application/json", {}, 200),                                # :40
    ("msgpack-int-key", "POST", "/cuopt/request",
     msgpack.packb({1: 2}), "application/msgpack", {},
     500),                                        # unpackb raises, :43
    ("unknown-solution", "GET", "/cuopt/solution/nope", None, None, {},
     404),                                                        # :116
    ("unknown-warmstart", "GET", "/cuopt/solution/nope/warmstart", None,
     None, {}, 404),                                              # :164
    ("unknown-incumbents", "GET", "/cuopt/solution/nope/incumbents", None,
     None, {}, 200),                                              # :155
    ("log", "GET", "/cuopt/log/nope", None, None, {}, 200),       # :179
    ("delete-log", "DELETE", "/cuopt/log/nope", None, None, {}, 204),  # :183
    ("abort-unknown", "DELETE", "/cuopt/request/nope", None, None, {},
     200),                                                        # :151
    ("no-such-route", "GET", "/cuopt/nothing", None, None, {}, 404),
    ("wrong-method", "DELETE", "/cuopt/health", None, None, {}, 405),
    ("sync-solve", "POST", "/cuopt/solution", LP_PAYLOAD,
     "application/json", {}, 200),                                # :145
    ("legacy-sync-solve", "POST", "/cuopt/cuopt", LP_PAYLOAD,
     "application/json", {}, 200),                                # :145
]


@pytest.mark.parametrize("name,method,path,body,ctype,headers,want",
                         REQUESTS, ids=[r[0] for r in REQUESTS])
def test_status_codes_equal_cuopt_tpu(server, name, method, path, body,
                                      ctype, headers, want):
    status, _ = http(server, method, path, body,
                     ctype or "application/json", headers)
    assert status == want


def test_ready_on_the_server(server):
    """The "ready" row of cuopt_tpu's table (webserver.py:90 answers 200
    at once) is a departure: the port's ready waits for the CPU worker's
    health check, then answers 200; live and health answer 200 all along
    (test_ready_waits_for_a_worker sees the 503)."""
    assert http(server, "GET", "/v2/health/live")[0] == 200
    end = time.monotonic() + DEADLINE
    while http(server, "GET", "/v2/health/ready")[0] != 200:
        assert http(server, "GET", "/cuopt/health")[0] == 200
        assert time.monotonic() < end, "the worker never became ready"
        time.sleep(0.1)


def test_delete_solution(server):
    """DELETE /cuopt/solution/{id} forgets the result. cuopt_tpu answers
    500 here (webserver.py:187 calls a pop() its store lacks); the port
    deletes and answers 200."""
    req_id = _submit(server, _dual_simplex(LP_PAYLOAD))
    assert poll(server, req_id)[0] == 200
    status, body = http(server, "DELETE", f"/cuopt/solution/{req_id}")
    assert status == 200 and json.loads(body) == {"deleted": req_id}
    assert http(server, "GET", f"/cuopt/solution/{req_id}")[0] == 404


def test_lp_and_routing_round_trips(server):
    lp = _submit(server, lp_payload(staircase(generate_lp), method=2))
    routing = _submit(server, ROUTING_PAYLOAD)
    status, res = poll(server, lp)
    assert status == 200
    sol = res["response"]["solver_response"]["solution"]
    want = port_solve_lp(lp_payload(staircase(generate_lp), method=2),
                         device="cpu")["solution"]["primal_objective"]
    assert sol["termination_reason"] == "Optimal"
    assert _close(sol["primal_objective"], want)
    status, res = poll(server, routing)
    assert status == 200
    out = res["response"]["solver_response"]
    assert out["status"] == 0 and out["solution_cost"] == 8.0


def test_msgpack_request_answers_as_json(server):
    a = _submit(server, zlib.compress(packb(_dual_simplex(LP_PAYLOAD))),
                "application/vnd.msgpack+zlib")
    b = _submit(server, _dual_simplex(LP_PAYLOAD))
    sa, sb = poll(server, a)[1], poll(server, b)[1]
    key = ("response", "solver_response", "solution", "primal_objective")
    va, vb = sa, sb
    for k in key:
        va, vb = va[k], vb[k]
    assert va == vb


def test_abort_gives_410(server):
    payload = copy.deepcopy(ROUTING_PAYLOAD)
    payload["solver_config"]["time_limit"] = 5
    req_id = _submit(server, payload)
    status, body = http(server, "DELETE", f"/cuopt/request/{req_id}")
    assert status == 200 and json.loads(body) == {"aborted": True}
    assert poll(server, req_id)[0] == 410


def test_mip_incumbents_streamed(server):
    req_id = _submit(server, MIP_PAYLOAD)
    status, res = poll(server, req_id)
    assert status == 200
    assert res["response"]["solver_response"]["solution"][
        "primal_objective"] == -7.0
    status, body = http(server, "GET",
                        f"/cuopt/solution/{req_id}/incumbents")
    inc = json.loads(body)["incumbents"]
    assert status == 200 and len(inc) >= 1
    assert "solution" in inc[0] and "cost" in inc[0]


def test_warmstart_endpoint(server):
    req_id = _submit(server, LP_PAYLOAD)  # PDLP: has warm start data
    assert poll(server, req_id)[0] == 200
    status, body = http(server, "GET",
                        f"/cuopt/solution/{req_id}/warmstart")
    assert status == 200
    ws = json.loads(body)["warmstart"]
    assert "current_primal_solution" in ws
    again = _submit(server, {**LP_PAYLOAD, "warm_start_data": ws})
    assert poll(server, again)[0] == 200


def test_large_payload_through_shared_memory(server):
    """~1 MB of JSON crosses SHM_THRESHOLD (512 KiB) and rides shared
    memory to the worker."""
    n = 80_000
    big = {
        "csr_constraint_matrix": {"offsets": [0] + [1] * n,
                                  "indices": [0], "values": [1.0]},
        "objective_data": {"coefficients": [1.0]},
        "constraint_bounds": {"bounds": [1.0] * n, "types": ["L"] * n},
        "variable_bounds": {"lower_bounds": [0.0], "upper_bounds": [10.0]},
        "solver_config": {"method": 2},
    }
    assert len(json.dumps(big)) > 1 << 19
    status, res = poll(server, _submit(server, big))
    assert status == 200, res
    assert res["response"]["solver_response"]["solution"][
        "primal_objective"] == 0.0
    status, body = http(server, "GET", "/cuopt/billing")
    summary = json.loads(body)
    assert summary["total_requests"] >= 1 and summary["completed"] >= 1


def test_thin_client(server):
    from cuopt_torch.clients import (
        CuOptServiceSelfHostClient,
        ThinClientSolverSettings,
    )

    host, port = server.replace("http://", "").split(":")
    c = CuOptServiceSelfHostClient(ip=host, port=int(port),
                                   polling_interval=0.1,
                                   request_excess_timeout=DEADLINE)
    assert c.health()["status"] == "RUNNING"
    s = ThinClientSolverSettings()
    s.set_parameter("method", 2)
    s.set_optimality_tolerance(1e-6)
    res = c.get_LP_solve(LP_PAYLOAD, s)
    sol = res["response"]["solver_response"]["solution"]
    assert sol["termination_reason"] == "Optimal"
    assert _close(sol["primal_objective"], -0.36)
    res = c.get_LP_solve(LP_PAYLOAD, compress=True, use_msgpack=True)
    assert res["response"]["solver_response"]["status"] == 1
    routes = c.get_optimized_routes(ROUTING_PAYLOAD)
    assert routes["response"]["solver_response"]["solution_cost"] == 8.0
    assert c.delete("nope") == {"aborted": False}
    assert c.get_incumbents("nope") == []
    assert c.get_warmstart("nope") is None
    assert c.get_log("nope") == []


def test_cuopt_sh(server, tmp_path):
    host, port = server.replace("http://", "").split(":")
    data = tmp_path / "lp.json"
    data.write_text(json.dumps(_dual_simplex(LP_PAYLOAD)))
    args = [sys.executable, "-m", "cuopt_torch.clients.cuopt_sh",
            "-i", host, "-p", port, "--poll-interval", "0.1"]
    r = subprocess.run([*args, str(data)], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=DEADLINE)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    assert out["response"]["solver_response"]["solution"][
        "termination_reason"] == "Optimal"
    r = subprocess.run([*args, "--health"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=DEADLINE)
    assert json.loads(r.stdout)["status"] == "RUNNING"
    r = subprocess.run([*args, str(tmp_path / "missing.json")], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=DEADLINE)
    assert r.returncode == 2


# --------------------------------------------------------- job queue
def _wait_status(jq, req_id, statuses):
    end = time.monotonic() + DEADLINE
    while time.monotonic() < end:
        res = jq.get_result(req_id)
        if res and res["status"] in statuses:
            return res
        time.sleep(0.05)
    pytest.fail(f"{req_id} never reached {statuses}")


def test_worker_crash_is_an_error_and_the_worker_respawns(monkeypatch):
    """A solve that kills its worker (as the shared C++ crossover's
    segfault does, ROADMAP Queue 3): the watchdog respawns the worker,
    the request ends as an error naming the exit (cuopt_tpu's stays
    running, 202, for ever), and the next request is served."""
    from torch_server_stub import crashing_worker

    monkeypatch.setenv("CUOPT_TORCH_DEVICE", "cpu")
    jq = JobQueue(1, worker=crashing_worker)
    jq.start()
    try:
        first = jq.procs[0].pid
        crash = jq.submit("lp", {"crash": True})
        res = _wait_status(jq, crash, ("error", "done"))
        assert res["status"] == "error"
        assert "exited with code -11" in res["error"]
        ok = jq.submit("lp", {"n": 1})
        res = _wait_status(jq, ok, ("error", "done"))
        assert res["status"] == "done"
        assert res["result"]["echo"] == {"n": 1}
        assert res["result"]["pid"] != first
    finally:
        jq.shutdown()
    assert not any(p.is_alive() for p in jq.procs)


def _get(routes, path):
    """The status the webserver's handler answers a GET of `path` with."""
    handler, args = routes.dispatch("GET", path)
    return handler(None, **args)[0]


def _ready(routes):
    return _get(routes, "/v2/health/ready")


def _live(routes):
    return [_get(routes, p) for p in ("/v2/health/live", "/cuopt/health")]


def test_ready_waits_for_a_worker(monkeypatch):
    """The stub worker reports ready a second after it starts: ready
    answers 503 before the queue starts and right after, 200 once the
    worker has reported, 503 again while the watchdog's respawn of a
    crashed worker starts, then 200. Live and health answer 200
    throughout."""
    from cuopt_torch.server.webserver import Routes
    from torch_server_stub import crashing_worker

    monkeypatch.setenv("CUOPT_TORCH_DEVICE", "cpu")
    jq = JobQueue(1, worker=crashing_worker)
    routes = Routes(jq)
    try:
        assert _ready(routes) == 503 and _live(routes) == [200, 200]
        jq.start()
        assert _ready(routes) == 503 and _live(routes) == [200, 200]

        def wait_ready():
            end = time.monotonic() + DEADLINE
            while _ready(routes) != 200:
                assert time.monotonic() < end, "no worker became ready"
                time.sleep(0.05)

        wait_ready()
        crash = jq.submit("lp", {"crash": True})
        assert _wait_status(jq, crash, ("error", "done"))["status"] == \
            "error"
        assert _ready(routes) == 503 and _live(routes) == [200, 200]
        wait_ready()
        ok = jq.submit("lp", {"n": 1})
        assert _wait_status(jq, ok, ("error", "done"))["status"] == "done"
    finally:
        jq.shutdown()


def test_ready_never_after_a_failed_health_check(monkeypatch):
    """worker_main on a device whose health check fails posts no ready:
    ready stays 503 with the worker alive, and the check's error still
    comes with the first job, as before."""
    from cuopt_torch.server.webserver import Routes
    from torch_server_stub import unhealthy_worker

    monkeypatch.setenv("CUOPT_TORCH_DEVICE", "cpu")
    jq = JobQueue(1, worker=unhealthy_worker)
    routes = Routes(jq)
    jq.start()
    try:
        req_id = jq.submit("lp", _dual_simplex(LP_PAYLOAD))
        res = _wait_status(jq, req_id, ("error", "done"))
        assert res["status"] == "error"
        assert "device health check failed on no-such-device" in \
            res["error"]
        time.sleep(0.5)  # the collector has read all the worker posted
        assert jq.procs[0].is_alive()
        assert _ready(routes) == 503 and not jq.ready_pids
        assert _live(routes) == [200, 200]
    finally:
        jq.shutdown()


def test_workers_get_their_devices(monkeypatch):
    monkeypatch.setenv("CUOPT_GPU_COUNT", "2")
    monkeypatch.delenv("CUOPT_TORCH_DEVICE", raising=False)
    jq = JobQueue()
    try:
        assert jq.devices == ["cuda:0", "cuda:1"]
    finally:
        jq.manager.shutdown()
    monkeypatch.setenv("CUOPT_TORCH_DEVICE", "cpu")
    jq = JobQueue(3)
    try:
        assert jq.devices == ["cpu"] * 3
    finally:
        jq.manager.shutdown()


def test_without_a_card_the_worker_refuses(monkeypatch):
    """CUOPT_TORCH_DEVICE unset: the worker's device is cuda:0, its health
    check fails on this machine, and the request ends as an error that
    names the check and its cause, with the traceback in the log."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("CUOPT_TORCH_DEVICE", raising=False)
    jq = JobQueue(1)
    jq.start()
    try:
        req_id = jq.submit("lp", _dual_simplex(LP_PAYLOAD))
        res = _wait_status(jq, req_id, ("error", "done"))
        assert res["status"] == "error"
        assert "device health check failed on cuda:0" in res["error"]
        end = time.monotonic() + DEADLINE
        while not jq.get_log(req_id) and time.monotonic() < end:
            time.sleep(0.05)
        assert "Traceback" in jq.get_log(req_id)[0]
    finally:
        jq.shutdown()
