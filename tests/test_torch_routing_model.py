"""cuopt_torch's routing data layer against cuopt_tpu's, on the CPU.

DataModel validation, build_problem, the generators, the Solomon and
CVRPLIB readers and the route table are host numpy in both packages, so
their arrays must be equal bit for bit. The waypoint matrix relaxes in
float32 on each package's device: held to rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.io.vrp as t_vrp  # noqa: E402
import cuopt_tpu.io.vrp as j_vrp  # noqa: E402
from cuopt_torch.distance_engine import WaypointMatrix as TWaypoint  # noqa: E402
from cuopt_torch.routing import DataModel as TDataModel  # noqa: E402
from cuopt_torch.routing import DatasetParams as TParams  # noqa: E402
from cuopt_torch.routing import Solve as t_solve  # noqa: E402
from cuopt_torch.routing import SolverSettings as TSettings  # noqa: E402
from cuopt_torch.routing import generate_dataset as t_generate  # noqa: E402
from cuopt_torch.routing.assignment import RouteTable  # noqa: E402
from cuopt_torch.routing.internal import build_problem as t_build  # noqa: E402
from cuopt_torch.utils.errors import ValidationError as TValidationError  # noqa: E402
from cuopt_tpu.distance_engine import WaypointMatrix as JWaypoint  # noqa: E402
from cuopt_tpu.routing import DataModel as JDataModel  # noqa: E402
from cuopt_tpu.routing import DatasetParams as JParams  # noqa: E402
from cuopt_tpu.routing import Solve as j_solve  # noqa: E402
from cuopt_tpu.routing import SolverSettings as JSettings  # noqa: E402
from cuopt_tpu.routing import generate_dataset as j_generate  # noqa: E402
from cuopt_tpu.routing.internal import build_problem as j_build  # noqa: E402
from cuopt_tpu.utils.errors import ValidationError as JValidationError  # noqa: E402
from torch_routing_instances import GH60_VARIANTS, gh60  # noqa: E402

torch.set_num_threads(1)


def _same(a, b, where=""):
    """Equal values of the same kind: arrays, dicts, lists, scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b or (a != a and b != b), (where, a, b)


# the bad inputs of tests/test_routing.py:197-216, per package
BAD_INPUTS = {
    "bad-matrix-shape": lambda D: D(3, 1).add_cost_matrix(np.ones((2, 3))),
    "bad-order-location": lambda D: D(3, 1, n_orders=2)
    .set_order_locations([1, 7]),
    "bad-time-windows": lambda D: D(3, 1).set_order_time_windows(
        [10, 10, 10], [0, 20, 20]),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_validation_errors_match(case):
    with pytest.raises(TValidationError) as t_err:
        BAD_INPUTS[case](TDataModel)
    with pytest.raises(JValidationError) as j_err:
        BAD_INPUTS[case](JDataModel)
    assert str(t_err.value) == str(j_err.value)


def test_no_cost_matrix_fails_alike():
    """A DataModel without a cost matrix: Solve returns FAIL with the
    same message in both packages (no device is touched)."""
    sols = []
    for D, solve, S, kw in ((TDataModel, t_solve, TSettings,
                             dict(device="cpu")),
                            (JDataModel, j_solve, JSettings, {})):
        s = S()
        s.set_time_limit(1.0)
        sols.append(solve(D(3, 1), s, **kw))
    t, j = sols
    assert t.get_status() == j.get_status() == 1
    assert t.get_error_status() == j.get_error_status() == 1
    assert t.get_error_message() == j.get_error_message()
    assert len(t.get_route()) == 0 and t.get_route().columns == list(
        j.get_route().columns)


@pytest.mark.parametrize("variant", GH60_VARIANTS)
def test_build_problem_matches(variant):
    tp = t_build(gh60(t_vrp, variant)[1])
    jp = j_build(gh60(j_vrp, variant)[1])
    for f in dataclasses.fields(jp):
        _same(getattr(tp, f.name), getattr(jp, f.name), f.name)
    routes = {v: list(range(v, tp.n_serve, tp.n_fleet))
              for v in range(tp.n_fleet)}
    # host route feasibility and costs in float64, the same numbers
    for v, r in routes.items():
        assert tp.route_cost(v, r) == jp.route_cost(v, r)
        assert tp.route_feasible(v, r) == jp.route_feasible(v, r)


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_generators_match(seed):
    for kind in ("C", "R", "RC"):
        a = t_vrp.synth_gh_instance(50, kind, seed=seed)
        b = j_vrp.synth_gh_instance(50, kind, seed=seed)
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name), f.name)
    kw = dict(n_locations=21, seed=seed, tw_tightness=0.5,
              n_vehicle_types=2, pickup_delivery=seed % 2 == 1)
    a, b = t_generate(TParams(**kw)), j_generate(JParams(**kw))
    for k, v in vars(b).items():
        _same(vars(a)[k], v, k)


SOLOMON = """TEST2

VEHICLE
NUMBER     CAPACITY
  4         60

CUSTOMER
CUST NO.  XCOORD.   YCOORD.    DEMAND   READY TIME  DUE DATE   SERVICE TIME

    0      40         50          0          0       1236          0
    1      45         68         10        912        967         90
    2      45         70         30        825        870         90
    3      42         66         10         65        146         90
    4      42         68         20        727        782         90
"""

CVRP = """NAME : t-n6-k2
COMMENT : written in the test
TYPE : CVRP
DIMENSION : 6
EDGE_WEIGHT_TYPE : EUC_2D
CAPACITY : 40
NODE_COORD_SECTION
1 0 0
2 10 0
3 0 7
4 5 5
5 9 9
6 3 1
DEMAND_SECTION
1 0
2 12
3 15
4 8
5 20
6 9
DEPOT_SECTION
1
-1
EOF
"""


@pytest.mark.parametrize("fmt", ["solomon", "cvrplib"])
def test_parsers_match(fmt):
    if fmt == "solomon":
        a, b = t_vrp.parse_solomon(SOLOMON), j_vrp.parse_solomon(SOLOMON)
        _same(t_vrp.write_solomon(a), j_vrp.write_solomon(b))
    else:
        a, b = t_vrp.parse_cvrplib(CVRP), j_vrp.parse_cvrplib(CVRP)
    for f in dataclasses.fields(b):
        _same(getattr(a, f.name), getattr(b, f.name), f.name)
    _same(a.cost_matrix(), b.cost_matrix())
    ta, tb = t_build(a.to_data_model()), j_build(b.to_data_model())
    _same(ta.cost_mats, tb.cost_mats)
    _same(ta.capacity, tb.capacity)


def _graph(seed, n=40, deg=3, integral=False):
    rng = np.random.default_rng(seed)
    nbrs = [np.unique(np.concatenate([[(v + 1) % n],
                                      rng.choice(n, deg, replace=False)]))
            for v in range(n)]
    nbrs = [x[x != v] for v, x in enumerate(nbrs)]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in nbrs])])
    w = rng.uniform(1.0, 20.0, offsets[-1])
    return offsets, np.concatenate(nbrs), np.round(w, 0 if integral else 3)


TARGETS = [0, 5, 11, 17, 33]
ROUTE = [0, 2, 4, 1, 0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_waypoint_matrix_matches(seed):
    off, idx, w = _graph(seed)
    a = TWaypoint(off, idx, w, device="cpu")
    b = JWaypoint(off, idx, w)
    np.testing.assert_allclose(a.compute_cost_matrix(TARGETS),
                               b.compute_cost_matrix(TARGETS), rtol=1e-6)
    # on integral weights every float32 sum is exact: the same paths
    off, idx, w = _graph(seed, integral=True)
    a = TWaypoint(off, idx, w, device="cpu")
    b = JWaypoint(off, idx, w)
    _same(a.compute_cost_matrix(TARGETS), b.compute_cost_matrix(TARGETS))
    for x, y in zip(a.compute_waypoint_sequence(TARGETS, ROUTE),
                    b.compute_waypoint_sequence(TARGETS, ROUTE)):
        _same(x, y)
    custom = np.random.default_rng(seed).uniform(0, 5, len(w))
    np.testing.assert_allclose(
        a.compute_shortest_path_costs(TARGETS, custom),
        b.compute_shortest_path_costs(TARGETS, custom), rtol=1e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_waypoint_sequence_on_fractional_weights(seed):
    """A departure from cuopt_tpu, which raises "no path" here (its tree
    test compares float32 distances with float64 sums at 1e-9): each leg
    of the port's sequence is a chain of graph edges whose weights sum to
    the leg's cost."""
    off, idx, w = _graph(seed)
    a = TWaypoint(off, idx, w, device="cpu")
    cost = a.compute_cost_matrix(TARGETS)
    seq_off, path = a.compute_waypoint_sequence(TARGETS, ROUTE)
    edge = {(u, int(v)): float(wt) for u in range(len(off) - 1)
            for v, wt in zip(idx[off[u]:off[u + 1]], w[off[u]:off[u + 1]])}
    for k, (i, j) in enumerate(zip(ROUTE, ROUTE[1:])):
        leg = path[seq_off[k]:seq_off[k + 1]].tolist()
        assert leg[0] == TARGETS[i] and leg[-1] == TARGETS[j]
        total = sum(edge[(u, v)] for u, v in zip(leg, leg[1:]))
        np.testing.assert_allclose(total, cost[i, j], rtol=1e-5)


def test_route_table_and_solution_cost():
    """The port's pandas-free route table holds cuopt_tpu's rows, and
    solution_cost reads it as cuopt_tpu's reads the DataFrame."""
    pd = pytest.importorskip("pandas")
    rows = [(0, 0.0, 1, 0, "Depot"), (3, 5.0, 1, 3, "Delivery"),
            (1, 9.5, 1, 1, "Delivery"), (0, 20.0, 1, 0, "Depot"),
            (0, 0.0, 0, 0, "Depot"), (2, 4.0, 0, 2, "Delivery"),
            (0, 11.0, 0, 0, "Depot")]
    t = RouteTable(rows)
    df = pd.DataFrame(rows, columns=t.columns)
    assert t.rows() == rows and len(t) == 7
    for name in t.columns:  # cuopt_tpu's DataFrame, column by column
        assert t[name].tolist() == df[name].tolist(), name
    served = t[t["type"] != "Depot"]
    assert served["location"].tolist() == [3, 1, 2]
    inst = t_vrp.parse_solomon(SOLOMON)

    class _Sol:
        def __init__(self, route):
            self.route = route

        def get_route(self):
            return self.route

    assert t_vrp.solution_cost(inst, _Sol(t)) == \
        j_vrp.solution_cost(j_vrp.parse_solomon(SOLOMON), _Sol(df))
