"""cuopt_torch's waypoint matrix on the golden graphs of
tests/test_distance_engine.py (the reference's first and second test
data models), against the golden values and cuopt_tpu's answers, and its
errors against cuopt_tpu's. The JAX file's real waypoint graph is read
from the absent reference datasets; seeded graphs stand in for it in
test_torch_routing_model.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import test_distance_engine as G  # noqa: E402
from cuopt_torch.distance_engine import WaypointMatrix  # noqa: E402
from cuopt_torch.utils.errors import ValidationError as TErr  # noqa: E402
from cuopt_tpu.distance_engine import WaypointMatrix as JW  # noqa: E402
from cuopt_tpu.utils.errors import ValidationError as JErr  # noqa: E402

torch.set_num_threads(1)


def TW(offsets, indices, weights):
    return WaypointMatrix(offsets, indices, weights, device="cpu")

GRAPHS = {
    "first": (G.OFFSETS1, G.INDICES1, G.WEIGHTS1, G.TARGETS1,
              G.LOCATIONS1, G.EXPECTED_COST1, G.EXPECTED_SEQ_OFFSETS1,
              G.EXPECTED_PATH1),
    "second": (G.OFFSETS2, G.INDICES2, G.WEIGHTS2, G.TARGETS2,
               G.LOCATIONS2, G.EXPECTED_COST2, G.EXPECTED_SEQ_OFFSETS2,
               G.EXPECTED_PATH2),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_golden_matrix_and_sequence(name):
    off, idx, w, targets, locs, cost, seq_off, path = GRAPHS[name]
    a, b = TW(off, idx, w), JW(off, idx, w)
    ca, cb = a.compute_cost_matrix(targets), b.compute_cost_matrix(targets)
    np.testing.assert_allclose(ca, cost)
    assert np.array_equal(np.asarray(ca), np.asarray(cb))
    sa = a.compute_waypoint_sequence(targets, locs)
    sb = b.compute_waypoint_sequence(targets, locs)
    np.testing.assert_array_equal(sa[0], seq_off)
    np.testing.assert_array_equal(sa[1], path)
    for x, y in zip(sa, sb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_custom_weights_golden():
    a = TW(G.OFFSETS1, G.INDICES1, G.WEIGHTS1)
    b = JW(G.OFFSETS1, G.INDICES1, G.WEIGHTS1)
    ca = a.compute_shortest_path_costs(G.TARGETS1, G.CUSTOM1)
    np.testing.assert_allclose(ca, G.EXPECTED_CUSTOM1)
    np.testing.assert_allclose(
        ca, b.compute_shortest_path_costs(G.TARGETS1, G.CUSTOM1), rtol=0)


@pytest.mark.parametrize("W,Err", [(TW, TErr), (JW, JErr)])
def test_errors_alike(W, Err):
    wm = W(G.OFFSETS1, G.INDICES1, G.WEIGHTS1)
    with pytest.raises(Err):  # the sequence needs the matrix first
        wm.compute_waypoint_sequence(G.TARGETS1, G.LOCATIONS1)
    with pytest.raises(Err):
        W([0, 1], [5], [1.0])  # target out of range
    with pytest.raises(Err):
        W([0, 2], [0], [1.0])  # offsets end != nnz
    with pytest.raises(Err):
        W([0, 1], [0], [-1.0])  # negative weight
    with pytest.raises(Err):
        wm.compute_cost_matrix([0, 99])
