"""The port's routing islands (cuopt_torch/routing/islands.py) against
cuopt_tpu's, on the CPU: 40 orders, 8 islands of 2 members, 5 sweep
steps, the port on 8 CPU shards and cuopt_tpu on its 8-device mesh.
Routes must be equal, costs within 1e-5, and every order served once."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_helpers import run_tpu, serve  # noqa: E402

from cuopt_torch.io.vrp import synth_gh_instance  # noqa: E402
from cuopt_torch.parallel import make_mesh  # noqa: E402
from cuopt_torch.routing.construction import cheapest_insertion  # noqa: E402
from cuopt_torch.routing.internal import build_problem  # noqa: E402
from cuopt_torch.routing.islands import (  # noqa: E402
    apply_move,
    island_epoch,
    make_island_members,
    simulate_epoch,
    solution_cost_device,
)
from cuopt_torch.routing.local_search import build_ls_problem  # noqa: E402

D, P, N_STEPS = 8, 2, 5


def _start(prob):
    """The construction as an (F, L) route matrix and its lengths."""
    routes, unserved = cheapest_insertion(prob)
    assert not unserved
    F = prob.n_fleet
    L = max(8, max((len(r) for r in routes.values()), default=0) + 4)
    R0 = -np.ones((F, L), np.int64)
    lens0 = np.zeros(F, np.int64)
    for v, r in routes.items():
        R0[v, :len(r)] = r
        lens0[v] = len(r)
    cost = sum(prob.route_cost(v, r) for v, r in routes.items() if r)
    return R0, lens0, cost


@pytest.fixture(scope="module")
def start():
    prob = build_problem(synth_gh_instance(40, "C", seed=3).to_data_model())
    R0, lens0, cost = _start(prob)
    return prob, build_ls_problem(prob, device="cpu"), R0, lens0, cost


# ------------------------------------------------------ cuopt_tpu's side
def tpu_epoch(members):
    """cuopt_tpu's island_epoch on its 8-device mesh, from the members in
    the file `members` (the port's: its swaps keep every route feasible,
    where cuopt_tpu's make_island_members keeps any swap)."""
    import jax.numpy as jnp

    from cuopt_tpu.io.vrp import synth_gh_instance as j_synth
    from cuopt_tpu.parallel import make_mesh as j_mesh
    from cuopt_tpu.routing.construction import cheapest_insertion as j_ci
    from cuopt_tpu.routing.internal import build_problem as j_build
    from cuopt_tpu.routing.islands import island_epoch as j_epoch
    from cuopt_tpu.routing.local_search import build_ls_problem as j_ls

    prob = j_build(j_synth(40, "C", seed=3).to_data_model())
    R0, lens0, _ = _start_j(prob, j_ci)
    with np.load(members) as z:
        Rs, lenss = z["Rs"].astype(np.int32), z["lenss"].astype(np.int32)
    R, ln, c, best = j_epoch(j_ls(prob), jnp.asarray(Rs), jnp.asarray(lenss),
                             j_mesh(D), n_steps=N_STEPS)
    return dict(R0=R0, lens0=lens0, R=np.asarray(R), lens=np.asarray(ln),
                costs=np.asarray(c), best=np.asarray(best))


def _start_j(prob, ci):
    routes, _ = ci(prob)
    F = prob.n_fleet
    L = max(8, max((len(r) for r in routes.values()), default=0) + 4)
    R0 = -np.ones((F, L), np.int32)
    lens0 = np.zeros(F, np.int32)
    for v, r in routes.items():
        R0[v, :len(r)] = r
        lens0[v] = len(r)
    return R0, lens0, None


def tpu_moves(seed):
    """cuopt_tpu's apply_move on seeded moves of every family, from its
    construction of the 40-order instance."""
    import jax.numpy as jnp

    from cuopt_tpu.io.vrp import synth_gh_instance as j_synth
    from cuopt_tpu.routing.construction import cheapest_insertion as j_ci
    from cuopt_tpu.routing.internal import build_problem as j_build
    from cuopt_tpu.routing.islands import apply_move as j_apply

    prob = j_build(j_synth(40, "C", seed=3).to_data_model())
    R0, lens0, _ = _start_j(prob, j_ci)
    out = {}
    for n, (kind, mv) in enumerate(_moves(lens0, seed)):
        R, ln = j_apply(None, jnp.asarray(R0), jnp.asarray(lens0),
                        jnp.asarray(kind), jnp.asarray(mv))
        out[f"R{n}"], out[f"lens{n}"] = np.asarray(R), np.asarray(ln)
    return out


def _moves(lens, seed):
    """Valid moves of each family (kind, (a, b, c, d)) for routes of
    lengths `lens`, drawn from `seed`: both routes of a move differ but
    for the 2-opt and one swap inside a route."""
    rng = np.random.default_rng(seed)
    long = np.flatnonzero(np.asarray(lens) >= 3)
    out = []
    for _ in range(3):
        f1, f2 = (int(v) for v in rng.choice(long, 2, replace=False))
        l1, l2 = int(lens[f1]), int(lens[f2])
        i, k = int(rng.integers(l1)), int(rng.integers(l2))
        out.append((0, (f2, int(rng.integers(l2 + 1)), f1, i)))  # relocate
        out.append((1, (f1, i, f2, k)))                           # swap
        out.append((1, (f1, 0, f1, l1 - 1)))                      # inside
        a, b = sorted(int(v) for v in rng.choice(l1, 2, replace=False))
        out.append((2, (f1, a, f1, b)))                           # 2-opt
        out.append((3, (f1, int(rng.integers(l1 + 1)), f2,
                        int(rng.integers(l2 + 1)))))              # 2-opt*
        out.append((4, (f2, int(rng.integers(l2 + 1)), f1,
                        int(rng.integers(l1 - 1)))))              # or-opt
    return out


# ---------------------------------------------------------------- tests
def test_solution_cost_matches_the_host(start):
    prob, p, R0, lens0, cost = start
    got = float(solution_cost_device(p, torch.as_tensor(R0),
                                     torch.as_tensor(lens0)))
    assert abs(got - cost) <= 1e-3 * max(1.0, abs(cost))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_move_matches(start, seed):
    """Every family of move applied on the device, equal to cuopt_tpu's
    apply_move, route for route."""
    _, p, R0, lens0, _ = start
    want = run_tpu(__file__, tpu_moves, seed)
    for n, (kind, mv) in enumerate(_moves(lens0, seed)):
        R, ln = apply_move(p, torch.as_tensor(R0), torch.as_tensor(lens0),
                           torch.tensor(kind), torch.tensor(mv))
        assert np.array_equal(R.numpy(), want[f"R{n}"]), (kind, mv)
        assert np.array_equal(ln.numpy(), want[f"lens{n}"]), (kind, mv)


def test_island_members_keep_their_routes_feasible(start):
    """Every member's swap keeps both routes within their time windows
    and capacity (a member for which no feasible swap was drawn is a
    plain copy); most members differ from the start."""
    prob, _, R0, lens0, _ = start
    Rs, lenss = make_island_members(prob, R0, lens0, D * P)
    assert np.array_equal(Rs[0], R0)
    assert sum(not np.array_equal(R, R0) for R in Rs[1:]) > D * P // 2
    for R, ln in zip(Rs[1:], lenss[1:]):
        assert all(prob.route_feasible(f, [int(o) for o in R[f, :ln[f]]])
                   for f in range(prob.n_fleet))


def test_island_epoch_matches(start, tmp_path):
    """One epoch on 8 shards: routes equal to cuopt_tpu's island_epoch and
    to the port's one-device simulation, costs within 1e-5, the best no
    worse than construction, every order served once."""
    prob, p, R0, lens0, cost = start
    Rs, lenss = make_island_members(prob, R0, lens0, D * P)
    np.savez(tmp_path / "members.npz", Rs=Rs, lenss=lenss)
    want = run_tpu(__file__, tpu_epoch, str(tmp_path / "members.npz"))
    assert np.array_equal(want["R0"], R0)
    R8, l8, c8, best8 = island_epoch(p, torch.as_tensor(Rs),
                                     torch.as_tensor(lenss),
                                     make_mesh(devices=["cpu"] * D),
                                     n_steps=N_STEPS)
    Rw, lw, cw, bw = simulate_epoch(p, Rs, lenss, D, N_STEPS)
    for R, ln, c, b in ((Rw, lw, cw, bw),
                        (want["R"], want["lens"], want["costs"],
                         float(want["best"]))):
        assert np.array_equal(R8.numpy(), R)
        assert np.array_equal(l8.numpy(), ln)
        np.testing.assert_allclose(c8.numpy(), c, rtol=1e-5)
        np.testing.assert_allclose(float(best8), b, rtol=1e-5)
    assert float(best8) <= cost + 1e-6
    k = int(torch.argmin(c8))
    served = sorted(int(o) for f in range(prob.n_fleet)
                    for o in R8[k, f, :int(l8[k, f])])
    assert served == list(range(prob.n_serve))


if __name__ == "__main__":
    torch.set_num_threads(1)
    serve(globals())
