"""Seeded MIP instances for the cuopt_torch MIP tests, built for either
package: each function takes that package's generate_lp or
OptimizationProblem, so both packages get the same arrays."""

import dataclasses

import numpy as np


def staircase_mip(generate, n, seed, with_point=False):
    """generate_lp's staircase LP with a seeded 30% of its columns made
    integer (their bounds are [0, 1], so binary) and row upper bounds set
    to A x_hat + U(0.1, 1.0) for a point x_hat with binary columns in
    {0, 1} and the others in U(0.2, 0.8): x_hat is feasible by
    construction and the instance is mixed. chip_smoke.py defines the same
    instance. With `with_point`, returns (problem, x_hat)."""
    p = generate(n, n, 8, seed=123, band=256)
    rng = np.random.default_rng(seed)
    is_int = np.zeros(n, bool)
    is_int[rng.choice(n, int(0.3 * n), replace=False)] = True
    x_hat = np.where(is_int, rng.integers(0, 2, n), rng.uniform(0.2, 0.8, n))
    rows = np.repeat(np.arange(n), np.diff(p.offsets))
    act = np.bincount(rows, weights=p.values * x_hat[p.indices], minlength=n)
    ub = act + rng.uniform(0.1, 1.0, n)
    p = dataclasses.replace(
        p, variable_types=np.where(is_int, "I", "C").astype("U1"),
        constraint_upper_bounds=ub, rhs=ub.copy())
    return (p, x_hat) if with_point else p


def knapsack(P):
    """max 5x0+4x1+3x2 s.t. 2x0+3x1+x2 <= 5, 4x0+x1+2x2 <= 11, x in {0..3}
    (tests/test_branch_and_bound.py), stated as a minimization."""
    A = np.array([[2.0, 3.0, 1.0], [4.0, 1.0, 2.0]])
    return P.from_dense(
        A, c=np.array([-5.0, -4.0, -3.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([5.0, 11.0]),
        variable_lower=np.zeros(3), variable_upper=np.full(3, 3.0),
        variable_types=np.array(["I", "I", "I"]))


def twelve_binaries(P):
    """The 12-variable instance of tests/test_branch_and_bound.py:123."""
    rng = np.random.default_rng(5)
    nvar = 12
    A = rng.integers(1, 9, (3, nvar)).astype(float)
    return P.from_dense(
        A, c=-(rng.integers(3, 20, nvar).astype(float)),
        constraint_lower=np.full(3, -np.inf),
        constraint_upper=A.sum(axis=1) * 0.4,
        variable_lower=np.zeros(nvar), variable_upper=np.ones(nvar),
        variable_types=np.array(["I"] * nvar))


def brute_force_min(p):
    """The optimum of a small bounded integer MIP by enumeration."""
    import itertools

    A = p.to_dense()
    c = p.objective_coefficients
    ranges = [range(int(lo), int(hi) + 1) for lo, hi in
              zip(p.variable_lower_bounds, p.variable_upper_bounds)]
    best = np.inf
    for x in itertools.product(*ranges):
        x = np.asarray(x, float)
        act = A @ x
        if np.all(act <= p.constraint_upper_bounds + 1e-9) and \
                np.all(act >= p.constraint_lower_bounds - 1e-9):
            best = min(best, float(c @ x) + p.objective_offset)
    return best
