"""cuopt_torch's band recovery (sparse/reorder.py, torch tensor ops)
against cuopt_tpu's (NumPy), on the CPU.

Every step of the recovery is exact (ranks, minima and maxima, sums of
integer positions, stable sorts), so the port's permutations, Cuthill–McKee
orders and BFS levels must equal cuopt_tpu's element for element. The
card runs the same ops: tests/test_torch_gpu.py holds its permutation to
this CPU one.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from cuopt_torch.problem.synthetic import generate_lp  # noqa: E402
from cuopt_torch.sparse import reorder as T  # noqa: E402
from cuopt_torch.sparse.ops import build_permuted_band  # noqa: E402
from cuopt_tpu.sparse import reorder as J  # noqa: E402

torch.set_num_threads(1)


def _shuffle(offsets, indices, n_rows, n_cols, seed):
    rng = np.random.default_rng(seed)
    o, i, _ = T.permute_csr(offsets, indices, np.zeros(len(indices)),
                            rng.permutation(n_rows), rng.permutation(n_cols),
                            n_rows, n_cols)
    return o, i, n_rows, n_cols


def _staircase(n, seed, k=8, band=256):
    p = generate_lp(n, n, k, seed=seed, band=band)
    return np.asarray(p.offsets), np.asarray(p.indices), n, n


def _two_blocks():
    """Two staircases side by side on the diagonal, rows and columns then
    shuffled together: two components whose ids interleave."""
    o1, i1, n1, _ = _staircase(700, 1, 6, 64)
    o2, i2, n2, _ = _staircase(500, 2, 5, 48)
    o = np.concatenate([o1, o2[1:] + o1[-1]])
    i = np.concatenate([i1, i2 + n1])
    return _shuffle(o, i, n1 + n2, n1 + n2, 3)


def _with_empty_lines():
    """A shuffled staircase with 40 empty rows and 30 empty columns put in
    at random places."""
    o, i, n, _ = _shuffle(*_staircase(900, 4, 6, 64), 5)
    rng = np.random.default_rng(6)
    kept_rows = np.sort(rng.choice(n + 40, n, replace=False))
    counts = np.zeros(n + 40, np.int64)
    counts[kept_rows] = np.diff(o)
    kept_cols = np.sort(rng.choice(n + 30, n, replace=False))
    return (np.concatenate([[0], np.cumsum(counts)]), kept_cols[i],
            n + 40, n + 30)


def _tridiagonal(n=1000):
    """Already as narrow as it gets: the identity wins."""
    rows = [[j for j in (r - 1, r, r + 1) if 0 <= j < n] for r in range(n)]
    return (np.concatenate([[0], np.cumsum([len(r) for r in rows])]),
            np.concatenate(rows), n, n)


CASES = {
    "shuffled-3k": lambda: _shuffle(*_staircase(3000, 0), 7),
    "shuffled-10k": lambda: _shuffle(*_staircase(10_000, 1), 8),
    "two-blocks": _two_blocks,
    "empty-rows-and-columns": _with_empty_lines,
    "identity-wins": _tridiagonal,
}


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", CASES)
def test_permutations_equal_cuopt_tpu(case):
    offsets, indices, n_rows, n_cols = CASES[case]()
    args = (offsets, indices, n_rows, n_cols)
    assert _same(T.cuthill_mckee_permutation(*args),
                 J.cuthill_mckee_permutation(*args))
    assert _same(T.pseudo_peripheral_levels(*args),
                 J.pseudo_peripheral_levels(*args))
    got = T.bandwidth_permutation(*args)
    assert _same(got, J.bandwidth_permutation(*args))
    identity = _same(got, (np.arange(n_rows), np.arange(n_cols)))
    assert identity == (case == "identity-wins")
    if identity:
        assert build_permuted_band(
            offsets, indices, np.ones(len(indices)), n_rows, n_cols,
            torch.float32, device="cpu") is None
