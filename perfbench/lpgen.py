"""The benchmark's LPs: a frozen copy of the program's staircase generator
and of its shuffle, so that later changes to the program cannot change
the work the benchmark asks of it.

`staircase` draws exactly what `cuopt_torch.problem.synthetic.generate_lp`
(band path, no equality rows) draws from the same seed, in the same order,
and returns the arrays alone: CSR rows, objective and bounds.
`tests/test_perfbench_frozen.py` holds the two equal. `shuffle` is the
random row and column permutation of `bench_torch.py shuffled`, with the
permutation drawn from a given generator and the CSR permuted as
`cuopt_torch.sparse.reorder.permute_csr` does.

Every array is float64 or int64 NumPy. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

KEYS = ("offsets", "indices", "values", "c", "lc", "uc", "lv", "uv")


def staircase(n_rows: int, n_cols: int, nnz_per_row: int, band: int,
              seed: int) -> dict:
    """min c.x  s.t.  A x <= b, 0 <= x <= 1, with row i's columns drawn
    from a window of width `band` around its proportional position and
    b = A x0 + slack for a random interior x0 (feasible and bounded)."""
    rng = np.random.default_rng(seed)
    cols = np.empty((n_rows, nnz_per_row), np.int64)
    W = max(band, nnz_per_row)
    Wc = min(W, n_cols)
    centers = (np.arange(n_rows) * n_cols) // max(n_rows, 1)
    starts = np.clip(centers - W // 2, 0, max(n_cols - W, 0))
    chunk = max(1, min(n_rows, (1 << 24) // max(Wc, 1)))
    for a in range(0, n_rows, chunk):
        b = min(a + chunk, n_rows)
        keys = rng.random((b - a, Wc))
        pick = np.argpartition(keys, nnz_per_row - 1, axis=1)[:, :nnz_per_row]
        cols[a:b] = starts[a:b, None] + pick
    vals = rng.standard_normal((n_rows, nnz_per_row))
    x0 = rng.uniform(0.2, 0.8, n_cols)
    ax0 = np.einsum("ij,ij->i", vals, x0[cols])
    slack = rng.uniform(0.1, 1.0, n_rows)
    c = rng.uniform(0.0, 1.0, n_cols)
    return {
        "offsets": np.arange(n_rows + 1, dtype=np.int64) * nnz_per_row,
        "indices": cols.reshape(-1),
        "values": vals.reshape(-1),
        "c": c,
        "lc": np.full(n_rows, -np.inf),
        "uc": ax0 + slack,
        "lv": np.zeros(n_cols),
        "uv": np.ones(n_cols),
    }


def shuffle(lp: dict, rng: np.random.Generator) -> dict:
    """The same LP with its rows and columns in a random order: row i of
    the result is row rp[i] of `lp`, column j is column cp[j]."""
    n, m = len(lp["lc"]), len(lp["c"])
    rp, cp = rng.permutation(n), rng.permutation(m)
    offsets = lp["offsets"]
    counts = np.diff(offsets)[rp]
    new_offsets = np.concatenate([[0], np.cumsum(counts)])
    src = (np.arange(int(new_offsets[-1]), dtype=np.int64)
           - np.repeat(new_offsets[:-1], counts)
           + np.repeat(offsets[rp], counts))
    inv_col = np.empty(m, np.int64)
    inv_col[cp] = np.arange(m)
    return {
        "offsets": new_offsets.astype(np.int64),
        "indices": inv_col[lp["indices"][src]],
        "values": lp["values"][src],
        "c": lp["c"][cp],
        "lc": lp["lc"][rp],
        "uc": lp["uc"][rp],
        "lv": lp["lv"][cp],
        "uv": lp["uv"][cp],
    }
