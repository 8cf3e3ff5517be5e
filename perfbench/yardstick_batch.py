"""The least work of a batch's float64 product pairs, for members that
share one matrix.

Beside `yardstick_f64.py`, whose bytes a column, a row and a nonzero it
takes: a pass of the batch's attempt loop needs the shared matrix read
once, whatever the implementation (the stacked slabs of today read each
member's copy), and each member's vectors once for each of its own
attempts. No member takes fewer passes than its attempts, so the matrix
is read at least as often as the most attempts of any member.
"""

from __future__ import annotations

from perfbench.yardstick_f64 import pair_bytes


def batch_pair_bytes(n_rows: int, n_cols: int, nnz: int,
                     attempts) -> int:
    """Bytes the batch's pairs must move at the least: max(attempts)
    reads of the shared matrix (12 B a nonzero) and, for each member's
    attempt, its vectors (16 B a column, 48 B a row). At 50k, 4.8 MB of
    matrix and 3.2 MB of vectors a member: 30.4 MB a pass of 8."""
    attempts = list(attempts)
    return (max(attempts) * pair_bytes(0, 0, nnz)
            + sum(attempts) * pair_bytes(n_rows, n_cols, 0))
