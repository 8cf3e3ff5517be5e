"""The least work of the float64 product pair (A x, then A^T y).

Beside `yardstick.py`, which holds the card's peaks: the bytes that one
attempt's two float64 products must move at the least, whatever layout
or kernel implements them (the unfused torch.bmm pair of today, or a
float64 row pass later).
"""

from __future__ import annotations


def pair_bytes(n_rows: int, n_cols: int, nnz: int) -> int:
    """Bytes one float64 pair must move at the least: each nonzero's
    float64 value and int32 column index read once (12 B); x read and
    A^T y written (float64, 16 B a column); the old activity, y and both
    row bounds read and the new activity and y written (float64, 48 B a
    row). 8.0 MB for the 50k staircase (400,000 nonzeros)."""
    return 12 * nnz + 16 * n_cols + 48 * n_rows
