"""The yardstick: the card's peaks and the least work a kernel must do.

Peaks are NVIDIA's data-sheet figures for the H100 SXM at its 700 W
power limit. A card set below that limit runs slower under load, so a
share of a peak is stated with the card's power limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3


def row_pass_bytes(n_rows: int, n_cols: int, nnz: int) -> int:
    """Bytes one fused row pass (A x -> dual prox -> A^T y) must move at
    the least, whatever layout implements it: each nonzero's float32
    value and int32 column index read once; x read and A^T y written
    (float32, one per column); the old activity, y and both row bounds
    read and the new activity and y written (float32, one per row)."""
    return 8 * nnz + 8 * n_cols + 24 * n_rows
