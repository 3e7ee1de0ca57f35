"""The least work of an SH colour evaluation, the yardstick of
`render.sh_roofline.train`: counted from the program's counters
`render.sh_rows` (the rows evaluated) and `render.sh_coeffs` ((d+1)^2,
the coefficients a row holds at the evaluated degree d), so that it stays
the same work whatever implements the evaluation.

A row reads its (d+1)^2 x 3 coefficients and its mean's 3 coordinates
once and writes its 3 colour channels once, all float32: 12 (d+1)^2 + 24
bytes, 132 at degree 2. The camera's position and the SH constants are a
few bytes a view. Its operations (`counts.sh_flops_per_row`: 72 at
degree 2) are under 0.6 a byte, far below the card's 20 FP32 operations a
byte of HBM, so the bytes bound it.
"""
from __future__ import annotations

from hgsbench.counts import HBM_BYTES_PER_S


def bytes_per_row(coeffs: int) -> int:
    """Bytes one row of `coeffs` SH coefficients reads and writes once."""
    return 4 * (3 * coeffs + 3 + 3)


def least_seconds(rows: int, coeffs: int) -> float:
    """The least time the card could take to evaluate `rows` rows of
    `coeffs` coefficients: their bytes over the HBM bandwidth."""
    return rows * bytes_per_row(coeffs) / HBM_BYTES_PER_S
