"""The card's peaks that every roofline share is taken against.

NVIDIA's H100 SXM data sheet, at its 700 W power limit: HBM3 at 3.35 TB/s,
and 67 TFLOP/s of float32 outside the tensor cores (an FMA counted as two
operations).  The sheet gives no 32-bit integer rate; the float32 rate
stands for it, and Hopper issues integer operations at no more than that
rate, so a bound by operations errs low.  A card set below 700 W runs
slower under load: each run reports the card's power limit beside these
shares.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the 32-bit operations over the operation rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S)
