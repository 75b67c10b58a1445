"""K-I (csrc/path_sgd.cu): one epoch of the path-SGD layout, its pull
launch and its apply launch.

Operations per sample, as chip_smoke.py counts what the function needs in
32-bit operations: the Philox4x32-10 draw (about 100), the pair mapping's
integer work (about 12), the float64 offset (about 25, counted twice at
half the 32-bit rate), the pull (about 20) and the four accumulations.
Bytes: each step's 16-byte row read once, each segment's position read
and written, and its int64 sum and int32 count written, read and zeroed by
the apply.
"""

from __future__ import annotations

OPS_PER_SAMPLE = 100 + 12 + 2 * 25 + 20 + 4
STEP_BYTES = 16
SEG_BYTES = 4 * 2 + 8 * 2 + 4 * 2 + 8 + 4
KERNELS = ("impg_k_path_sgd_epoch", "impg_k_path_sgd_apply")


def epoch_work(n_steps: int, n_segs: int, samples: int) -> tuple[float, float]:
    """(bytes, 32-bit operations) of one epoch."""
    return (n_steps * STEP_BYTES + n_segs * SEG_BYTES,
            float(samples) * OPS_PER_SAMPLE)
