"""K-D (csrc/compact.cu): order-preserving compaction of a depth's valid
lanes into rows of hits.

Bytes, as chip_smoke.py counts them: each lane's valid byte read, and each
hit's fields read and written once, 4 bytes a field.
"""

from __future__ import annotations

KERNEL = "impg_k_compact"


def work(n_lanes: int, n_hits: int, fields: int) -> tuple[float, float]:
    return n_lanes + 2 * n_hits * fields * 4, 0.0
