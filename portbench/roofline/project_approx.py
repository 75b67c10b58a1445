"""K-E (csrc/project_approx.cu): the tracepoint projection of a depth's
lanes.

Bytes, as chip_smoke.py counts them: per lane 9 and per query 20, as K-C;
per listed lane its record's four tracepoint columns (16), the boundary
values at both ends (32) and its query id (4); per hit its result fields,
4 bytes each.
"""

from __future__ import annotations

PER_LANE = 9
PER_QUERY = 20
PER_LISTED = 4 * 4 + 8 * 4 + 4
KERNEL = "impg_k_project_approx"


def work(n_lanes: int, n_queries: int, n_listed: int, n_hits: int,
         fields: int) -> tuple[float, float]:
    return (n_lanes * PER_LANE + n_queries * PER_QUERY
            + n_listed * PER_LISTED + n_hits * fields * 4), 0.0
