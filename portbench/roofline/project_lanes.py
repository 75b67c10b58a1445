"""K-C (csrc/project_lanes.cu): the exact projection of a depth's lanes.

Bytes, as chip_smoke.py counts them: per lane its record's target start
and end and the valid byte (9); per query its lane offset, window start and
range (20); per listed lane its record's run count, run offset, strand and
query id (16) and the arena at the two boundary runs (cum_t x4, the
insertion-run counts x2, runs x2, cum_q x2: 40); per hit its result
fields, 4 bytes each.  No operation count binds it.
"""

from __future__ import annotations

PER_LANE = 9
PER_QUERY = 20
PER_LISTED = 16 + 40
KERNEL = "impg_k_project_lanes"


def work(n_lanes: int, n_queries: int, n_listed: int, n_hits: int,
         fields: int) -> tuple[float, float]:
    """(bytes, 32-bit operations) of one depth's projection."""
    return (n_lanes * PER_LANE + n_queries * PER_QUERY
            + n_listed * PER_LISTED + n_hits * fields * 4), 0.0
