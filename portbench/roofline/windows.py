"""Candidate windows of a depth's queries over the directed records (the
lanes of the lane kernels), counted on the host from the reference's own
record table (reference/walk.py:DirectedTable).

A query (sequence, start, end) has the records of its sequence, in index
order, from the first whose running maximum of target end reaches `start`
to the last whose target start is at most `end`; a lane is *listed* when
its record overlaps the query's range, the lanes a projection must read.
"""

from __future__ import annotations

import numpy as np

_SHIFT = np.int64(1) << np.int64(32)
_BLOCK = 1 << 22


def _keys(table):
    keys = getattr(table, "_window_keys", None)
    if keys is None:
        c = table.cols
        base = c["target"] * _SHIFT
        keys = (base + c["ts"], np.maximum.accumulate(base + c["te"]))
        table._window_keys = keys
    return keys


def census(table, q_tid, q_s, q_e) -> tuple[int, int]:
    """(lanes, listed lanes) of one depth's queries."""
    key_ts, key_cm = _keys(table)
    q_tid = np.asarray(q_tid, np.int64)
    q_s = np.asarray(q_s, np.int64)
    q_e = np.asarray(q_e, np.int64)
    lo = np.searchsorted(key_cm, q_tid * _SHIFT + q_s, "left")
    hi = np.searchsorted(key_ts, q_tid * _SHIFT + q_e, "right")
    k = np.maximum(hi - lo, 0)
    lanes = int(k.sum())
    listed = 0
    ts, te = table.cols["ts"], table.cols["te"]
    q0 = 0
    while q0 < k.size:
        # Blocks of queries holding about _BLOCK lanes.
        cum = np.cumsum(k[q0:])
        q1 = q0 + max(1, int(np.searchsorted(cum, _BLOCK, "right")))
        kk = k[q0:q1]
        n = int(kk.sum())
        if n:
            q = np.repeat(np.arange(q0, q1), kk)
            rec = (np.arange(n) - np.repeat(np.cumsum(kk) - kk, kk)
                   + np.repeat(lo[q0:q1], kk))
            listed += int(((te[rec] > q_s[q]) & (ts[rec] < q_e[q])).sum())
        q0 = q1
    return lanes, listed
