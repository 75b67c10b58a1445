"""Tracepoint arena + approximate projection (reference: impg.rs:646-1534).

The port's copy of impg_tpu/index/tracepoints.py
(tests/test_torch_host.py holds the two equal).

Tracepoints summarize an alignment as uniform target-grid segments, each
carrying the query bp consumed and an edit-difference count.  The reference
reads them from .1aln/.tpa containers; here they are DERIVED from the
directed run arena at index-build time (one vectorized interpolation pass),
stored per directed record, and serve the `--approximate` query mode:
interval projection from tracepoint statistics alone — no run slicing, no
sequence I/O (reference notes/FAST_MODE_IMPLEMENTATION.md: 10-100x).

Per directed record with target span [t_start, t_end) and grid `spacing`:
  boundaries b_i = t_start + i*spacing (last boundary = t_end);
  q_bound[i]   = query walk position at b_i (strand-directional, matching
                 the run arena's cum_q convention);
  pre_diffs[i] = edit bp (X + I bp + D bp) before b_i;
  pre_aligned[i] = sum over earlier segments of min(|dq|, dt).

Approximate projection of [rs, re):
  segment index is O(1) arithmetic ((rs - t_start) // spacing);
  boundary query positions refine by linear interpolation within the first
  and last overlapping segments (impg.rs:1367-1416 refine_boundary);
  identity comes from the aligned/diff prefix sums; the target interval is
  the requested range itself (impg.rs:1508).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.arena import CigarArena, DirectedRecords


@dataclass
class TracepointArena:
    spacing: int
    seg_off: np.ndarray  # int64 [n_records] — offset into boundary arrays
    n_seg: np.ndarray  # int32 [n_records]
    q_bound: np.ndarray  # int32 — query walk pos at each boundary
    pre_diffs: np.ndarray  # int64 — edit bp before each boundary
    pre_aligned: np.ndarray  # int64 — aligned bp (per-seg min) before boundary

    FIELDS = ("seg_off", "n_seg", "q_bound", "pre_diffs", "pre_aligned")

    @classmethod
    def build(
        cls, records: DirectedRecords, arena: CigarArena, spacing: int
    ) -> "TracepointArena":
        n = len(records)
        t_start = records.t_start.astype(np.int64)
        t_end = records.t_end.astype(np.int64)
        n_seg = np.maximum(
            np.ceil((t_end - t_start) / spacing).astype(np.int64), 1
        )
        n_bound = n_seg + 1
        seg_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(n_bound)]
        )[:-1]
        total = int(n_bound.sum()) if n else 0

        # Grid coordinates for every boundary of every record.
        rec_of = np.repeat(np.arange(n, dtype=np.int64), n_bound)
        local_i = np.arange(total, dtype=np.int64) - seg_off[rec_of]
        g = t_start[rec_of] + local_i * spacing
        g = np.minimum(g, t_end[rec_of])

        # Locate the run containing each boundary: j = the last run of the
        # record with cum_t <= g, one search a record (cum_t ascends within
        # a record's runs; impg_tpu searches every boundary at once in
        # log2(n_runs) passes, with the same result).
        op_off = records.op_off[rec_of]
        lo = np.zeros(total, np.int64)
        bounds = zip(records.op_off.tolist(), records.op_cnt.tolist(),
                     seg_off.tolist(), n_bound.tolist())
        for a, c, b, nb in bounds:
            lo[b:b + nb] = np.searchsorted(arena.cum_t[a:a + c],
                                           g[b:b + nb], side="right")
        j = np.clip(lo - 1, 0, None)
        jg = np.clip(op_off + j, 0, max(arena.runs.size - 1, 0))

        runs_j = arena.runs[jg]
        kind = (runs_j >> np.uint32(29)).astype(np.int64)
        strand = records.strand[rec_of].astype(np.int64)
        direction = np.where(strand == 0, 1, -1)

        frac = g - arena.cum_t[jg].astype(np.int64)
        consumes_q = kind != cigar.OP_D
        consumes_t = kind != cigar.OP_I
        is_x = kind == cigar.OP_X
        is_d = kind == cigar.OP_D
        # For runs not consuming target, frac must be 0 (boundary at run start).
        frac = np.where(consumes_t, frac, 0)

        q_at = arena.cum_q[jg].astype(np.int64) + np.where(
            consumes_t & consumes_q, frac * direction, 0
        )
        mm_at = arena.cum_mm[jg].astype(np.int64) + np.where(is_x, frac, 0)
        ibp_at = arena.cum_ibp[jg].astype(np.int64)
        dbp_at = arena.cum_dbp[jg].astype(np.int64) + np.where(is_d, frac, 0)

        pre_diffs = mm_at + ibp_at + dbp_at

        # Per-segment aligned bp = min(|dq|, dt); prefix over segments,
        # stored at boundaries (pre_aligned[0] = 0).
        pre_aligned = np.zeros(total, np.int64)
        if total:
            dq = np.abs(np.diff(q_at))
            dt = np.diff(g)
            seg_aligned = np.minimum(dq, dt)
            # Boundary starts of each record reset the prefix.
            is_start = np.zeros(total, bool)
            is_start[seg_off] = True
            acc = np.cumsum(np.concatenate([[0], seg_aligned]))
            base = np.repeat(acc[seg_off], n_bound)
            pre_aligned = acc - base
            # Cross-record contamination: diff() spans record boundaries; the
            # boundary-start positions zero out via base subtraction, and the
            # spurious cross-record segment lands at each record's boundary 0
            # where it is never read as a segment.

        return cls(
            spacing=spacing,
            seg_off=seg_off,
            n_seg=n_seg.astype(np.int32),
            q_bound=q_at.astype(np.int32),
            pre_diffs=pre_diffs,
            pre_aligned=pre_aligned,
        )


class ApproxResult(NamedTuple):
    valid: np.ndarray
    pq_start: np.ndarray
    pq_end: np.ndarray
    pt_start: np.ndarray
    pt_end: np.ndarray
    matches: np.ndarray  # float64 (reference accumulates f64)
    mismatches: np.ndarray


def project_batch_approx(
    tp: TracepointArena,
    records: DirectedRecords,
    cand: np.ndarray,
    rng_s: np.ndarray,
    rng_e: np.ndarray,
) -> ApproxResult:
    """Approximate projection of ranges through candidate directed records."""
    spacing = tp.spacing
    t0 = records.t_start[cand].astype(np.int64)
    te = records.t_end[cand].astype(np.int64)
    q0 = records.q_start[cand].astype(np.int64)
    qe = records.q_end[cand].astype(np.int64)
    off = tp.seg_off[cand]
    nseg = tp.n_seg[cand].astype(np.int64)
    rs = rng_s.astype(np.int64)
    re_ = rng_e.astype(np.int64)

    valid = (rs < te) & (re_ > t0) & (rs < re_)
    rs_c = np.clip(rs, t0, te - 1)
    re_c = np.clip(re_, t0 + 1, te)

    i0 = np.clip((rs_c - t0) // spacing, 0, nseg - 1)
    j1 = np.clip((re_c - 1 - t0) // spacing, 0, nseg - 1)

    def boundary(i):
        return np.minimum(t0 + i * spacing, te)

    def refine(i, overlap_pos):
        seg_s = boundary(i)
        seg_e = boundary(i + 1)
        q_pos = tp.q_bound[off + i].astype(np.int64)
        q_next = tp.q_bound[off + i + 1].astype(np.int64)
        q_delta = q_next - q_pos
        t_delta = seg_e - seg_s
        with np.errstate(divide="ignore", invalid="ignore"):
            advance = np.where(
                t_delta > 0,
                np.round(
                    (overlap_pos - seg_s).astype(np.float64)
                    * q_delta.astype(np.float64)
                    / np.maximum(t_delta, 1).astype(np.float64)
                ),
                0.0,
            )
        refined = q_pos + advance.astype(np.int64)
        lo = np.minimum(q0, qe)
        hi = np.maximum(q0, qe)
        return np.clip(refined, lo, hi)

    pq_start = refine(i0, np.maximum(boundary(i0), rs_c))
    pq_end = refine(j1, np.minimum(boundary(j1 + 1), re_c))

    aligned = (
        tp.pre_aligned[off + j1 + 1] - tp.pre_aligned[off + i0]
    ).astype(np.float64)
    diffs = (tp.pre_diffs[off + j1 + 1] - tp.pre_diffs[off + i0]).astype(
        np.float64
    )
    matches = np.maximum(aligned - diffs, 0.0)

    return ApproxResult(
        valid=valid,
        pq_start=pq_start.astype(np.int64),
        pq_end=pq_end.astype(np.int64),
        pt_start=rs.astype(np.int64),
        pt_end=re_.astype(np.int64),
        matches=matches,
        mismatches=diffs,
    )


def gap_compressed_identity_approx(res: ApproxResult) -> np.ndarray:
    """Identity from the approximate stats (reference builds a 2-op CIGAR of
    rounded match/mismatch totals; gap-compressed identity over it is
    matches/(matches+mismatches))."""
    m = np.round(res.matches)
    x = np.round(res.mismatches)
    total = m + x
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(total > 0, m / np.maximum(total, 1.0), 0.0)
