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
        q_bound = np.empty(total, np.int32)
        pre_diffs = np.empty(total, np.int64)
        pre_aligned = np.empty(total, np.int64)
        # Blocks of records, so that the temporaries scale with a block's
        # runs and boundaries, not the index's (an index past 2^31 runs
        # holds tens of GB of arena beside them).
        for r0 in range(0, n, BUILD_BLOCK):
            r1 = min(r0 + BUILD_BLOCK, n)
            b0 = int(seg_off[r0])
            b1 = int(seg_off[r1]) if r1 < n else total
            q_bound[b0:b1], pre_diffs[b0:b1], pre_aligned[b0:b1] = (
                _build_block(records, arena, spacing, r0, r1,
                             seg_off[r0:r1] - b0, n_bound[r0:r1]))
        return cls(
            spacing=spacing,
            seg_off=seg_off,
            n_seg=n_seg.astype(np.int32),
            q_bound=q_bound,
            pre_diffs=pre_diffs,
            pre_aligned=pre_aligned,
        )


# Records a block of `TracepointArena.build`: about 17M runs and 9M
# boundaries at the yeast-fitted shape (~517 runs a record).
BUILD_BLOCK = 1 << 15
_STAT_OPS = (cigar.OP_X, cigar.OP_I, cigar.OP_D)  # cum_mm, cum_ibp, cum_dbp


def _spans(start: np.ndarray, count: np.ndarray):
    """(loc, idx): the ranges [start, start + count) laid end to end, range
    i at idx[loc[i]:loc[i + 1]] (int64, the repeat/arange trick)."""
    loc = np.zeros(count.size + 1, np.int64)
    np.cumsum(count, out=loc[1:])
    idx = np.arange(int(loc[-1]), dtype=np.int64)
    idx += np.repeat(start - loc[:-1], count)
    return loc, idx


def _stats_at(arena: CigarArena, jg: np.ndarray, loc_off: np.ndarray,
              n_bound: np.ndarray) -> list:
    """[cum_mm, cum_ibp, cum_dbp] (int64) at arena runs `jg`, the runs read
    at the boundaries of a block's records (record i's at
    jg[loc_off[i]:][:n_bound[i]], ascending), as the arena's lazy
    statistics hold them without building them: each is a sum from the
    start of its run's `seg_offsets` segment.  A record's runs are summed
    from the start of the segment that holds the first run it reads: its
    own first run, or for a record with no runs, which reads the run at
    its offset clipped to the arena, that run's segment start.  The
    segments are the records' own (`ImpgIndex.derive_seg_offsets`), so
    none starts inside the runs a record reads."""
    seg = arena.seg_offsets
    lo = jg[loc_off]
    a = seg[np.searchsorted(seg, lo, side="right") - 1]
    loc, gather = _spans(a, jg[loc_off + n_bound - 1] + 1 - a)
    rec_b = np.repeat(np.arange(n_bound.size, dtype=np.int64), n_bound)
    pos = loc[rec_b] + jg - a[rec_b]
    base = loc[rec_b]
    runs = arena.runs[gather]
    lens = cigar.run_len(runs).astype(np.int64)
    ops = cigar.run_op(runs)
    out = []
    for op in _STAT_OPS:
        c = np.zeros(gather.size + 1, np.int64)
        np.cumsum(np.where(ops == op, lens, 0), out=c[1:])
        # int32, as arena._build_stats stores a prefix.
        out.append((c[pos] - c[base]).astype(np.int32).astype(np.int64))
    return out


def _build_block(records, arena, spacing, r0, r1, loc_off, n_bound):
    """(q_bound, pre_diffs, pre_aligned) of records [r0, r1), whose
    boundaries start at `loc_off` within the block."""
    m = r1 - r0
    t_start = records.t_start[r0:r1].astype(np.int64)
    t_end = records.t_end[r0:r1].astype(np.int64)
    # Grid coordinates for every boundary of every record.
    rec_of = np.repeat(np.arange(m, dtype=np.int64), n_bound)
    local_i = np.arange(rec_of.size, dtype=np.int64) - loc_off[rec_of]
    g = np.minimum(t_start[rec_of] + local_i * spacing, t_end[rec_of])

    # Locate the run containing each boundary: j = the last run of the
    # record with cum_t <= g.  cum_t ascends within a record's runs, so one
    # search over (record << 32) + cum_t keys, biased to be non-negative,
    # over the block's runs laid end to end, finds every boundary's run at
    # once (impg_tpu searches each record's runs in log2(n_runs) passes,
    # with the same result).
    cnt = records.op_cnt[r0:r1].astype(np.int64)
    op_off = records.op_off[r0:r1].astype(np.int64)
    run_loc, gather = _spans(op_off, cnt)
    bias = np.int64(2**31)
    run_rec = np.repeat(np.arange(m, dtype=np.int64), cnt)
    keys = (run_rec << 32) + (arena.cum_t[gather].astype(np.int64) + bias)
    lo = np.searchsorted(keys, (rec_of << 32) + (g + bias), side="right")
    j = np.clip(lo - run_loc[rec_of] - 1, 0, None)
    jg = np.clip(op_off[rec_of] + j, 0, max(arena.runs.size - 1, 0))

    runs_j = arena.runs[jg]
    kind = (runs_j >> np.uint32(29)).astype(np.int64)
    strand = records.strand[r0:r1][rec_of].astype(np.int64)
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
    # The statistics prefixes are read where the arena holds them, and else
    # summed here from the runs rather than built (24 B a run, 62 GB past
    # 2^31 runs).  Reading them is the cheaper: chip_smoke.py's tracepoint
    # build, after walks that built them, took 29.0 s reading and 44.7 s
    # summing on an H100 host.
    if arena.seg_offsets is None or arena.stats_materialized:
        mm, ibp, dbp = (getattr(arena, k)[jg].astype(np.int64)
                        for k in ("cum_mm", "cum_ibp", "cum_dbp"))
    else:
        mm, ibp, dbp = _stats_at(arena, jg, loc_off, n_bound)
    pre_diffs = (mm + np.where(is_x, frac, 0)) + ibp + (
        dbp + np.where(is_d, frac, 0))

    # Per-segment aligned bp = min(|dq|, dt); prefix over segments,
    # stored at boundaries (pre_aligned[0] = 0).  diff() spans record
    # boundaries; the subtraction of each record's base zeroes those
    # spurious segments at the record's boundary 0, where it is never read
    # as a segment.
    pre_aligned = np.zeros(rec_of.size, np.int64)
    if rec_of.size:
        seg_aligned = np.minimum(np.abs(np.diff(q_at)), np.diff(g))
        acc = np.cumsum(np.concatenate([[0], seg_aligned]))
        pre_aligned = acc - np.repeat(acc[loc_off], n_bound)
    return q_at.astype(np.int32), pre_diffs, pre_aligned


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
