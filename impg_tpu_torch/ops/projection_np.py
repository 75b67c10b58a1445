"""Closed-form batched coordinate projection through alignments, in numpy.

The port's copy of impg_tpu/ops/projection.py's numpy half (the host engine's
projection; tests/test_torch_host.py holds the two equal).  Its torch
counterpart is ops/projection.py, the plain twin of the K-C kernel.

Replaces the reference's serial per-projection CIGAR walk
(impg.rs:2760-2898 `project_target_range_through_alignment`) with a
data-parallel formulation over the directed run arena:

  1. Two segmented binary searches over the per-record prefix sums `cum_t`
     locate the first/last runs whose target span intersects the requested
     range (consuming runs tile the target span, so the included run set is
     contiguous).
  2. Boundary 'I'-run extension: an insertion run sitting exactly on a range
     boundary is included by the reference walk (impg.rs:2809-2821); we
     reproduce this with precomputed contiguous-I-run lengths.
  3. The projected query/target endpoints, the first-run clip offset, the
     last-run remaining clip, and the identity statistics of the clipped
     slice all follow in closed form from the prefix arrays.

Exact-semantics notes (each verified against the reference walk):
  * A consuming ('='/'X'/'M'/'D') run is included iff its clipped target
    overlap is non-empty; an 'I' run is included iff its target position lies
    in [range_start, min(t_end, range_end)].
  * The walk's `last_op_remaining` is only updated by consuming runs; when the
    last included run is an 'I', the preceding consuming run was necessarily
    unclipped, so the remaining adjustment is 0.
  * A projection is valid iff some run is included AND the projected query and
    target intervals are both non-empty (impg.rs:2874-2878).
  * Identity statistics count 'M' as matches and count indel RUNS (not bp)
    for gap-compressed identity (impg.rs:2952-2974), with bp totals retained
    for block identity (main.rs:11940-11960).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from impg_tpu_torch.core import cigar

# Enough binary-search steps for segments up to 2^31 runs.
_SEARCH_ITERS = 31


class ProjectionResult(NamedTuple):
    """Batch-shaped arrays describing each projection (int32 unless noted)."""

    valid: Any  # bool
    pq_start: Any  # projected query start (walk order; > end on '-' strand)
    pq_end: Any
    pt_start: Any  # clipped target interval (always forward)
    pt_end: Any
    first_run: Any  # index of first included run, relative to record
    last_run: Any  # index of last included run (inclusive), relative
    first_clip: Any  # bp clipped from the front of the first run (>= 0)
    last_rem: Any  # bp adjustment for the last run (<= 0)
    matches: Any  # identity stats of the clipped slice
    mismatches: Any
    i_count: Any
    d_count: Any
    i_bp: Any
    d_bp: Any


def _bisect(n, pred_fn, iters: int):
    """Vectorized lower-bound: smallest i in [0, n) with pred_fn(i) True,
    as `iters` unrolled halving steps."""
    lo = np.zeros_like(n)
    hi = n
    for _ in range(iters):
        mid = (lo + hi) // 2
        pred = pred_fn(mid)
        cont = lo < hi
        hi = np.where(cont & pred, mid, hi)
        lo = np.where(cont & ~pred, mid + 1, lo)
    return lo


def project_batch(
    *,
    runs,
    cum_t,
    cum_q,
    irun_before,
    irun_after,
    cum_match=None,
    cum_mm=None,
    cum_icnt=None,
    cum_dcnt=None,
    cum_ibp=None,
    cum_dbp=None,
    op_off,
    op_cnt,
    t_start,
    t_end,
    strand,
    range_start,
    range_end,
    search_iters: int = _SEARCH_ITERS,
    with_stats: bool = True,
) -> ProjectionResult:
    """Project `range_[start,end)` through a batch of directed records.

    Arena arrays are flat; `op_off`/`op_cnt`/`t_start`/`t_end`/`strand` and the
    ranges are batch-shaped.  Returns `ProjectionResult` with a `valid` mask.
    `search_iters` must satisfy 2**search_iters > max op_cnt.
    """
    arena_size = runs.shape[0]
    if arena_size == 0:
        z = np.zeros(np.shape(op_off), dtype=np.int32)
        return ProjectionResult(
            np.zeros(np.shape(op_off), dtype=bool), z, z, z, z, z, z, z, z, z, z, z, z, z, z
        )

    i32 = np.int32
    idx_dtype = np.int64
    off = op_off.astype(idx_dtype)
    n = op_cnt.astype(i32)
    rs = range_start.astype(i32)
    re_ = range_end.astype(i32)
    te_rec = t_end.astype(i32)
    last_t = np.minimum(te_rec, re_)

    def gather(arr, idx):
        safe = np.clip(idx, 0, arena_size - 1)
        return np.take(arr, safe)

    lens_at = lambda idx: (gather(runs, idx) & np.uint32(cigar.LEN_MASK)).astype(i32)
    ops_at = lambda idx: (gather(runs, idx) >> np.uint32(29)).astype(np.uint8)

    def run_te(i):
        """Target end coordinate of run i (segment-relative index)."""
        has_next = (i + 1) < n
        nxt = gather(cum_t, off + np.where(has_next, i + 1, i).astype(idx_dtype))
        return np.where(has_next, nxt, te_rec).astype(i32)

    zero = np.zeros_like(n)

    # i0: first run with target_end > range_start.
    i0 = _bisect(n, lambda mid: run_te(mid) > rs, search_iters)

    # j1: last run with target_start < range_end.
    j1 = (
        _bisect(
            n,
            lambda mid: gather(cum_t, off + mid.astype(idx_dtype)) >= re_,
            search_iters,
        )
        - 1
    )

    has_overlap = (rs < te_rec) & (re_ > t_start.astype(i32)) & (n > 0) & (rs < re_)
    i0c = np.clip(i0, 0, np.maximum(n - 1, 0))
    j1c = np.clip(j1, 0, np.maximum(n - 1, 0))

    # Boundary insertion-run extension.
    ts_i0 = gather(cum_t, off + i0c.astype(idx_dtype))
    f = np.where(
        ts_i0 >= rs,
        i0c - gather(irun_before, off + i0c.astype(idx_dtype)),
        i0c,
    )
    te_j1 = run_te(j1c)
    l = np.where(
        te_j1 <= last_t,
        j1c + gather(irun_after, off + j1c.astype(idx_dtype)),
        j1c,
    )

    fg = off + f.astype(idx_dtype)
    lg = off + l.astype(idx_dtype)
    kind_f = ops_at(fg)
    kind_l = ops_at(lg)
    len_f = lens_at(fg)
    len_l = lens_at(lg)
    ts_f = gather(cum_t, fg)
    qs_f = gather(cum_q, fg)
    ts_l = gather(cum_t, lg)
    qs_l = gather(cum_q, lg)

    direction = np.where(strand.astype(i32) == 0, i32(1), i32(-1))

    is_i_f = kind_f == cigar.OP_I
    is_d_f = kind_f == cigar.OP_D
    ov_s = np.maximum(ts_f, rs)
    first_clip = np.where(is_i_f, zero, ov_s - ts_f)
    pt_start = np.where(is_i_f, ts_f, ov_s)
    pq_start = np.where(
        is_i_f | is_d_f, qs_f, qs_f + (ov_s - ts_f) * direction
    )

    is_i_l = kind_l == cigar.OP_I
    is_d_l = kind_l == cigar.OP_D
    tdelta_l = np.where(is_i_l, zero, len_l)
    te_l = ts_l + tdelta_l
    qdelta_l = np.where(is_d_l, zero, len_l * direction)
    ov_e = np.minimum(te_l, re_)
    last_rem = np.where(is_i_l, zero, ov_e - te_l)
    pt_end = np.where(is_i_l, ts_l, ov_e)
    pq_end = np.where(
        is_i_l,
        qs_l + qdelta_l,
        np.where(is_d_l, qs_l, qs_l + (ov_e - ts_l) * direction),
    )

    valid = has_overlap & (pq_start != pq_end) & (pt_start != pt_end) & (f <= l)

    if not with_stats:
        # Lean mode (device LEAN_FIELDS path): skip the six stats prefix
        # arrays entirely — they are then never touched in the traced
        # program, so a lazily-uploading arena never ships them to HBM.
        return ProjectionResult(
            valid=valid,
            pq_start=pq_start,
            pq_end=pq_end,
            pt_start=pt_start,
            pt_end=pt_end,
            first_run=f,
            last_run=l,
            first_clip=first_clip,
            last_rem=last_rem,
            matches=zero,
            mismatches=zero,
            i_count=zero,
            d_count=zero,
            i_bp=zero,
            d_bp=zero,
        )

    # ── identity statistics of the clipped slice ──
    def slice_stat(cum, own):
        return gather(cum, lg) - gather(cum, fg) + own

    is_match_l = (kind_l == cigar.OP_EQ) | (kind_l == cigar.OP_M)
    is_x_l = kind_l == cigar.OP_X
    matches = slice_stat(cum_match, np.where(is_match_l, len_l, zero))
    mismatches = slice_stat(cum_mm, np.where(is_x_l, len_l, zero))
    i_count = slice_stat(cum_icnt, np.where(is_i_l, np.ones_like(zero), zero))
    d_count = slice_stat(cum_dcnt, np.where(is_d_l, np.ones_like(zero), zero))
    i_bp = slice_stat(cum_ibp, np.where(is_i_l, len_l, zero))
    d_bp = slice_stat(cum_dbp, np.where(is_d_l, len_l, zero))

    # Front clip correction (first run shortened by first_clip bp).
    is_match_f = (kind_f == cigar.OP_EQ) | (kind_f == cigar.OP_M)
    is_x_f = kind_f == cigar.OP_X
    matches = matches - np.where(is_match_f, first_clip, zero)
    mismatches = mismatches - np.where(is_x_f, first_clip, zero)
    d_bp = d_bp - np.where(is_d_f, first_clip, zero)

    # Tail clip correction (last run extended by last_rem <= 0 bp).
    matches = matches + np.where(is_match_l, last_rem, zero)
    mismatches = mismatches + np.where(is_x_l, last_rem, zero)
    d_bp = d_bp + np.where(is_d_l, last_rem, zero)

    return ProjectionResult(
        valid=valid,
        pq_start=pq_start,
        pq_end=pq_end,
        pt_start=pt_start,
        pt_end=pt_end,
        first_run=f,
        last_run=l,
        first_clip=first_clip,
        last_rem=last_rem,
        matches=matches,
        mismatches=mismatches,
        i_count=i_count,
        d_count=d_count,
        i_bp=i_bp,
        d_bp=d_bp,
    )


def gap_compressed_identity(res: ProjectionResult):
    """f64 gap-compressed identity per projection (impg.rs:2952)."""
    total = res.matches + res.mismatches + res.i_count + res.d_count
    return np.where(
        total > 0,
        res.matches.astype(np.float64) / np.maximum(total, 1).astype(np.float64),
        0.0,
    )


def clipped_runs(arena_runs: np.ndarray, op_off: int, res_row: dict) -> np.ndarray:
    """Materialize the clipped CIGAR runs for one projection (host side).

    `res_row` carries scalar first_run/last_run/first_clip/last_rem values.
    Used for PAF output and merge bookkeeping; the batched device path never
    materializes runs.
    """
    f = int(res_row["first_run"])
    l = int(res_row["last_run"])
    first_clip = int(res_row["first_clip"])
    last_rem = int(res_row["last_rem"])
    out = arena_runs[op_off + f : op_off + l + 1].copy()
    if first_clip > 0:
        out[0] = (out[0] & np.uint32(7 << 29)) | np.uint32(
            (int(out[0] & cigar.LEN_MASK) - first_clip) & cigar.LEN_MASK
        )
    if last_rem < 0:
        out[-1] = (out[-1] & np.uint32(7 << 29)) | np.uint32(
            (int(out[-1] & cigar.LEN_MASK) + last_rem) & cigar.LEN_MASK
        )
    return out
