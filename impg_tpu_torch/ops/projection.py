"""Closed-form batched coordinate projection through alignments, in torch.

Plain-torch counterpart of impg_tpu/ops/projection.py:project_batch with the
same keyword signature and the same `ProjectionResult` fields; see that module
for the semantics.  On the device path the same arithmetic runs fused inside
the K-C kernel (csrc/project_lanes.cu); this version is that kernel's plain
twin and the CPU path.

Torch differences handled here:
  * gathers take int64 indices, so offsets are int64 while every value stays
    int32 (the JAX path's semantics);
  * `runs` is the arena's uint32 array viewed as int32, and torch's `>>` on
    int32 is arithmetic, so the op is `(x >> 29) & 7` and the length
    `x & LEN_MASK`.
"""

from __future__ import annotations

import torch

from impg_tpu.core import cigar
from impg_tpu.ops.projection import ProjectionResult

_SEARCH_ITERS = 31


def _bisect(n: torch.Tensor, pred_fn, iters: int) -> torch.Tensor:
    """Lower bound: smallest i in [0, n) with pred_fn(i) True (n if none),
    as `iters` unrolled halving steps; needs 2**iters > max(n)."""
    lo = torch.zeros_like(n)
    hi = n.clone()
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        pred = pred_fn(mid)
        cont = lo < hi
        hi = torch.where(cont & pred, mid, hi)
        lo = torch.where(cont & ~pred, mid + 1, lo)
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

    Arena tensors are flat int32 (`runs` bit-cast from uint32); the other
    arguments are batch-shaped.  Returns int32 fields and a bool `valid`.
    """
    i32 = torch.int32
    arena_size = runs.shape[0]
    if arena_size == 0:
        z = torch.zeros(op_off.shape, dtype=i32, device=op_off.device)
        return ProjectionResult(
            torch.zeros(op_off.shape, dtype=torch.bool, device=op_off.device),
            z, z, z, z, z, z, z, z, z, z, z, z, z, z,
        )

    off = op_off.to(torch.int64)
    n = op_cnt.to(i32)
    rs = range_start.to(i32)
    re_ = range_end.to(i32)
    te_rec = t_end.to(i32)
    last_t = torch.minimum(te_rec, re_)

    def gather(arr, idx):
        return torch.take(arr, idx.to(torch.int64).clamp(0, arena_size - 1))

    len_mask = cigar.LEN_MASK

    def run_te(i):
        has_next = (i + 1) < n
        nxt = gather(cum_t, off + torch.where(has_next, i + 1, i))
        return torch.where(has_next, nxt, te_rec)

    zero = torch.zeros_like(n)

    i0 = _bisect(n, lambda mid: run_te(mid) > rs, search_iters)
    j1 = _bisect(n, lambda mid: gather(cum_t, off + mid) >= re_,
                 search_iters) - 1

    has_overlap = (rs < te_rec) & (re_ > t_start.to(i32)) & (n > 0) & (rs < re_)
    nmax = torch.clamp(n - 1, min=0)
    i0c = torch.minimum(torch.clamp(i0, min=0), nmax)
    j1c = torch.minimum(torch.clamp(j1, min=0), nmax)

    ts_i0 = gather(cum_t, off + i0c)
    f = torch.where(ts_i0 >= rs, i0c - gather(irun_before, off + i0c), i0c)
    te_j1 = run_te(j1c)
    l = torch.where(te_j1 <= last_t, j1c + gather(irun_after, off + j1c), j1c)

    fg = off + f
    lg = off + l
    run_f = gather(runs, fg)
    run_l = gather(runs, lg)
    kind_f = (run_f >> 29) & 7
    kind_l = (run_l >> 29) & 7
    len_l = run_l & len_mask
    ts_f = gather(cum_t, fg)
    qs_f = gather(cum_q, fg)
    ts_l = gather(cum_t, lg)
    qs_l = gather(cum_q, lg)

    direction = torch.where(strand.to(i32) == 0, 1, -1).to(i32)

    is_i_f = kind_f == cigar.OP_I
    is_d_f = kind_f == cigar.OP_D
    ov_s = torch.maximum(ts_f, rs)
    first_clip = torch.where(is_i_f, zero, ov_s - ts_f)
    pt_start = torch.where(is_i_f, ts_f, ov_s)
    pq_start = torch.where(is_i_f | is_d_f, qs_f, qs_f + (ov_s - ts_f) * direction)

    is_i_l = kind_l == cigar.OP_I
    is_d_l = kind_l == cigar.OP_D
    te_l = ts_l + torch.where(is_i_l, zero, len_l)
    qdelta_l = torch.where(is_d_l, zero, len_l * direction)
    ov_e = torch.minimum(te_l, re_)
    last_rem = torch.where(is_i_l, zero, ov_e - te_l)
    pt_end = torch.where(is_i_l, ts_l, ov_e)
    pq_end = torch.where(
        is_i_l,
        qs_l + qdelta_l,
        torch.where(is_d_l, qs_l, qs_l + (ov_e - ts_l) * direction),
    )

    valid = has_overlap & (pq_start != pq_end) & (pt_start != pt_end) & (f <= l)

    if not with_stats:
        return ProjectionResult(
            valid=valid, pq_start=pq_start, pq_end=pq_end, pt_start=pt_start,
            pt_end=pt_end, first_run=f, last_run=l, first_clip=first_clip,
            last_rem=last_rem, matches=zero, mismatches=zero, i_count=zero,
            d_count=zero, i_bp=zero, d_bp=zero,
        )

    def slice_stat(cum, own):
        return gather(cum, lg) - gather(cum, fg) + own

    one = torch.ones_like(zero)
    is_match_l = (kind_l == cigar.OP_EQ) | (kind_l == cigar.OP_M)
    is_x_l = kind_l == cigar.OP_X
    matches = slice_stat(cum_match, torch.where(is_match_l, len_l, zero))
    mismatches = slice_stat(cum_mm, torch.where(is_x_l, len_l, zero))
    i_count = slice_stat(cum_icnt, torch.where(is_i_l, one, zero))
    d_count = slice_stat(cum_dcnt, torch.where(is_d_l, one, zero))
    i_bp = slice_stat(cum_ibp, torch.where(is_i_l, len_l, zero))
    d_bp = slice_stat(cum_dbp, torch.where(is_d_l, len_l, zero))

    is_match_f = (kind_f == cigar.OP_EQ) | (kind_f == cigar.OP_M)
    is_x_f = kind_f == cigar.OP_X
    matches = matches - torch.where(is_match_f, first_clip, zero)
    mismatches = mismatches - torch.where(is_x_f, first_clip, zero)
    d_bp = d_bp - torch.where(is_d_f, first_clip, zero)

    matches = matches + torch.where(is_match_l, last_rem, zero)
    mismatches = mismatches + torch.where(is_x_l, last_rem, zero)
    d_bp = d_bp + torch.where(is_d_l, last_rem, zero)

    return ProjectionResult(
        valid=valid, pq_start=pq_start, pq_end=pq_end, pt_start=pt_start,
        pt_end=pt_end, first_run=f, last_run=l, first_clip=first_clip,
        last_rem=last_rem, matches=matches, mismatches=mismatches,
        i_count=i_count, d_count=d_count, i_bp=i_bp, d_bp=d_bp,
    )
