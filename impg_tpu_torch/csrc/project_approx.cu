// K-E project_approx: exact lane enumeration + hit gate + tracepoint
// (approximate) projection, fused.
//
// Replaces: impg_tpu/query/device.py:_project_approx_device, reached through
// _lanes_core's `tp is not None` branch over the dense B x k_max or
// slot x k_slot lane grids of _query_core / _slot_core.
//
// Bound on the H100: memory latency.  Per lane: the lane's query (an
// upper-bound search over the int64 lane offsets), four record loads, four
// tracepoint record loads, then four q_bound and four prefix loads at the
// first and last segments, scattered across a ~1.7 GB boundary table; the
// arithmetic is some fifty integer ops.  There is no search over runs, so a
// lane costs a fraction of K-C's.
//
// Design: one thread per exact lane, as K-C (csrc/lanes.cuh).  The segment
// of a position is O(1) arithmetic; the query offset inside a segment is
// od * q_delta / t rounded half to even in exact int32 integers, with
// |q_delta| split as (|q_delta| / t) * t + rem so that every product stays
// below 2^31 (od, rem <= t <= spacing), bit for bit the JAX formula.  JAX's
// `//` is a floor division; `floordiv` keeps that for negative numerators
// (the clipped operands are non-negative on every valid lane, so it costs
// one compare).  Lanes failing the hit gate or the overlap write only
// valid = 0; valid lanes write the requested RESULT_FIELDS rows, with zeros
// for the run-slice and indel fields approximate mode does not compute.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

using namespace impg_lanes;

namespace {
constexpr int kThreads = 256;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

// Tracepoint columns (TorchDeviceIndex.TP_KEYS): per record seg_off, n_seg,
// q_start, q_end; per boundary q_bound, pre_diffs, pre_aligned.
struct Tracepoints {
  const int32_t* seg_off;
  const int32_t* n_seg;
  const int32_t* q_bound;
  const int32_t* pre_diffs;
  const int32_t* pre_aligned;
  const int32_t* q_start;
  const int32_t* q_end;
  int32_t spacing;
};

// Floor division for b > 0 (C's `/` truncates toward zero).
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a < 0 && q * b != a) ? q - 1 : q;
}

// jnp.clip(x, lo, hi) = min(max(x, lo), hi).
__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}
}  // namespace

extern "C" __global__ void impg_k_project_approx(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t lane_base,
    int64_t n_lanes, const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ q_s, const int32_t* __restrict__ q_e,
    int32_t q_base, const int32_t* __restrict__ rec_ts,
    const int32_t* __restrict__ rec_te, const int32_t* __restrict__ rec_qid,
    Tracepoints tp, int clip_overlap, uint32_t field_mask,
    uint8_t* __restrict__ valid_out, int32_t* __restrict__ rows) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;
  const int64_t gl = lane_base + l;
  const int32_t q = lane_query(lane_off, nq, gl);
  const int32_t rec = win_lo[q] + static_cast<int32_t>(gl - lane_off[q]);
  const int32_t qs = q_s[q];
  const int32_t qe = q_e[q];
  const int32_t ts = rec_ts[rec];
  const int32_t te = rec_te[rec];
  // Hit gate, then the transitive walkers' clip (impg.rs:2395-2400).
  const int32_t rs = clip_overlap ? max(qs, ts) : qs;
  const int32_t re = clip_overlap ? min(qe, te) : qe;
  const bool valid = te >= qs && rs < te && re > ts && rs < re;
  valid_out[l] = valid ? 1 : 0;
  if (!valid) return;

  const int64_t off = __ldg(tp.seg_off + rec);
  const int32_t nseg = __ldg(tp.n_seg + rec);
  const int32_t q0 = __ldg(tp.q_start + rec);
  const int32_t q1 = __ldg(tp.q_end + rec);
  const int32_t sp = tp.spacing;
  const int32_t rs_c = clip(rs, ts, te - 1);
  const int32_t re_c = clip(re, ts + 1, te);
  const int32_t i0 = clip(floordiv(rs_c - ts, sp), 0, nseg - 1);
  const int32_t j1 = clip(floordiv(re_c - 1 - ts, sp), 0, nseg - 1);
  const int32_t q_lo = min(q0, q1);
  const int32_t q_hi = max(q0, q1);

  auto boundary = [&](int32_t i) -> int32_t { return min(ts + i * sp, te); };
  // Query position at target position `pos` of segment i.
  auto refine = [&](int32_t i, int32_t pos) -> int32_t {
    const int32_t seg_s = boundary(i);
    const int32_t t_delta = boundary(i + 1) - seg_s;
    const int32_t q_pos = __ldg(tp.q_bound + off + i);
    const int32_t q_delta = __ldg(tp.q_bound + off + i + 1) - q_pos;
    const int32_t t = max(t_delta, 1);
    const int32_t od = pos - seg_s;  // in [0, t_delta]
    const int32_t mag = abs(q_delta);
    const int32_t whole = floordiv(mag, t);
    const int32_t rem = mag - whole * t;
    const int32_t p2 = rem * od;
    const int32_t q2 = floordiv(p2, t);
    const int32_t r2 = p2 - q2 * t;
    const int32_t floor_total = whole * od + q2;
    const int32_t half = 2 * r2;
    const int32_t add = (half > t || (half == t && (floor_total & 1) == 1)) ? 1 : 0;
    const int32_t advance =
        t_delta > 0 ? (q_delta < 0 ? -1 : 1) * (floor_total + add) : 0;
    return clip(q_pos + advance, q_lo, q_hi);
  };
  const int32_t pq_start = refine(i0, max(boundary(i0), rs_c));
  const int32_t pq_end = refine(j1, min(boundary(j1 + 1), re_c));
  const int32_t aligned =
      __ldg(tp.pre_aligned + off + j1 + 1) - __ldg(tp.pre_aligned + off + i0);
  const int32_t diffs =
      __ldg(tp.pre_diffs + off + j1 + 1) - __ldg(tp.pre_diffs + off + i0);

  const uint32_t m = field_mask;
  put(rows, m, kPairRec, n_lanes, l, rec);
  put(rows, m, kPairQ, n_lanes, l, q_base + q);
  put(rows, m, kQueryId, n_lanes, l, rec_qid[rec]);
  put(rows, m, kPqStart, n_lanes, l, pq_start);
  put(rows, m, kPqEnd, n_lanes, l, pq_end);
  put(rows, m, kPtStart, n_lanes, l, rs);
  put(rows, m, kPtEnd, n_lanes, l, re);
  put(rows, m, kMatches, n_lanes, l, max(aligned - diffs, 0));
  put(rows, m, kMismatches, n_lanes, l, diffs);
  put(rows, m, kFirstRun, n_lanes, l, 0);
  put(rows, m, kLastRun, n_lanes, l, 0);
  put(rows, m, kFirstClip, n_lanes, l, 0);
  put(rows, m, kLastRem, n_lanes, l, 0);
  put(rows, m, kICount, n_lanes, l, 0);
  put(rows, m, kDCount, n_lanes, l, 0);
  put(rows, m, kIBp, n_lanes, l, 0);
  put(rows, m, kDBp, n_lanes, l, 0);
}

extern "C" int impg_project_approx(
    const void* lane_off, int32_t nq, int64_t lane_base, int64_t n_lanes,
    const void* win_lo, const void* q_s, const void* q_e, int32_t q_base,
    const void* rec_ts, const void* rec_te, const void* rec_qid,
    const void* seg_off, const void* n_seg, const void* q_bound,
    const void* pre_diffs, const void* pre_aligned, const void* q_start,
    const void* q_end, int32_t spacing, int32_t clip_overlap,
    uint32_t field_mask, void* valid_out, void* rows, void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  Tracepoints tp;
  tp.seg_off = static_cast<const int32_t*>(seg_off);
  tp.n_seg = static_cast<const int32_t*>(n_seg);
  tp.q_bound = static_cast<const int32_t*>(q_bound);
  tp.pre_diffs = static_cast<const int32_t*>(pre_diffs);
  tp.pre_aligned = static_cast<const int32_t*>(pre_aligned);
  tp.q_start = static_cast<const int32_t*>(q_start);
  tp.q_end = static_cast<const int32_t*>(q_end);
  tp.spacing = spacing;
  const unsigned blocks =
      static_cast<unsigned>((n_lanes + kThreads - 1) / kThreads);
  impg_k_project_approx<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lane_off), nq, lane_base, n_lanes,
      static_cast<const int32_t*>(win_lo), static_cast<const int32_t*>(q_s),
      static_cast<const int32_t*>(q_e), q_base,
      static_cast<const int32_t*>(rec_ts), static_cast<const int32_t*>(rec_te),
      static_cast<const int32_t*>(rec_qid), tp, clip_overlap, field_mask,
      static_cast<uint8_t*>(valid_out), static_cast<int32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}
