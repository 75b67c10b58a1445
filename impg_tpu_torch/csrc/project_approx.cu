// K-E project_approx: exact lane enumeration + hit gate + tracepoint
// (approximate) projection, fused.
//
// Replaces: impg_tpu/query/device.py:_project_approx_device, reached through
// _lanes_core's `tp is not None` branch over the dense B x k_max or
// slot x k_slot lane grids of _query_core / _slot_core.
//
// Bound on the H100: memory latency and sectors.  A lane finds its query,
// then its record's t_start and t_end; a valid lane reads its record's four
// tracepoint words and the boundary rows at its first and last segments,
// scattered across a table of ~140 M boundaries (1.7 GB); the arithmetic is
// some fifty integer ops.  What sets the time is the chain of dependent
// loads, the sectors the scattered loads touch and the sectors the row
// stores fill, not the bytes the function needs.
//
// Design, per block of kThreads threads and a tile of kTile consecutive
// exact lanes (lane l of the chunk is absolute lane lane_base + l):
//   1. Query per tile, as lanes.cuh sets out (K-C's `stage_tile` and
//      `tile_lane_query`): a lane finds its query by a short search over
//      lane offsets staged in shared memory, not by a ~15-step search over
//      global memory.
//   2. The gate first: every lane reads its record's t_start and t_end and
//      writes its valid byte; approximate mode has no later test, so a lane
//      is valid exactly when it passes the hit gate with a non-empty
//      clipped range.  Only valid lanes make the tracepoint loads.  K-C's
//      work list is not used here: with no search chain after the gate, a
//      full warp gains little, while the list scatters each warp's row
//      stores over the tile, and partly filled sectors cost more than idle
//      lanes (measured on the H100: 0.2153 ms with the list, 0.1770
//      without, lean rows of one 3.9 M-lane chunk).
//   3. Whole-sector stores.  Every lane stores every requested row (an
//      invalid lane's rows are never read, and zeros stand for the fields
//      approximate mode does not compute), so each store of a warp fills
//      whole 32-byte sectors.
//   4. Fewer sectors per load.  The tracepoint columns come interleaved
//      (query/device.py:tracepoint_tensors): seg_off, n_seg, q_start and
//      q_end of a record side by side, one 16-byte load; q_bound, pre_diffs
//      and pre_aligned of a boundary side by side in 12-byte rows, so rows
//      i0, i0 + 1 and j1, j1 + 1 (the eight values a lane needs) touch two
//      to four 32-byte sectors where seven separate arrays cost about ten.
//      All eight loads are independent and issue together.
//   5. The arithmetic of ops/approx.py, unchanged.  The segment of a
//      position is O(1) arithmetic; the query offset inside a segment is
//      od * q_delta / t rounded half to even in exact int32 integers, with
//      |q_delta| split as (|q_delta| / t) * t + rem so that every product
//      stays below 2^31 (od, rem <= t <= spacing), bit for bit the JAX
//      formula.  JAX's `//` is a floor division; `floordiv` keeps that for
//      negative numerators.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

using namespace impg_lanes;

namespace {
constexpr int kThreads = 128;
constexpr int kLanesPerThread = 2;
constexpr int kTile = kThreads * kLanesPerThread;
// Lane offsets staged per tile: queries [q_first, q_first + kStage).
constexpr int kStage = 64;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

struct Tracepoints {
  // seg_off, n_seg, q_start, q_end of each record, interleaved [n_rec, 4].
  const int4* rec4;
  // q_bound, pre_diffs, pre_aligned of each boundary, interleaved
  // [n_bound, 3].
  const int32_t* bound3;
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

// Query position at target position `pos` of the segment that starts at
// seg_s and spans t_delta, whose boundaries sit at q_pos and q_next.
__device__ __forceinline__ int32_t refine(int32_t seg_s, int32_t t_delta,
                                          int32_t q_pos, int32_t q_next,
                                          int32_t pos, int32_t q_lo,
                                          int32_t q_hi) {
  const int32_t q_delta = q_next - q_pos;
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
  const int32_t add =
      (half > t || (half == t && (floor_total & 1) == 1)) ? 1 : 0;
  const int32_t advance =
      t_delta > 0 ? (q_delta < 0 ? -1 : 1) * (floor_total + add) : 0;
  return clip(q_pos + advance, q_lo, q_hi);
}

// The fields approximate mode does not compute: zero on every lane.
constexpr uint32_t kZeroFields =
    (1u << kFirstRun) | (1u << kLastRun) | (1u << kFirstClip) |
    (1u << kLastRem) | (1u << kICount) | (1u << kDCount) | (1u << kIBp) |
    (1u << kDBp);

// What a valid lane computes.
struct Approx {
  int32_t pq_start, pq_end, matches, mismatches;
};

// Steps 3-4 for a valid lane over record rec (spanning [ts, te)) with the
// clipped range [rs, re): the tracepoint loads and the arithmetic.
__device__ __forceinline__ Approx project(const Tracepoints& tp, int32_t rec,
                                         int32_t rs, int32_t re, int32_t ts,
                                         int32_t te) {
  const int32_t sp = tp.spacing;
  const int4 r4 = __ldg(tp.rec4 + rec);  // seg_off, n_seg, q_start, q_end
  const int64_t off = r4.x;
  const int32_t nseg = r4.y;
  const int32_t q_lo = min(r4.z, r4.w);
  const int32_t q_hi = max(r4.z, r4.w);
  const int32_t rs_c = clip(rs, ts, te - 1);
  const int32_t re_c = clip(re, ts + 1, te);
  const int32_t i0 = clip(floordiv(rs_c - ts, sp), 0, nseg - 1);
  const int32_t j1 = clip(floordiv(re_c - 1 - ts, sp), 0, nseg - 1);
  // Rows i0, i0 + 1 and j1, j1 + 1: (q_bound, pre_diffs, pre_aligned).
  const int32_t* b0 = tp.bound3 + (off + i0) * 3;
  const int32_t* b1 = tp.bound3 + (off + j1) * 3;
  const int32_t qb_i0 = __ldg(b0), pd_i0 = __ldg(b0 + 1);
  const int32_t pa_i0 = __ldg(b0 + 2), qb_i0n = __ldg(b0 + 3);
  const int32_t qb_j1 = __ldg(b1), qb_j1n = __ldg(b1 + 3);
  const int32_t pd_j1n = __ldg(b1 + 4), pa_j1n = __ldg(b1 + 5);

  // Segment i spans [min(ts + i * sp, te), min(ts + (i + 1) * sp, te)).
  const int32_t s_i0 = min(ts + i0 * sp, te);
  const int32_t e_i0 = min(ts + (i0 + 1) * sp, te);
  const int32_t s_j1 = min(ts + j1 * sp, te);
  const int32_t e_j1 = min(ts + (j1 + 1) * sp, te);
  const int32_t aligned = pa_j1n - pa_i0;
  const int32_t diffs = pd_j1n - pd_i0;
  return Approx{
      refine(s_i0, e_i0 - s_i0, qb_i0, qb_i0n, max(s_i0, rs_c), q_lo, q_hi),
      refine(s_j1, e_j1 - s_j1, qb_j1, qb_j1n, min(e_j1, re_c), q_lo, q_hi),
      max(aligned - diffs, 0), diffs};
}
}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) impg_k_project_approx(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t lane_base,
    int64_t n_lanes, const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ q_s, const int32_t* __restrict__ q_e,
    int32_t q_base, const int32_t* __restrict__ rec_ts,
    const int32_t* __restrict__ rec_te, const int32_t* __restrict__ rec_qid,
    Tracepoints tp, int clip_overlap, uint32_t field_mask,
    uint8_t* __restrict__ valid_out, int32_t* __restrict__ rows) {
  __shared__ Tile<kStage> tile;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t tile_end = min(tile0 + kTile, n_lanes);
  stage_tile(tile, lane_off, nq, lane_base, tile0, tile_end);

  const uint32_t m = field_mask;
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int64_t l = tile0 + j * kThreads + threadIdx.x;
    if (l >= tile_end) continue;
    // 1-2. The lane's query, record and hit gate.
    const int64_t gl = lane_base + l;
    int64_t q_off;
    const int32_t q = tile_lane_query(tile, lane_off, gl, &q_off);
    const int32_t rec = win_lo[q] + static_cast<int32_t>(gl - q_off);
    const int32_t qs = q_s[q];
    const int32_t qe = q_e[q];
    const int32_t ts = rec_ts[rec];
    const int32_t te = rec_te[rec];
    // Hit gate, then the transitive walkers' clip (impg.rs:2395-2400).
    const int32_t rs = clip_overlap ? max(qs, ts) : qs;
    const int32_t re = clip_overlap ? min(qe, te) : qe;
    const bool valid = te >= qs && rs < te && re > ts && rs < re;
    valid_out[l] = valid ? 1 : 0;

    // 4-5. Only a valid lane makes the tracepoint loads.
    Approx a{0, 0, 0, 0};
    int32_t qid = 0;
    if (valid) {
      a = project(tp, rec, rs, re, ts, te);
      if ((m >> kQueryId) & 1u) qid = rec_qid[rec];
    }
    // 3. Every lane stores every requested row.
    put(rows, m, kPairRec, n_lanes, l, rec);
    put(rows, m, kPairQ, n_lanes, l, q_base + q);
    put(rows, m, kQueryId, n_lanes, l, qid);
    put(rows, m, kPqStart, n_lanes, l, a.pq_start);
    put(rows, m, kPqEnd, n_lanes, l, a.pq_end);
    put(rows, m, kPtStart, n_lanes, l, rs);
    put(rows, m, kPtEnd, n_lanes, l, re);
    put(rows, m, kMatches, n_lanes, l, a.matches);
    put(rows, m, kMismatches, n_lanes, l, a.mismatches);
    for (uint32_t b = m & kZeroFields; b; b &= b - 1) {
      put(rows, m, __ffs(b) - 1, n_lanes, l, 0);
    }
  }
}

extern "C" int impg_project_approx(
    const void* lane_off, int32_t nq, int64_t lane_base, int64_t n_lanes,
    const void* win_lo, const void* q_s, const void* q_e, int32_t q_base,
    const void* rec_ts, const void* rec_te, const void* rec_qid,
    const void* tp_rec4, const void* tp_bound3, int32_t spacing,
    int32_t clip_overlap, uint32_t field_mask, void* valid_out, void* rows,
    void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  Tracepoints tp;
  tp.rec4 = static_cast<const int4*>(tp_rec4);
  tp.bound3 = static_cast<const int32_t*>(tp_bound3);
  tp.spacing = spacing;
  const unsigned blocks = static_cast<unsigned>((n_lanes + kTile - 1) / kTile);
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
