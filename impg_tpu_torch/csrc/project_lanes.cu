// K-C project_lanes: exact lane enumeration + hit gate + closed-form
// projection, fused.
//
// Replaces: impg_tpu/query/device.py:_lanes_core with _query_core /
// _slot_core (the dense B x k_max or slot x k_slot lane grids) and
// impg_tpu/ops/projection.py:project_batch (+ _bisect), which XLA runs as
// separate gathers and elementwise passes over the whole padded grid.
//
// Bound on the H100: memory latency.  Each lane makes two dependent binary
// searches over the record's run prefix sums (cum_t) plus ~10-20 scattered
// 4-byte gathers from a multi-GB arena; the arithmetic is a few dozen integer
// ops.  Bytes actually moved are dominated by 32-byte sectors fetched for
// 4-byte values, so occupancy (loads in flight) is what the kernel needs.
//
// Design: one thread per EXACT lane l in [0, sum k).  A thread finds its query
// with an upper-bound search over the int64 lane offsets (the exclusive
// cumsum of the window sizes), and its record as win_lo[q] + (l - off[q]).
// There are no padded lanes and no k_max / cap doubling ladders: the JAX
// grids exist only to bound recompiles.  Every intermediate stays in
// registers; the kernel writes a `valid` byte and, for the requested fields
// only (bit f of `field_mask` = RESULT_FIELDS[f]), one int32 row per field,
// field-major ([n_rows, n_lanes]) so that a warp's stores are contiguous.
// Lanes that fail the hit gate write only valid = 0.  All arithmetic is int32
// like the JAX path; gathers clamp their index into the arena as
// projection.py's `gather` does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

using namespace impg_lanes;

namespace {
constexpr int kThreads = 256;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
constexpr int32_t kLenMask = (1 << 29) - 1;
constexpr int32_t kOpEq = 0, kOpX = 1, kOpI = 2, kOpD = 3, kOpM = 4;

struct Arena {
  const int32_t* runs;
  const int32_t* cum_t;
  const int32_t* cum_q;
  const int32_t* irun_before;
  const int32_t* irun_after;
  const int32_t* cum_match;
  const int32_t* cum_mm;
  const int32_t* cum_icnt;
  const int32_t* cum_dcnt;
  const int32_t* cum_ibp;
  const int32_t* cum_dbp;
  int64_t size;
};

__device__ __forceinline__ int32_t gather(const int32_t* a, int64_t i,
                                          int64_t n) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return __ldg(a + i);
}
}  // namespace

extern "C" __global__ void impg_k_project_lanes(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t lane_base,
    int64_t n_lanes, const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ q_s, const int32_t* __restrict__ q_e,
    int32_t q_base, const int32_t* __restrict__ rec_ts,
    const int32_t* __restrict__ rec_te, const int32_t* __restrict__ rec_strand,
    const int32_t* __restrict__ rec_qid, const int32_t* __restrict__ rec_off,
    const int32_t* __restrict__ rec_cnt, Arena ar, int clip_overlap,
    int with_stats, uint32_t field_mask, uint8_t* __restrict__ valid_out,
    int32_t* __restrict__ rows) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;
  const int64_t gl = lane_base + l;
  const int32_t q = lane_query(lane_off, nq, gl);
  const int32_t rec = win_lo[q] + static_cast<int32_t>(gl - lane_off[q]);
  const int32_t qs = q_s[q];
  const int32_t qe = q_e[q];
  const int32_t ts_rec = rec_ts[rec];
  const int32_t te_rec = rec_te[rec];
  if (!(te_rec >= qs)) {
    valid_out[l] = 0;
    return;
  }
  const int32_t rs = clip_overlap ? max(qs, ts_rec) : qs;
  const int32_t re = clip_overlap ? min(qe, te_rec) : qe;
  const int64_t off = rec_off[rec];
  const int32_t n = rec_cnt[rec];
  const int32_t last_t = min(te_rec, re);
  const int64_t asz = ar.size;

  // Target end of run i (record-relative): next run's start, or the record end.
  auto run_te = [&](int32_t i) -> int32_t {
    const bool has_next = (i + 1) < n;
    const int32_t nxt = gather(ar.cum_t, off + (has_next ? i + 1 : i), asz);
    return has_next ? nxt : te_rec;
  };
  // i0: first run with target end > rs.
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (run_te(mid) > rs) hi = mid; else lo = mid + 1;
  }
  const int32_t i0 = lo;
  // j1: last run with target start < re.
  lo = 0;
  hi = n;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (gather(ar.cum_t, off + mid, asz) >= re) hi = mid; else lo = mid + 1;
  }
  const int32_t j1 = lo - 1;

  const bool has_overlap = (rs < te_rec) && (re > ts_rec) && (n > 0) && (rs < re);
  const int32_t nmax = max(n - 1, 0);
  const int32_t i0c = min(max(i0, 0), nmax);
  const int32_t j1c = min(max(j1, 0), nmax);

  // Boundary insertion-run extension.
  const int32_t ts_i0 = gather(ar.cum_t, off + i0c, asz);
  const int32_t f =
      ts_i0 >= rs ? i0c - gather(ar.irun_before, off + i0c, asz) : i0c;
  const int32_t te_j1 = run_te(j1c);
  const int32_t lr =
      te_j1 <= last_t ? j1c + gather(ar.irun_after, off + j1c, asz) : j1c;

  const int64_t fg = off + f;
  const int64_t lg = off + lr;
  const int32_t run_f = gather(ar.runs, fg, asz);
  const int32_t run_l = gather(ar.runs, lg, asz);
  const int32_t kind_f = (run_f >> 29) & 7;
  const int32_t kind_l = (run_l >> 29) & 7;
  const int32_t len_l = run_l & kLenMask;
  const int32_t ts_f = gather(ar.cum_t, fg, asz);
  const int32_t qs_f = gather(ar.cum_q, fg, asz);
  const int32_t ts_l = gather(ar.cum_t, lg, asz);
  const int32_t qs_l = gather(ar.cum_q, lg, asz);
  const int32_t dir = rec_strand[rec] == 0 ? 1 : -1;

  const bool is_i_f = kind_f == kOpI;
  const bool is_d_f = kind_f == kOpD;
  const int32_t ov_s = max(ts_f, rs);
  const int32_t first_clip = is_i_f ? 0 : ov_s - ts_f;
  const int32_t pt_start = is_i_f ? ts_f : ov_s;
  const int32_t pq_start = (is_i_f || is_d_f) ? qs_f : qs_f + (ov_s - ts_f) * dir;

  const bool is_i_l = kind_l == kOpI;
  const bool is_d_l = kind_l == kOpD;
  const int32_t te_l = ts_l + (is_i_l ? 0 : len_l);
  const int32_t qdelta_l = is_d_l ? 0 : len_l * dir;
  const int32_t ov_e = min(te_l, re);
  const int32_t last_rem = is_i_l ? 0 : ov_e - te_l;
  const int32_t pt_end = is_i_l ? ts_l : ov_e;
  const int32_t pq_end =
      is_i_l ? qs_l + qdelta_l : (is_d_l ? qs_l : qs_l + (ov_e - ts_l) * dir);

  const bool valid = has_overlap && (pq_start != pq_end) &&
                     (pt_start != pt_end) && (f <= lr);
  valid_out[l] = valid ? 1 : 0;
  if (!valid) return;

  const uint32_t m = field_mask;
  put(rows, m, kPairRec, n_lanes, l, rec);
  put(rows, m, kPairQ, n_lanes, l, q_base + q);
  put(rows, m, kQueryId, n_lanes, l, rec_qid[rec]);
  put(rows, m, kPqStart, n_lanes, l, pq_start);
  put(rows, m, kPqEnd, n_lanes, l, pq_end);
  put(rows, m, kPtStart, n_lanes, l, pt_start);
  put(rows, m, kPtEnd, n_lanes, l, pt_end);
  put(rows, m, kFirstRun, n_lanes, l, f);
  put(rows, m, kLastRun, n_lanes, l, lr);
  put(rows, m, kFirstClip, n_lanes, l, first_clip);
  put(rows, m, kLastRem, n_lanes, l, last_rem);
  if (!with_stats) return;

  // Identity statistics of the clipped slice (projection.py:249-271).
  const bool is_match_l = kind_l == kOpEq || kind_l == kOpM;
  const bool is_x_l = kind_l == kOpX;
  const bool is_match_f = kind_f == kOpEq || kind_f == kOpM;
  const bool is_x_f = kind_f == kOpX;
  int32_t matches = gather(ar.cum_match, lg, asz) - gather(ar.cum_match, fg, asz) +
                    (is_match_l ? len_l : 0);
  int32_t mismatches = gather(ar.cum_mm, lg, asz) - gather(ar.cum_mm, fg, asz) +
                       (is_x_l ? len_l : 0);
  const int32_t i_count = gather(ar.cum_icnt, lg, asz) -
                          gather(ar.cum_icnt, fg, asz) + (is_i_l ? 1 : 0);
  const int32_t d_count = gather(ar.cum_dcnt, lg, asz) -
                          gather(ar.cum_dcnt, fg, asz) + (is_d_l ? 1 : 0);
  const int32_t i_bp = gather(ar.cum_ibp, lg, asz) - gather(ar.cum_ibp, fg, asz) +
                       (is_i_l ? len_l : 0);
  int32_t d_bp = gather(ar.cum_dbp, lg, asz) - gather(ar.cum_dbp, fg, asz) +
                 (is_d_l ? len_l : 0);
  matches -= is_match_f ? first_clip : 0;
  mismatches -= is_x_f ? first_clip : 0;
  d_bp -= is_d_f ? first_clip : 0;
  matches += is_match_l ? last_rem : 0;
  mismatches += is_x_l ? last_rem : 0;
  d_bp += is_d_l ? last_rem : 0;
  put(rows, m, kMatches, n_lanes, l, matches);
  put(rows, m, kMismatches, n_lanes, l, mismatches);
  put(rows, m, kICount, n_lanes, l, i_count);
  put(rows, m, kDCount, n_lanes, l, d_count);
  put(rows, m, kIBp, n_lanes, l, i_bp);
  put(rows, m, kDBp, n_lanes, l, d_bp);
}

extern "C" int impg_project_lanes(
    const void* lane_off, int32_t nq, int64_t lane_base, int64_t n_lanes,
    const void* win_lo, const void* q_s, const void* q_e, int32_t q_base,
    const void* rec_ts, const void* rec_te, const void* rec_strand,
    const void* rec_qid, const void* rec_off, const void* rec_cnt,
    const void* runs, const void* cum_t, const void* cum_q,
    const void* irun_before, const void* irun_after, const void* cum_match,
    const void* cum_mm, const void* cum_icnt, const void* cum_dcnt,
    const void* cum_ibp, const void* cum_dbp, int64_t arena_size,
    int32_t clip_overlap, int32_t with_stats, uint32_t field_mask,
    void* valid_out, void* rows, void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  Arena ar;
  ar.runs = static_cast<const int32_t*>(runs);
  ar.cum_t = static_cast<const int32_t*>(cum_t);
  ar.cum_q = static_cast<const int32_t*>(cum_q);
  ar.irun_before = static_cast<const int32_t*>(irun_before);
  ar.irun_after = static_cast<const int32_t*>(irun_after);
  ar.cum_match = static_cast<const int32_t*>(cum_match);
  ar.cum_mm = static_cast<const int32_t*>(cum_mm);
  ar.cum_icnt = static_cast<const int32_t*>(cum_icnt);
  ar.cum_dcnt = static_cast<const int32_t*>(cum_dcnt);
  ar.cum_ibp = static_cast<const int32_t*>(cum_ibp);
  ar.cum_dbp = static_cast<const int32_t*>(cum_dbp);
  ar.size = arena_size;
  const unsigned blocks =
      static_cast<unsigned>((n_lanes + kThreads - 1) / kThreads);
  impg_k_project_lanes<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lane_off), nq, lane_base, n_lanes,
      static_cast<const int32_t*>(win_lo), static_cast<const int32_t*>(q_s),
      static_cast<const int32_t*>(q_e), q_base,
      static_cast<const int32_t*>(rec_ts), static_cast<const int32_t*>(rec_te),
      static_cast<const int32_t*>(rec_strand),
      static_cast<const int32_t*>(rec_qid),
      static_cast<const int32_t*>(rec_off),
      static_cast<const int32_t*>(rec_cnt), ar, clip_overlap, with_stats,
      field_mask, static_cast<uint8_t*>(valid_out),
      static_cast<int32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}
