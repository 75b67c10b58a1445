// K-C project_lanes: exact lane enumeration + hit gate + closed-form
// projection, fused.
//
// Replaces: impg_tpu/query/device.py:_lanes_core with _query_core /
// _slot_core (the dense B x k_max or slot x k_slot lane grids) and
// impg_tpu/ops/projection.py:project_batch (+ _bisect), which XLA runs as
// separate gathers and elementwise passes over the whole padded grid.
//
// Bound on the H100: memory latency.  A lane that passes the hit gate
// searches its record's run prefix sums (cum_t, ~500 runs a record) for the
// first and the last run of the range, then makes ~10-20 scattered 4-byte
// gathers from a multi-GB arena; the arithmetic is a few dozen integer ops.
// What sets the time is the chain of dependent loads of each lane and the
// number of distinct 32-byte sectors its scattered gathers touch, not the
// bytes the function needs.
//
// Design, per block of kThreads threads and a tile of kTile consecutive
// exact lanes (lane l of the chunk is absolute lane lane_base + l):
//   1-2. Query per tile, then the hit gate and a work list, as lanes.cuh
//      sets out.  A lane fails when it misses the hit gate (t_end >= q_s)
//      or has no overlap to project (the clipped range is empty, or the
//      record has no runs), and then writes only valid = 0, since such a
//      lane is never valid.  A query owns ~160 consecutive lanes, so a tile
//      spans a few and its offsets are staged.
//   3. Shorter search chains.  i0 (the first run whose target end passes
//      rs) and K = j1 + 1 (the first run whose target start reaches re) are
//      found together: each step issues one load for each search, so two
//      independent loads are in flight.  Each search starts from an
//      interpolation of its coordinate over [t_start, t_end] across the
//      record's n runs, gallops away from it with a step that doubles up to
//      kMaxStep, then bisects the bracket.  K's lower bound follows i0's
//      (K >= i0: every run before i0 ends at or before rs < re).  On a
//      listed lane both predicates are monotone (cum_t rises within a
//      record, and run i0's predicate at the last run is t_end > rs, which
//      the overlap test guarantees), so any correct search returns the one
//      lower bound that the JAX path's bisection returns.
//   4. Fewer sectors per boundary.  The arena comes interleaved
//      (query/device.py:arena_tensors): cum_t alone for the searches, then
//      runs, cum_q and the two I-run counts of a run side by side, one
//      16-byte load, and the six identity-stats prefixes side by side,
//      three 8-byte loads, where separate arrays cost a 32-byte sector for
//      each value.
//   5. The closed-form boundary arithmetic of ops/projection.py, then the
//      requested rows (bit f of `field_mask` = RESULT_FIELDS[f]), one int32
//      row per field, field-major ([n_rows, n_lanes]).  All arithmetic is
//      int32 like the JAX path; gathers clamp their index into the arena as
//      projection.py's `gather` does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

using namespace impg_lanes;

namespace {
constexpr int kThreads = 256;
constexpr int kLanesPerThread = 2;
constexpr int kTile = kThreads * kLanesPerThread;
// Lane offsets staged per tile: queries [q_first, q_first + kStage).
constexpr int kStage = 64;
constexpr int32_t kMaxStep = 64;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
constexpr int32_t kLenMask = (1 << 29) - 1;
constexpr int32_t kOpEq = 0, kOpX = 1, kOpI = 2, kOpD = 3, kOpM = 4;

struct Arena {
  const int32_t* cum_t;
  // runs, cum_q, irun_before, irun_after of each run, interleaved [size, 4]
  // (query/device.py:arena_tensors): one 16-byte load at a boundary run.
  const int32_t* run4;
  // The six identity-stats prefixes interleaved, [size, 6]: cum_match,
  // cum_mm, cum_icnt, cum_dcnt, cum_ibp, cum_dbp.
  const int32_t* stats;
  int64_t size;
};

// runs, cum_q, irun_before, irun_after of run i (clamped like `gather`).
__device__ __forceinline__ int4 run_at(const int32_t* run4, int64_t i,
                                       int64_t n) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return __ldg(reinterpret_cast<const int4*>(run4) + i);
}

// The six stats of run i (clamped like `gather`), as three 8-byte loads: a
// row starts at 24 * i bytes, so it is 8-byte aligned.
struct Stats {
  int32_t match, mm, icnt, dcnt, ibp, dbp;
};
__device__ __forceinline__ Stats stats_at(const int32_t* stats, int64_t i,
                                          int64_t n) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  const int2* p = reinterpret_cast<const int2*>(stats + i * 6);
  const int2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return Stats{a.x, a.y, b.x, b.y, c.x, c.y};
}

__device__ __forceinline__ int32_t gather(const int32_t* a, int64_t i,
                                          int64_t n) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return __ldg(a + i);
}

// Lower bound of a monotone predicate: the answer lies in [lo, hi], where
// hi is known true (or the end).  The first probe is the seed, then a
// gallop away from it in the direction its outcome points, the step
// doubling up to kMaxStep, then bisection of the bracket.
struct LowerBound {
  int32_t lo, hi;
  int32_t seed;
  int32_t step;  // -1: probe the seed; > 0: galloping; 0: bisecting
  bool down;     // gallop direction: toward lo when the seed was true

  __device__ __forceinline__ bool done() const { return lo >= hi; }

  __device__ __forceinline__ int32_t probe() const {
    int32_t x;
    if (step < 0) {
      x = seed;
    } else if (step == 0) {
      x = lo + (hi - lo) / 2;
    } else {
      x = down ? hi - step : lo + step - 1;
    }
    return min(max(x, lo), hi - 1);
  }

  __device__ __forceinline__ void update(int32_t x, bool p) {
    if (p) hi = x; else lo = x + 1;
    if (step < 0) {
      down = p;
      step = 1;
    } else if (step > 0) {
      // Gallop on while the probe keeps landing on the same side.
      step = (p == down && step < kMaxStep) ? step << 1 : 0;
    }
  }
};

// seed = (x - ts) * n / span clamped to [lo, hi - 1] (the interpolated run).
__device__ __forceinline__ int32_t interpolate(int32_t x, int32_t ts,
                                               int32_t span, int32_t n,
                                               int32_t lo, int32_t hi) {
  const int64_t g =
      span > 0 ? (static_cast<int64_t>(x) - ts) * n / span : 0;
  return static_cast<int32_t>(
      min(max(g, static_cast<int64_t>(lo)), static_cast<int64_t>(hi) - 1));
}

// A lane of the work list.
struct Work {
  int32_t l, q, rec, rs, re, ts, te, n, off;
};
}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) impg_k_project_lanes(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t lane_base,
    int64_t n_lanes, const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ q_s, const int32_t* __restrict__ q_e,
    int32_t q_base, const int32_t* __restrict__ rec_ts,
    const int32_t* __restrict__ rec_te, const int32_t* __restrict__ rec_strand,
    const int32_t* __restrict__ rec_qid, const int32_t* __restrict__ rec_off,
    const int32_t* __restrict__ rec_cnt, Arena ar, int clip_overlap,
    int with_stats, uint32_t field_mask, uint8_t* __restrict__ valid_out,
    int32_t* __restrict__ rows) {
  __shared__ Tile<kStage> tile;
  __shared__ int32_t w_l[kTile], w_q[kTile], w_rec[kTile], w_rs[kTile],
      w_re[kTile], w_ts[kTile], w_te[kTile], w_n[kTile], w_off[kTile];
  const int tid = threadIdx.x;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t tile_end = min(tile0 + kTile, n_lanes);
  stage_tile(tile, lane_off, nq, lane_base, tile0, tile_end);

  // Gate each lane; list the ones left to project.
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int64_t l = tile0 + j * kThreads + tid;
    bool listed = false;
    Work w;
    if (l < tile_end) {
      const int64_t gl = lane_base + l;
      int64_t q_off;
      w.q = tile_lane_query(tile, lane_off, gl, &q_off);
      w.l = static_cast<int32_t>(l);
      w.rec = win_lo[w.q] + static_cast<int32_t>(gl - q_off);
      const int32_t qs = q_s[w.q];
      const int32_t qe = q_e[w.q];
      w.ts = rec_ts[w.rec];
      w.te = rec_te[w.rec];
      w.n = rec_cnt[w.rec];
      w.off = rec_off[w.rec];
      w.rs = clip_overlap ? max(qs, w.ts) : qs;
      w.re = clip_overlap ? min(qe, w.te) : qe;
      // The hit gate, then has_overlap of the projection: a lane failing
      // either is not valid.
      listed = w.te >= qs && w.rs < w.te && w.re > w.ts && w.n > 0 &&
               w.rs < w.re;
      if (!listed) valid_out[l] = 0;
    }
    const int32_t slot = list_slot(listed, &tile.count);
    if (listed) {
      w_l[slot] = w.l;
      w_q[slot] = w.q;
      w_rec[slot] = w.rec;
      w_rs[slot] = w.rs;
      w_re[slot] = w.re;
      w_ts[slot] = w.ts;
      w_te[slot] = w.te;
      w_n[slot] = w.n;
      w_off[slot] = w.off;
    }
  }
  __syncthreads();

  // 3-5. Project the listed lanes.
  const int32_t count = tile.count;
  const int64_t asz = ar.size;
  for (int32_t i = tid; i < count; i += kThreads) {
    const int64_t l = w_l[i];
    const int32_t q = w_q[i];
    const int32_t rec = w_rec[i];
    const int32_t rs = w_rs[i];
    const int32_t re = w_re[i];
    const int32_t ts_rec = w_ts[i];
    const int32_t te_rec = w_te[i];
    const int32_t n = w_n[i];
    const int64_t off = w_off[i];
    const int32_t last_t = min(te_rec, re);
    const int32_t span = te_rec - ts_rec;

    // i0: first run with target end > rs; its predicate is true at n - 1
    // (target end t_end > rs), so i0 lies in [0, n - 1].  K = j1 + 1: first
    // run with target start >= re, in [0, n] (n: none).
    LowerBound s0{0, n - 1, interpolate(rs, ts_rec, span, n, 0, n - 1), -1,
                  false};
    LowerBound s1{0, n, interpolate(re, ts_rec, span, n, 0, n), -1, false};
    while (!(s0.done() && s1.done())) {
      const bool a0 = !s0.done();
      const bool a1 = !s1.done();
      const int32_t x0 = a0 ? s0.probe() : 0;
      const int32_t x1 = a1 ? s1.probe() : 0;
      // run_te(x0) = cum_t[x0 + 1], as x0 < n - 1 (has_next).
      const int32_t v0 = a0 ? gather(ar.cum_t, off + x0 + 1, asz) : 0;
      const int32_t v1 = a1 ? gather(ar.cum_t, off + x1, asz) : 0;
      if (a0) s0.update(x0, v0 > rs);
      if (a1) s1.update(x1, v1 >= re);
      s1.lo = max(s1.lo, s0.lo);
    }
    const int32_t i0 = s0.lo;
    const int32_t j1 = s1.lo - 1;

    const int32_t nmax = n - 1;
    const int32_t i0c = min(max(i0, 0), nmax);
    const int32_t j1c = min(max(j1, 0), nmax);

    // Boundary insertion-run extension.  One 16-byte load at i0c (and at
    // j1c) brings the I-run count and, when the boundary does not move,
    // the run and its query position too.
    const int32_t ts_i0 = gather(ar.cum_t, off + i0c, asz);
    const bool j_next = (j1c + 1) < n;  // run_te's has_next rule
    const int32_t te_j1 =
        j_next ? gather(ar.cum_t, off + j1c + 1, asz) : te_rec;
    const int4 at_i0 = run_at(ar.run4, off + i0c, asz);
    const int4 at_j1 = run_at(ar.run4, off + j1c, asz);
    const int32_t f = ts_i0 >= rs ? i0c - at_i0.z : i0c;
    const int32_t lr = te_j1 <= last_t ? j1c + at_j1.w : j1c;

    const int64_t fg = off + f;
    const int64_t lg = off + lr;
    const int4 at_f = f == i0c ? at_i0 : run_at(ar.run4, fg, asz);
    const int4 at_l = lr == j1c ? at_j1 : run_at(ar.run4, lg, asz);
    const int32_t run_f = at_f.x;
    const int32_t run_l = at_l.x;
    const int32_t qs_f = at_f.y;
    const int32_t qs_l = at_l.y;
    const int32_t ts_f = f == i0c ? ts_i0 : gather(ar.cum_t, fg, asz);
    const int32_t ts_l = gather(ar.cum_t, lg, asz);
    const int32_t kind_f = (run_f >> 29) & 7;
    const int32_t kind_l = (run_l >> 29) & 7;
    const int32_t len_l = run_l & kLenMask;
    const int32_t dir = rec_strand[rec] == 0 ? 1 : -1;

    const bool is_i_f = kind_f == kOpI;
    const bool is_d_f = kind_f == kOpD;
    const int32_t ov_s = max(ts_f, rs);
    const int32_t first_clip = is_i_f ? 0 : ov_s - ts_f;
    const int32_t pt_start = is_i_f ? ts_f : ov_s;
    const int32_t pq_start =
        (is_i_f || is_d_f) ? qs_f : qs_f + (ov_s - ts_f) * dir;

    const bool is_i_l = kind_l == kOpI;
    const bool is_d_l = kind_l == kOpD;
    const int32_t te_l = ts_l + (is_i_l ? 0 : len_l);
    const int32_t qdelta_l = is_d_l ? 0 : len_l * dir;
    const int32_t ov_e = min(te_l, re);
    const int32_t last_rem = is_i_l ? 0 : ov_e - te_l;
    const int32_t pt_end = is_i_l ? ts_l : ov_e;
    const int32_t pq_end =
        is_i_l ? qs_l + qdelta_l : (is_d_l ? qs_l : qs_l + (ov_e - ts_l) * dir);

    // has_overlap held for every listed lane.
    const bool valid = (pq_start != pq_end) && (pt_start != pt_end) && (f <= lr);
    valid_out[l] = valid ? 1 : 0;
    if (!valid) continue;

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
    if (!with_stats) continue;

    // Identity statistics of the clipped slice (projection.py:249-271).
    const bool is_match_l = kind_l == kOpEq || kind_l == kOpM;
    const bool is_x_l = kind_l == kOpX;
    const bool is_match_f = kind_f == kOpEq || kind_f == kOpM;
    const bool is_x_f = kind_f == kOpX;
    const Stats sl = stats_at(ar.stats, lg, asz);
    const Stats sf = stats_at(ar.stats, fg, asz);
    int32_t matches = sl.match - sf.match + (is_match_l ? len_l : 0);
    int32_t mismatches = sl.mm - sf.mm + (is_x_l ? len_l : 0);
    const int32_t i_count = sl.icnt - sf.icnt + (is_i_l ? 1 : 0);
    const int32_t d_count = sl.dcnt - sf.dcnt + (is_d_l ? 1 : 0);
    const int32_t i_bp = sl.ibp - sf.ibp + (is_i_l ? len_l : 0);
    int32_t d_bp = sl.dbp - sf.dbp + (is_d_l ? len_l : 0);
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
}

extern "C" int impg_project_lanes(
    const void* lane_off, int32_t nq, int64_t lane_base, int64_t n_lanes,
    const void* win_lo, const void* q_s, const void* q_e, int32_t q_base,
    const void* rec_ts, const void* rec_te, const void* rec_strand,
    const void* rec_qid, const void* rec_off, const void* rec_cnt,
    const void* cum_t, const void* run4, const void* stats,
    int64_t arena_size, int32_t clip_overlap, int32_t with_stats,
    uint32_t field_mask, void* valid_out, void* rows, void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  Arena ar;
  ar.cum_t = static_cast<const int32_t*>(cum_t);
  ar.run4 = static_cast<const int32_t*>(run4);
  ar.stats = static_cast<const int32_t*>(stats);
  ar.size = arena_size;
  const unsigned blocks = static_cast<unsigned>((n_lanes + kTile - 1) / kTile);
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
