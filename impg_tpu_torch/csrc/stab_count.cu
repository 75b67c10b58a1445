// K-A stab_count: per-query closed-interval stab counts over directed
// records, counted by two searches a query in the query's target segment.
//
// Replaces: impg_tpu/ops/pallas_stab.py:stab_counts (Pallas body
// _stab_count_kernel), which tests every record tile against every query
// (N x B compares) with all B queries resident in VMEM.  On this card that
// is the wrong amount of work: the records are sorted by (target, t_start)
// and cut into target segments, so a query's count needs a few searches in
// its own segment (BITS-style counting, arXiv 1208.3407).
//
// The function: for query (t, s, e), the number of records with tid == t,
// ts <= e and te >= s.  Inside the segment [o_t, o_{t+1}) of target t:
//   hi = the first record with ts > e (ts ascends within a segment).
//   Two-search count, when s <= e and every record of the index has
//   ts <= te: count = hi - lb, where lb is the first position of the
//   segment's t_end values sorted within the segment (te_sorted) with
//   te >= s.  Every record with te < s has ts <= te < s <= e, so it lies
//   before hi, and the lb records with te < s are exactly the ones before
//   hi that do not count.
//   Any other query (s > e, or an index with some ts > te): lo = the first
//   record whose prefix max of t_end (cummax_te) reaches s.  Records before
//   lo end before s and records from hi on start after e, so the count is
//   the number of te >= s over [lo, hi), counted by the query's warp.  Exact
//   for every input.
// A target outside the segments counts 0.  Segment t is target t, or, when
// `seg_tid` is given (records with arbitrary target ids), the segment whose
// sorted target id equals t, found by a search over seg_tid.
//
// Bound on the H100: latency.  Per query it reads three words, two segment
// offsets and ~2 log2(segment size) probes and writes one count; at a few
// thousand queries the launch and a chain of ~10 dependent loads set the
// time.  Design: one thread per query over a 1-D grid; the two searches
// advance together, each step issuing both probes before either is used,
// so two independent loads are in flight.  A query of the window route is
// then counted by its whole warp (32 records a step, a warp-wide sum), one
// such query at a time.  Nothing is shared between queries, so blocks run
// in any order; no atomics, no staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) impg_k_stab_count(
    const int32_t* __restrict__ tgt_offsets,
    const int32_t* __restrict__ seg_tid, int32_t n_seg,
    const int32_t* __restrict__ t_start, const int32_t* __restrict__ t_end,
    const int32_t* __restrict__ cummax_te,
    const int32_t* __restrict__ te_sorted, int wellformed,
    const int32_t* __restrict__ q_tid, const int32_t* __restrict__ q_s,
    const int32_t* __restrict__ q_e, int32_t n_q, int32_t* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int32_t s = 0, seg = -1;
  int32_t cnt = 0;
  bool window = false;
  int32_t lo = 0, hi = 0;
  if (q < n_q) {
    const int32_t t = q_tid[q];
    s = q_s[q];
    const int32_t e = q_e[q];
    if (seg_tid == nullptr) {
      seg = (t >= 0 && t < n_seg) ? t : -1;
    } else {
      int32_t a = 0, b = n_seg;
      while (a < b) {
        const int32_t mid = a + (b - a) / 2;
        if (seg_tid[mid] >= t) b = mid; else a = mid + 1;
      }
      seg = (a < n_seg && seg_tid[a] == t) ? a : -1;
    }
    if (seg >= 0) {
      const int32_t a = tgt_offsets[seg];
      const int32_t b = tgt_offsets[seg + 1];
      const bool two = wellformed && s <= e;
      const int32_t* __restrict__ ends = two ? te_sorted : cummax_te;
      // h: first ts > e; l: first `ends` >= s, both in [a, b].
      int32_t h0 = a, h1 = b, l0 = a, l1 = b;
      while (h0 < h1 || l0 < l1) {
        const bool ah = h0 < h1;
        const bool al = l0 < l1;
        const int32_t mh = h0 + (h1 - h0) / 2;
        const int32_t ml = l0 + (l1 - l0) / 2;
        const int32_t vh = ah ? __ldg(t_start + mh) : 0;
        const int32_t vl = al ? __ldg(ends + ml) : 0;
        if (ah) {
          if (vh > e) h1 = mh; else h0 = mh + 1;
        }
        if (al) {
          if (vl >= s) l1 = ml; else l0 = ml + 1;
        }
      }
      if (two) {
        cnt = h0 - l0;
      } else {
        window = l0 < h0;
        lo = l0;
        hi = h0;
      }
    }
  }
  // The window route, one query of the warp at a time.
  unsigned pending = __ballot_sync(kFull, window);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int32_t w_lo = __shfl_sync(kFull, lo, src);
    const int32_t w_hi = __shfl_sync(kFull, hi, src);
    const int32_t w_s = __shfl_sync(kFull, s, src);
    int32_t c = 0;
    for (int32_t i = w_lo + lane; i < w_hi; i += 32) {
      c += __ldg(t_end + i) >= w_s ? 1 : 0;
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == src) cnt = c;
  }
  if (q < n_q) out[q] = cnt;
}

extern "C" int impg_stab_count(const void* tgt_offsets, const void* seg_tid,
                               int32_t n_seg, const void* t_start,
                               const void* t_end, const void* cummax_te,
                               const void* te_sorted, int32_t wellformed,
                               const void* q_tid, const void* q_s,
                               const void* q_e, int32_t n_q, void* out,
                               void* stream) {
  if (n_q == 0) return kNoLaunch;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(n_q) + kThreads - 1) / kThreads);
  impg_k_stab_count<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tgt_offsets),
      static_cast<const int32_t*>(seg_tid), n_seg,
      static_cast<const int32_t*>(t_start), static_cast<const int32_t*>(t_end),
      static_cast<const int32_t*>(cummax_te),
      static_cast<const int32_t*>(te_sorted), wellformed,
      static_cast<const int32_t*>(q_tid), static_cast<const int32_t*>(q_s),
      static_cast<const int32_t*>(q_e), n_q, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* impg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
