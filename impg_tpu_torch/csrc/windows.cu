// K-B windows: per-query candidate windows [win_lo, win_lo + k) over the
// target-sorted records.
//
// Replaces: impg_tpu/query/device.py:stab_windows (two jnp `_bisect` loops of
// `window_iters` fixed steps over gathered values).
//
// Bound on the H100: latency.  Each query makes two dependent chains of
// ~log2(records per target) global loads (t_start, then the prefix max of
// t_end); B is a frontier of thousands to a few hundred thousand queries, so
// the kernel is short and its time is a handful of dependent load latencies.
//
// Design: one thread per query and early-exiting binary searches (no padded
// fixed iteration count).  Both searched arrays are sorted within a target's
// segment, so the searches are the same lower bounds as the JAX loops:
//   cut = first m in [0, seg_n) with t_start[seg_lo + m] > q_e
//   lo2 = first m in [0, seg_n) with cummax_te[seg_lo + m] >= q_s
// A query whose tid lies outside [0, n_seqs) gets k = 0 (the tid = -1
// padding convention of the JAX engine).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
}  // namespace

extern "C" __global__ void impg_k_windows(
    const int32_t* __restrict__ tgt_offsets, int32_t n_seqs,
    const int32_t* __restrict__ t_start, const int32_t* __restrict__ cummax_te,
    const int32_t* __restrict__ q_tid, const int32_t* __restrict__ q_s,
    const int32_t* __restrict__ q_e, int32_t n_q,
    int32_t* __restrict__ win_lo, int32_t* __restrict__ k_out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  const int32_t tid = q_tid[q];
  if (tid < 0 || tid >= n_seqs) {
    win_lo[q] = 0;
    k_out[q] = 0;
    return;
  }
  const int32_t seg_lo = tgt_offsets[tid];
  const int32_t seg_n = tgt_offsets[tid + 1] - seg_lo;
  const int32_t s = q_s[q];
  const int32_t e = q_e[q];
  int32_t lo = 0, hi = seg_n;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (t_start[seg_lo + mid] > e) hi = mid; else lo = mid + 1;
  }
  const int32_t cut = lo;
  lo = 0;
  hi = seg_n;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (cummax_te[seg_lo + mid] >= s) hi = mid; else lo = mid + 1;
  }
  win_lo[q] = seg_lo + lo;
  k_out[q] = cut > lo ? cut - lo : 0;
}

extern "C" int impg_windows(const void* tgt_offsets, int32_t n_seqs,
                            const void* t_start, const void* cummax_te,
                            const void* q_tid, const void* q_s,
                            const void* q_e, int32_t n_q, void* win_lo,
                            void* k_out, void* stream) {
  if (n_q == 0) return kNoLaunch;
  const unsigned blocks = static_cast<unsigned>((n_q + kThreads - 1) / kThreads);
  impg_k_windows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tgt_offsets), n_seqs,
      static_cast<const int32_t*>(t_start),
      static_cast<const int32_t*>(cummax_te), static_cast<const int32_t*>(q_tid),
      static_cast<const int32_t*>(q_s), static_cast<const int32_t*>(q_e), n_q,
      static_cast<int32_t*>(win_lo), static_cast<int32_t*>(k_out));
  return static_cast<int>(cudaGetLastError());
}
