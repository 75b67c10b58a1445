// K-B windows: per-query candidate windows [win_lo, win_lo + k) over the
// target-sorted records and the queries' exclusive int64 lane offsets, in
// one launch.
//
// Replaces: impg_tpu/query/device.py:stab_windows (two jnp `_bisect` loops of
// `window_iters` fixed steps over gathered values).  The lane offsets are the
// port's own: the JAX engine pads a [B, k_needed] lane grid, the port
// enumerates exact lanes, so K-C and K-D read each query's first lane from
// `offs` and the host cuts lane chunks from its copy of it.
//
// Bound on the H100: latency.  The function's bytes are a few words a query
// (its three columns in, win_lo, k and its offset out, ~2 log2(seg_n)
// probes); at the frontiers a walk gives it (one to a few tens of thousands
// of queries) that is under a microsecond of HBM time, while one query's
// searches are a chain of dependent global loads, and the carry of the
// offsets across blocks a chain of its own.
//
// Design:
//   * One thread per query, both lower bounds searched in ONE loop: the two
//     chains are independent, so each step issues the t_start probe and the
//     cummax_te probe together and the dependent depth is about
//     log2(seg_n) + 1 loads, not 2 log2(seg_n):
//       cut = first m in [0, seg_n) with t_start[seg_lo + m] > q_e
//       lo2 = first m in [0, seg_n) with cummax_te[seg_lo + m] >= q_s
//     k = max(cut - lo2, 0).  A query whose tid lies outside [0, n_seqs)
//     gets k = 0 (the tid = -1 padding convention of the JAX engine), as
//     does an empty segment.
//   * The offsets in the same launch: a block scan of k in int64, then a
//     single-pass carry across blocks by decoupled look-back.  Each block
//     takes its id from an atomic ticket, so every predecessor has started
//     and the look-back cannot wait on a block that was never scheduled.
//     A status word packs a 2-bit flag (aggregate or inclusive prefix) and
//     a 62-bit value, read and written whole: the sums stay exact past 2^31
//     lanes.  offs[0] = 0 and offs[n_q] is the total.
//   * No memset before the launch: the last block to finish its look-back
//     (a done counter) zeroes the status words, the ticket and the counter,
//     so the scratch is zeroed once when it is allocated and every launch
//     leaves it zeroed for the next one on the same stream.
//   * 128 threads a block.  On an H100, 64, 128 and 256 time the same at a
//     walk's one or two queries; 128 is fastest at ~100 queries and within
//     4% of 256 at the 24,156-query depth-2 frontier (189 blocks on 132
//     SMs, more than one wave).
//   * The entry point can make a depth's whole round trip in one call: the
//     queries' copy up, the launch, the offsets' copy back and the wait, so
//     the host pays one foreign call a depth rather than a chain of tensor
//     operations.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}
}  // namespace

// scratch: [0] the block ticket, [1] the done counter, [2 ...] one status
// word a block.
extern "C" __global__ void __launch_bounds__(kThreads) impg_k_windows_offsets(
    const int32_t* __restrict__ tgt_offsets, int32_t n_seqs,
    const int32_t* __restrict__ t_start, const int32_t* __restrict__ cummax_te,
    const int32_t* __restrict__ q_tid, const int32_t* __restrict__ q_s,
    const int32_t* __restrict__ q_e, int32_t n_q,
    int32_t* __restrict__ win_lo, int32_t* __restrict__ k_out,
    int64_t* __restrict__ offs, unsigned long long* scratch,
    int32_t n_blocks) {
  __shared__ long long s_warp[kWarps];
  __shared__ int32_t s_block;
  __shared__ int32_t s_last;
  unsigned long long* status = scratch + 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    s_block = static_cast<int32_t>(
        atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u));
  }
  __syncthreads();
  const int32_t block = s_block;
  const int64_t q = static_cast<int64_t>(block) * kThreads + tid;

  // The window: both searches interleaved.
  int32_t lo = 0, k = 0;
  if (q < n_q) {
    const int32_t t = q_tid[q];
    if (t >= 0 && t < n_seqs) {
      const int32_t seg_lo = tgt_offsets[t];
      const int32_t seg_n = tgt_offsets[t + 1] - seg_lo;
      const int32_t s = q_s[q];
      const int32_t e = q_e[q];
      const int32_t* ts = t_start + seg_lo;
      const int32_t* te = cummax_te + seg_lo;
      int32_t lo1 = 0, hi1 = seg_n, lo2 = 0, hi2 = seg_n;
      while (lo1 < hi1 || lo2 < hi2) {
        const bool a1 = lo1 < hi1;
        const bool a2 = lo2 < hi2;
        const int32_t m1 = lo1 + ((hi1 - lo1) >> 1);
        const int32_t m2 = lo2 + ((hi2 - lo2) >> 1);
        const int32_t v1 = a1 ? __ldg(ts + m1) : 0;
        const int32_t v2 = a2 ? __ldg(te + m2) : 0;
        if (a1) {
          if (v1 > e) hi1 = m1; else lo1 = m1 + 1;
        }
        if (a2) {
          if (v2 >= s) hi2 = m2; else lo2 = m2 + 1;
        }
      }
      lo = seg_lo + lo2;
      k = lo1 > lo2 ? lo1 - lo2 : 0;
    }
    win_lo[q] = lo;
    k_out[q] = k;
  }

  // Block scan of k (int64); s_warp[w] becomes warp w's exclusive base.
  long long incl = k;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();

  // Warp 0: the block's aggregate, the look-back, the inclusive prefix.
  if (warp == 0) {
    const long long w_total = lane < kWarps ? s_warp[lane] : 0;
    long long w_incl = w_total;
    for (int d = 1; d < kWarps; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, w_incl, d);
      if (lane >= d) w_incl += y;
    }
    const long long agg = __shfl_sync(kFull, w_incl, kWarps - 1);
    long long exclusive = 0;
    if (block == 0) {
      if (lane == 0) {
        atomicExch(status, kFlagPrefix | static_cast<unsigned long long>(agg));
      }
    } else {
      if (lane == 0) {
        atomicExch(status + block,
                   kFlagAggregate | static_cast<unsigned long long>(agg));
      }
      int64_t j = static_cast<int64_t>(block) - 1;  // newest predecessor
      while (true) {
        const int64_t idx = j - lane;
        unsigned long long w = kFlagPrefix;  // before block 0: prefix 0
        do {
          if (idx >= 0) {
            w = *reinterpret_cast<volatile unsigned long long*>(status + idx);
          }
        } while (__any_sync(kFull, (w >> 62) == 0));
        const unsigned prefixed = __ballot_sync(kFull, (w >> 62) == 2);
        const long long v = static_cast<long long>(w & kValueMask);
        if (prefixed) {
          // Lanes before the nearest prefixed block hold aggregates; that
          // block holds its inclusive prefix.
          const int p = __ffs(prefixed) - 1;
          exclusive += warp_sum(lane <= p ? v : 0);
          break;
        }
        exclusive += warp_sum(v);
        j -= 32;
      }
      if (lane == 0) {
        atomicExch(status + block,
                   kFlagPrefix |
                       static_cast<unsigned long long>(exclusive + agg));
      }
    }
    if (lane < kWarps) s_warp[lane] = exclusive + w_incl - w_total;
    if (lane == 0) {
      if (block == n_blocks - 1) offs[n_q] = exclusive + agg;
      __threadfence();
      const unsigned done =
          atomicAdd(reinterpret_cast<unsigned int*>(scratch + 1), 1u);
      s_last = done == static_cast<unsigned>(n_blocks - 1);
    }
  }
  __syncthreads();
  if (q < n_q) offs[q] = s_warp[warp] + incl - k;

  // Every block has finished its look-back: leave the scratch zeroed.
  if (s_last) {
    for (int32_t i = tid; i < n_blocks; i += kThreads) status[i] = 0;
    if (tid == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

// One launch: win_lo, k (int32 [n_q]) and offs (int64 [n_q + 1]).  scratch
// holds scratch_words >= n_blocks + 2 zeroed int64 words and is left zeroed.
// The round trip of an engine's depth, when the host pointers are given
// (pinned memory): q_host's 3 n_q int32 (the q_tid, q_s and q_e rows, back
// to back) are copied up first into the rows that q_tid, q_s and q_e start
// (equally spaced, at least n_q apart, as in a [3, capacity] buffer), and
// after the launch offs (and, with win_lo_host, win_lo) are copied back and
// the stream is synchronised.
extern "C" int impg_windows_offsets(
    const void* tgt_offsets, int32_t n_seqs, const void* t_start,
    const void* cummax_te, void* q_tid, const void* q_s, const void* q_e,
    int32_t n_q, void* win_lo, void* k_out, void* offs, void* scratch,
    int64_t scratch_words, const void* q_host, void* offs_host,
    void* win_lo_host, void* stream) {
  if (n_q == 0) return kNoLaunch;
  const int32_t n_blocks = (n_q + kThreads - 1) / kThreads;
  if (scratch_words < static_cast<int64_t>(n_blocks) + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* qt = static_cast<int32_t*>(q_tid);
  cudaError_t err = cudaSuccess;
  if (q_host != nullptr) {
    const int64_t pitch = static_cast<const int32_t*>(q_s) - qt;
    if (pitch < n_q || static_cast<const int32_t*>(q_e) - qt != 2 * pitch) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t row = sizeof(int32_t) * n_q;
    err = cudaMemcpy2DAsync(qt, sizeof(int32_t) * pitch, q_host, row, row, 3,
                            cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  impg_k_windows_offsets<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(tgt_offsets), n_seqs,
      static_cast<const int32_t*>(t_start),
      static_cast<const int32_t*>(cummax_te), qt,
      static_cast<const int32_t*>(q_s), static_cast<const int32_t*>(q_e), n_q,
      static_cast<int32_t*>(win_lo), static_cast<int32_t*>(k_out),
      static_cast<int64_t*>(offs),
      static_cast<unsigned long long*>(scratch), n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess || offs_host == nullptr) return static_cast<int>(err);
  err = cudaMemcpyAsync(offs_host, offs, sizeof(int64_t) * (n_q + 1),
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess && win_lo_host != nullptr) {
    err = cudaMemcpyAsync(win_lo_host, win_lo, sizeof(int32_t) * n_q,
                          cudaMemcpyDeviceToHost, s);
  }
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}
