// K-A stab_count: per-query closed-interval stab counts over directed records.
//
// Replaces: impg_tpu/ops/pallas_stab.py:stab_counts (Pallas body
// _stab_count_kernel), which walks 1024-record tiles in sequence with all B
// queries resident in VMEM and carries the counts across grid steps.
//
// Bound on the H100: compare throughput.  Each record tile is read from
// device memory once per block of queries (N * 12 B * ceil(B / 256) bytes in
// all), while the work is N * B three-way compares, so at the sizes of
// `stats -r/-b` the SMs' integer pipes, not HBM, set the time.
//
// Design: a 2-D grid of (record tiles) x (query blocks).  Blocks run in
// parallel and in no order, so nothing carries across them as it does in the
// TPU grid: each block stages one tile of (tid, ts, te) in shared memory
// (12 KB), every thread counts its own query's hits against the tile (all
// threads read the same shared word: a broadcast, no bank conflicts), and
// adds its count into out[q] with an integer atomic.  Integer addition is
// associative, so the result does not depend on block order.  Records come
// unpadded: the last tile masks its ragged edge itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kTile = 1024;
constexpr int kThreads = 256;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
}  // namespace

extern "C" __global__ void impg_k_stab_count(
    const int32_t* __restrict__ rec_tid, const int32_t* __restrict__ rec_ts,
    const int32_t* __restrict__ rec_te, int64_t n_rec,
    const int32_t* __restrict__ q_tid, const int32_t* __restrict__ q_s,
    const int32_t* __restrict__ q_e, int32_t n_q, int32_t* __restrict__ out) {
  __shared__ int32_t s_tid[kTile];
  __shared__ int32_t s_ts[kTile];
  __shared__ int32_t s_te[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t left = n_rec - base;
  const int n = left < kTile ? static_cast<int>(left) : kTile;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_tid[i] = rec_tid[base + i];
    s_ts[i] = rec_ts[base + i];
    s_te[i] = rec_te[base + i];
  }
  __syncthreads();
  const int64_t q = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  const int32_t t = q_tid[q];
  const int32_t s = q_s[q];
  const int32_t e = q_e[q];
  int32_t cnt = 0;
  for (int i = 0; i < n; ++i) {
    cnt += (s_tid[i] == t) & (s_ts[i] <= e) & (s_te[i] >= s);
  }
  if (cnt) atomicAdd(out + q, cnt);
}

extern "C" int impg_stab_count(const void* rec_tid, const void* rec_ts,
                               const void* rec_te, int64_t n_rec,
                               const void* q_tid, const void* q_s,
                               const void* q_e, int32_t n_q, void* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * n_q, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_q == 0 || n_rec == 0) return kNoLaunch;
  const dim3 grid(static_cast<unsigned>((n_rec + kTile - 1) / kTile),
                  static_cast<unsigned>((n_q + kThreads - 1) / kThreads));
  impg_k_stab_count<<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(rec_tid), static_cast<const int32_t*>(rec_ts),
      static_cast<const int32_t*>(rec_te), n_rec,
      static_cast<const int32_t*>(q_tid), static_cast<const int32_t*>(q_s),
      static_cast<const int32_t*>(q_e), n_q, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* impg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
