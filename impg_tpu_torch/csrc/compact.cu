// K-D compact: order-preserving stream compaction of the valid lanes.
//
// Replaces: impg_tpu/query/device.py:pack_result's device compaction
// (jnp.argsort(~valid, stable=True) then a take of the first `cap` lanes of
// every field row), which sorts the whole lane grid to move the hits forward.
//
// Bound on the H100: HBM bandwidth.  The work is one read of the valid bytes
// per pass and one read + one write of each requested field of each hit;
// there is no arithmetic to speak of.
//
// Design: no sort.  Pass 1 (impg_k_compact_count) counts each 1024-lane
// block's valid lanes with __syncthreads_count.  The caller takes a cumsum of
// the block counts (glue, not a kernel).  Pass 2 (impg_k_compact_scatter)
// ranks each valid lane inside its block with a warp ballot + popc and an
// exclusive scan over the block's 32 warp totals, and writes each field of
// the lane to out[row, block_base + rank].  Lane order is kept, so the result
// equals the stable argsort's.  Fields are [n_rows, n_lanes] in and
// [n_rows, n_hits] out, both int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kBlock = 1024;  // lanes per block = threads per block
constexpr int kWarps = kBlock / 32;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;
}  // namespace

extern "C" __global__ void impg_k_compact_count(
    const uint8_t* __restrict__ valid, int64_t n_lanes,
    int32_t* __restrict__ block_cnt) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int v = l < n_lanes ? valid[l] != 0 : 0;
  const int c = __syncthreads_count(v);
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = c;
}

extern "C" __global__ void impg_k_compact_scatter(
    const uint8_t* __restrict__ valid, int64_t n_lanes,
    const int32_t* __restrict__ block_cnt,
    const int64_t* __restrict__ block_incl, const int32_t* __restrict__ rows,
    int32_t n_rows, int64_t n_hits, int32_t* __restrict__ out) {
  __shared__ int32_t warp_base[kWarps];
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool v = l < n_lanes && valid[l] != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, v);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // Exclusive scan of the 32 warp totals, one per lane of warp 0.
    const int32_t total = warp_base[lane];
    int32_t incl = total;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    warp_base[lane] = incl - total;
  }
  __syncthreads();
  if (!v) return;
  const int32_t rank = warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
  const int64_t pos = block_incl[blockIdx.x] - block_cnt[blockIdx.x] + rank;
  for (int32_t r = 0; r < n_rows; ++r) {
    out[static_cast<int64_t>(r) * n_hits + pos] =
        rows[static_cast<int64_t>(r) * n_lanes + l];
  }
}

extern "C" int impg_compact_count(const void* valid, int64_t n_lanes,
                                  void* block_cnt, void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  const unsigned blocks = static_cast<unsigned>((n_lanes + kBlock - 1) / kBlock);
  impg_k_compact_count<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), n_lanes,
      static_cast<int32_t*>(block_cnt));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int impg_compact_scatter(const void* valid, int64_t n_lanes,
                                    const void* block_cnt,
                                    const void* block_incl, const void* rows,
                                    int32_t n_rows, int64_t n_hits, void* out,
                                    void* stream) {
  if (n_lanes == 0 || n_hits == 0) return kNoLaunch;
  const unsigned blocks = static_cast<unsigned>((n_lanes + kBlock - 1) / kBlock);
  impg_k_compact_scatter<<<blocks, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), n_lanes,
      static_cast<const int32_t*>(block_cnt),
      static_cast<const int64_t*>(block_incl),
      static_cast<const int32_t*>(rows), n_rows, n_hits,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
