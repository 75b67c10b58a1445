// K-D compact: order-preserving stream compaction of the valid lanes, one
// launch per lane chunk.
//
// Replaces: impg_tpu/query/device.py:pack_result's device compaction
// (jnp.argsort(~valid, stable=True) then a take of the first `cap` lanes of
// every field row), which sorts the whole lane grid to move the hits forward.
//
// Bound on the H100: HBM bandwidth.  The work is one read of the valid bytes
// and one read + one write of each requested field of each hit; there is no
// arithmetic to speak of.
//
// Design: a single pass with a decoupled look-back, so that no count pass,
// no cumsum and no host round trip sit between counting and scattering.
// Each block takes the next tile of kTile lanes (a tile counter in the
// scratch hands tiles out in block start order, so every tile's predecessors
// are running or done: the look-back cannot wait on a block that has not
// started).  A thread reads its kPerThread valid bytes with one 16-byte load
// and keeps them as a bit mask; a block scan of the threads' popcounts ranks
// them.  The tile then publishes its aggregate in its status word, warp 0
// walks back over the predecessors' words 32 at a time, summing aggregates
// until it meets an inclusive prefix, and publishes its own inclusive
// prefix.  A status word packs flag (2 bits), aggregate (31 bits) and
// inclusive prefix (31 bits) into one 64-bit word, read and written whole,
// so a reader never sees a flag without its value.  Lane counts stay below
// 2^31 (the wrapper's limit).  Finally each thread scatters its lanes
// lane-striped (thread t handles lanes t, t + kThreads, ...: coalesced
// reads), each field row r of a hit going to out[r * n_lanes + rank]: the
// output has the input's row stride, and its first n_hits columns are the
// result.  The last tile writes n_hits to the scratch.  Lane order is kept,
// so the result equals the stable argsort's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // one 16-byte load of valid bytes
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 31) - 1;
constexpr unsigned kFull = 0xffffffffu;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   int32_t aggregate,
                                                   int32_t inclusive) {
  return flag | (static_cast<unsigned long long>(aggregate) << 31) |
         static_cast<unsigned long long>(inclusive);
}

// One bit per nonzero byte of w (bit i for byte i).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}
}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) impg_k_compact(
    const uint8_t* __restrict__ valid, int64_t n_lanes,
    const int32_t* __restrict__ rows, int32_t n_rows,
    int32_t* __restrict__ out, unsigned long long* status,
    unsigned int* tile_counter, int64_t* n_hits, int32_t n_tiles) {
  __shared__ uint16_t s_mask[kThreads];
  __shared__ int32_t s_excl[kThreads];
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_tile;
  __shared__ int32_t s_total;
  __shared__ int32_t s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_tile = static_cast<int32_t>(atomicAdd(tile_counter, 1u));
  __syncthreads();
  const int32_t tile = s_tile;
  const int64_t t0 = static_cast<int64_t>(tile) * kTile;

  // This thread's kPerThread valid bytes as a bit mask.
  const int64_t my0 = t0 + static_cast<int64_t>(tid) * kPerThread;
  uint32_t mask = 0;
  if (my0 + kPerThread <= n_lanes &&
      (reinterpret_cast<uintptr_t>(valid + my0) & 15u) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(valid + my0));
    mask = nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4) |
           (nonzero_bytes(v.z) << 8) | (nonzero_bytes(v.w) << 12);
  } else {
    for (int k = 0; k < kPerThread; ++k) {
      if (my0 + k < n_lanes && valid[my0 + k] != 0) mask |= 1u << k;
    }
  }

  // Block exclusive scan of the threads' counts; s_total is the tile's
  // aggregate.
  const int32_t count = __popc(mask);
  int32_t incl = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t total = lane < kWarps ? s_warp[lane] : 0;
    int32_t w_incl = total;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w_incl, d);
      if (lane >= d) w_incl += y;
    }
    if (lane < kWarps) s_warp[lane] = w_incl - total;
    if (lane == kWarps - 1) s_total = w_incl;
  }
  __syncthreads();
  s_mask[tid] = static_cast<uint16_t>(mask);
  s_excl[tid] = s_warp[warp] + incl - count;

  // Publish the aggregate, look back, publish the inclusive prefix (warp 0).
  if (warp == 0) {
    const int32_t agg = s_total;
    int32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, pack(kFlagPrefix, agg, agg));
    } else {
      if (lane == 0) atomicExch(status + tile, pack(kFlagAggregate, agg, 0));
      int64_t j = static_cast<int64_t>(tile) - 1;  // newest predecessor
      while (true) {
        const int64_t idx = j - lane;
        unsigned long long w;
        do {
          w = idx >= 0
                  ? *reinterpret_cast<volatile unsigned long long*>(status + idx)
                  : pack(kFlagPrefix, 0, 0);
        } while (__any_sync(kFull, (w >> 62) == 0));
        const unsigned prefixed = __ballot_sync(kFull, (w >> 62) == 2);
        const int32_t w_agg = static_cast<int32_t>((w >> 31) & kValueMask);
        const int32_t w_incl = static_cast<int32_t>(w & kValueMask);
        if (prefixed) {
          const int p = __ffs(prefixed) - 1;  // the nearest prefixed tile
          const int32_t part = lane < p ? w_agg : (lane == p ? w_incl : 0);
          exclusive += static_cast<int32_t>(
              __reduce_add_sync(kFull, static_cast<unsigned>(part)));
          break;
        }
        exclusive += static_cast<int32_t>(
            __reduce_add_sync(kFull, static_cast<unsigned>(w_agg)));
        j -= 32;
      }
      if (lane == 0) {
        atomicExch(status + tile,
                   pack(kFlagPrefix, agg, exclusive + agg));
      }
    }
    if (lane == 0) {
      s_base = exclusive;
      if (tile == n_tiles - 1) *n_hits = static_cast<int64_t>(exclusive) + agg;
    }
  }
  __syncthreads();

  // Scatter, lane-striped: lane t0 + k * kThreads + tid.
  const int32_t base = s_base;
  int32_t rank[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int li = k * kThreads + tid;
    const uint32_t m = s_mask[li / kPerThread];
    const int b = li % kPerThread;
    rank[k] = (m >> b) & 1u
                  ? base + s_excl[li / kPerThread] + __popc(m & ((1u << b) - 1u))
                  : -1;
  }
  for (int32_t r = 0; r < n_rows; ++r) {
    const int32_t* src = rows + static_cast<int64_t>(r) * n_lanes + t0 + tid;
    int32_t* dst = out + static_cast<int64_t>(r) * n_lanes;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (rank[k] >= 0) dst[rank[k]] = __ldg(src + k * kThreads);
    }
  }
}

// scratch: n_tiles status words, then the tile counter and n_hits (int64
// each); zeroed here before the launch.
extern "C" int impg_compact(const void* valid, int64_t n_lanes,
                            const void* rows, int32_t n_rows, void* out,
                            void* scratch, void* stream) {
  if (n_lanes == 0) return kNoLaunch;
  const int32_t n_tiles = static_cast<int32_t>((n_lanes + kTile - 1) / kTile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (n_tiles + 2), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  impg_k_compact<<<n_tiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), n_lanes,
      static_cast<const int32_t*>(rows), n_rows, static_cast<int32_t*>(out),
      status, reinterpret_cast<unsigned int*>(status + n_tiles),
      reinterpret_cast<int64_t*>(status + n_tiles + 1), n_tiles);
  return static_cast<int>(cudaGetLastError());
}
