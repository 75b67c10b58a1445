// Lane code shared by the lane kernels, K-C (project_lanes.cu) and K-E
// (project_approx.cu): the query of an exact lane, found per tile of lanes,
// K-C's work list of the lanes that pass the hit gate, and the field-major
// store of one result field.
//
// A batch of nq queries owns sum(k) exact lanes; lane_off is the int64
// exclusive cumsum of the window sizes k ([nq + 1], absolute lane numbers).
// Lane gl belongs to the last query q whose lane_off[q] <= gl and to record
// win_lo[q] + (gl - lane_off[q]), so lanes run query-major and, within a
// query, in ascending record order: the JAX engine's hit order.
//
// Both kernels run a block over a tile of consecutive lanes.  Query per
// tile (`stage_tile`): warps 0 and 1 find the queries of the tile's first
// and last lanes with one 32-way search each over the lane offsets; the
// offsets between them are staged in shared memory, where each lane finds
// its query with a short search (`tile_lane_query`).  A tile that spans
// more queries than the stage holds searches that range in global memory
// instead.  K-C then gates every lane and lists the ones that pass in
// shared memory (`list_slot`: one warp ballot and one shared atomic a
// warp), so that its run searches run on full warps; K-E projects in place
// (project_approx.cu says why).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace impg_lanes {

constexpr unsigned kFull = 0xffffffffu;

// RESULT_FIELDS order (impg_tpu/query/device.py).
enum Field {
  kPairRec = 0, kPairQ, kValid, kQueryId, kPqStart, kPqEnd, kPtStart, kPtEnd,
  kFirstRun, kLastRun, kFirstClip, kLastRem, kMatches, kMismatches, kICount,
  kDCount, kIBp, kDBp,
};

// The query owning absolute lane gl, by a whole warp: a 32-way search, each
// round probing 32 evenly spaced offsets and keeping the bracket of the
// first one past gl, so ~3 dependent rounds where a bisection takes ~15.
// Every lane of the warp returns the answer.
__device__ __forceinline__ int32_t warp_lane_query(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t gl, int lane) {
  int32_t lo = 0, hi = nq;  // first index with offset > gl is in [lo, hi]
  while (lo < hi) {
    const int32_t stride = (hi - lo + 31) / 32;
    const int32_t p = lo + lane * stride;
    // A probe at or beyond hi is past the answer without a load.
    const unsigned ballot = __ballot_sync(kFull, p >= hi || lane_off[p] > gl);
    const int f = __ffs(ballot) - 1;  // first probe at or past the answer
    if (f < 0) {
      lo = lo + 31 * stride + 1;
    } else if (f == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + f * stride);
      lo = lo + (f - 1) * stride + 1;
    }
  }
  return lo - 1;
}

// A block's view of its tile: the queries of its first and last lanes, the
// lane offsets of the queries between them (when at most kStage), and the
// length of the work list.
template <int kStage>
struct Tile {
  int64_t off[kStage];
  int32_t q[2];
  int32_t count;
};

// The queries of the tile of chunk lanes [tile0, tile_end); every thread
// of the block calls it (it synchronises the block).  The block needs 64
// threads or more.
template <int kStage>
__device__ __forceinline__ void stage_tile(
    Tile<kStage>& t, const int64_t* __restrict__ lane_off, int32_t nq,
    int64_t lane_base, int64_t tile0, int64_t tile_end) {
  const int tid = threadIdx.x;
  if (tid < 64) {
    const int32_t q = warp_lane_query(
        lane_off, nq, lane_base + (tid < 32 ? tile0 : tile_end - 1), tid & 31);
    if ((tid & 31) == 0) t.q[tid >> 5] = q;
  }
  if (tid == 0) t.count = 0;
  __syncthreads();
  const int32_t n_span = t.q[1] - t.q[0] + 1;  // queries in the tile
  if (n_span <= kStage && tid < n_span) t.off[tid] = lane_off[t.q[0] + tid];
  __syncthreads();
}

// The query owning absolute lane gl of a staged tile (the last one whose
// offset is <= gl); its lane offset goes to *q_off.
template <int kStage>
__device__ __forceinline__ int32_t tile_lane_query(
    const Tile<kStage>& t, const int64_t* __restrict__ lane_off, int64_t gl,
    int64_t* q_off) {
  const int32_t q_first = t.q[0];
  int32_t a = 0, b = t.q[1] - q_first;
  if (b < kStage) {
    while (a < b) {
      const int32_t mid = a + (b - a + 1) / 2;
      if (t.off[mid] <= gl) a = mid; else b = mid - 1;
    }
    *q_off = t.off[a];
  } else {
    while (a < b) {
      const int32_t mid = a + (b - a + 1) / 2;
      if (lane_off[q_first + mid] <= gl) a = mid; else b = mid - 1;
    }
    *q_off = lane_off[q_first + a];
  }
  return q_first + a;
}

// The work-list slot of a lane that is `listed`, -1 for one that is not;
// every lane of the warp calls it.
__device__ __forceinline__ int32_t list_slot(bool listed, int32_t* count) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(kFull, listed);
  int32_t slot = 0;
  if (lane == 0 && ballot) slot = atomicAdd(count, __popc(ballot));
  slot = __shfl_sync(kFull, slot, 0) + __popc(ballot & ((1u << lane) - 1u));
  return listed ? slot : -1;
}

// Store field f of lane l when bit f of `mask` asks for it; row r of
// `rows` ([n_rows, n_lanes]) holds the r-th requested field.
__device__ __forceinline__ void put(int32_t* rows, uint32_t mask, int f,
                                    int64_t n_lanes, int64_t l, int32_t v) {
  if ((mask >> f) & 1u) {
    const int row = __popc(mask & ((1u << f) - 1u));
    rows[static_cast<int64_t>(row) * n_lanes + l] = v;
  }
}

}  // namespace impg_lanes
