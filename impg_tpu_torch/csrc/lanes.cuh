// Lane code shared by the lane kernels, K-C (project_lanes.cu) and K-E
// (project_approx.cu): the query of an exact lane, and the field-major store
// of one result field.
//
// A batch of nq queries owns sum(k) exact lanes; lane_off is the int64
// exclusive cumsum of the window sizes k ([nq + 1], absolute lane numbers).
// Lane gl belongs to query lane_query(...) and to record
// win_lo[q] + (gl - lane_off[q]), so lanes run query-major and, within a
// query, in ascending record order: the JAX engine's hit order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace impg_lanes {

// RESULT_FIELDS order (impg_tpu/query/device.py).
enum Field {
  kPairRec = 0, kPairQ, kValid, kQueryId, kPqStart, kPqEnd, kPtStart, kPtEnd,
  kFirstRun, kLastRun, kFirstClip, kLastRem, kMatches, kMismatches, kICount,
  kDCount, kIBp, kDBp,
};

// The query owning absolute lane gl: one less than the first index in
// [0, nq] whose offset exceeds gl (lane_off[nq] > gl always).
__device__ __forceinline__ int32_t lane_query(
    const int64_t* __restrict__ lane_off, int32_t nq, int64_t gl) {
  int32_t a = 0, b = nq;
  while (a < b) {
    const int32_t mid = a + (b - a) / 2;
    if (lane_off[mid] > gl) b = mid; else a = mid + 1;
  }
  return a - 1;
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
