// K-I path_sgd: one epoch of the annealed path-SGD 1D layout, and its apply.
//
// Replaces: impg_tpu/graph/sortgfa.py:_sgd_epochs_jax (161-226), which runs
// each epoch as XLA gathers and scatter-adds over `batch` = 8 x n_steps
// sampled step pairs inside one lax.fori_loop: per pair, a uniform step i
// and a partner j at a log-uniform step distance within i's path; d the bp
// distance of the two steps, mu = min(eta / d^2, 1), r = (|diff| - d) /
// (2 |diff|) (0 where |diff| <= 1e-9), dx = mu r diff with diff = x[a] -
// x[b]; acc[a] += dx, acc[b] -= dx, cnt[a] += 1, cnt[b] += 1; then
// x -= acc / max(cnt, 1) (Jacobi: every pull of the epoch reads the epoch's
// starting x).
//
// Bound on the H100: neither bytes nor operations of the function itself.
// It must read the step columns once (16 bytes a step) and x, and write x
// (the accumulators live in L2), and does about 40 operations a sample: at
// 8 samples a step both come to well under a tenth of a millisecond for the
// main path's 13.5M steps.  What this design pays is latency: every sample
// makes two dependent random gathers (the steps, then x at their nodes) and
// four atomics into L2-resident accumulators (acc and cnt of 225k segments
// are 1.8 MB), so it is bound by L2 atomic and gather throughput.
//
// Design: one thread per sample in a grid-stride loop.  The sample's three
// random numbers come from a counter-based Philox4x32-10 keyed by (seed,
// epoch) with the sample index as counter, so no state is stored and the
// plain twin (ops/path_sgd.py) draws the same pairs.  The offset is mapped
// in float64 (ceil(exp(t log n_steps))), so one ulp of float32 cannot move
// it across an integer.  The step columns are one interleaved int32 row of
// (node, position bits, path start, path end) a step: one 16-byte load for
// step i, one 8-byte load for step j.  The float32 update uses
// round-to-nearest intrinsics in the twin's order of operations, so no
// multiply-add is contracted; only the order of the atomic sums differs
// from the twin's.  A second launch applies the averaged moves and zeroes
// the accumulators for the next epoch.  A pair with i == j is skipped: its
// JAX weight is 0.  `pairs`, when not null, receives each sample's (i, j)
// (for checking the draws against the twin).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

struct Words {
  uint32_t u0, u1, u2, u3;
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Words{c0, c1, c2, c3};
}

__global__ void __launch_bounds__(kThreads) impg_k_path_sgd_epoch(
    const int4* __restrict__ steps, int64_t n_steps,
    const float* __restrict__ x, float* __restrict__ acc,
    float* __restrict__ cnt, int64_t batch, float eta, double log_n,
    uint32_t seed, uint32_t epoch, int2* __restrict__ pairs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       s < batch; s += stride) {
    const Words u = philox4x32_10(static_cast<uint32_t>(s),
                                  static_cast<uint32_t>(s >> 32), 0u, 0u,
                                  seed, epoch);
    const int64_t i = static_cast<int64_t>(
        (static_cast<uint64_t>(u.u0) * static_cast<uint64_t>(n_steps)) >> 32);
    const double t =
        static_cast<double>((static_cast<uint64_t>(u.u1) << 21) |
                            (u.u3 >> 11)) *
        0x1.0p-53;
    const int64_t off = static_cast<int64_t>(ceil(exp(__dmul_rn(t, log_n))));
    const int4 si = steps[i];
    int64_t j = (u.u2 >> 31) ? i + off : i - off;
    j = j < si.z ? si.z : j;
    j = j > si.w - 1 ? si.w - 1 : j;
    if (pairs != nullptr) {
      pairs[s] = make_int2(static_cast<int>(i), static_cast<int>(j));
    }
    if (j == i) continue;
    const int2 sj = reinterpret_cast<const int2*>(steps + j)[0];
    const int a = si.x;
    const int b = sj.x;
    const float d =
        fmaxf(fabsf(__fsub_rn(__int_as_float(si.y), __int_as_float(sj.y))),
              1e-9f);
    const float w = __fdiv_rn(1.0f, __fmul_rn(d, d));
    const float mu = fminf(__fmul_rn(eta, w), 1.0f);
    const float diff = __fsub_rn(x[a], x[b]);
    const float mag = fabsf(diff);
    const bool big = mag > 1e-9f;
    const float cur = big ? mag : 1e-9f;
    const float r = __fmul_rn(
        __fdiv_rn(__fsub_rn(cur, d), __fmul_rn(2.0f, cur)), big ? 1.0f : 0.0f);
    const float dx = __fmul_rn(__fmul_rn(mu, r), diff);
    atomicAdd(acc + a, dx);
    atomicAdd(acc + b, -dx);
    atomicAdd(cnt + a, 1.0f);
    atomicAdd(cnt + b, 1.0f);
  }
}

__global__ void __launch_bounds__(kThreads) impg_k_path_sgd_apply(
    float* __restrict__ x, float* __restrict__ acc, float* __restrict__ cnt,
    int64_t n) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= n) return;
  x[k] = __fsub_rn(x[k], __fdiv_rn(acc[k], fmaxf(cnt[k], 1.0f)));
  acc[k] = 0.0f;
  cnt[k] = 0.0f;
}
}  // namespace

// One epoch's pulls into acc/cnt.  steps: int32 [n_steps, 4] (node,
// float32 position bits, path start, path end), 16-byte aligned; x, acc,
// cnt: float32 [n] (acc and cnt zero); pairs: int32 [batch, 2] or null.
extern "C" int impg_path_sgd_epoch(const void* steps, int64_t n_steps,
                                   const void* x, void* acc, void* cnt,
                                   int64_t batch, float eta, double log_n,
                                   uint32_t seed, uint32_t epoch, void* pairs,
                                   void* stream) {
  if (batch <= 0 || n_steps <= 0) return kNoLaunch;
  const int64_t want = (batch + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  impg_k_path_sgd_epoch<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(steps), n_steps, static_cast<const float*>(x),
      static_cast<float*>(acc), static_cast<float*>(cnt), batch, eta, log_n,
      seed, epoch, static_cast<int2*>(pairs));
  return static_cast<int>(cudaGetLastError());
}

// x -= acc / max(cnt, 1); acc = cnt = 0, over n segments.
extern "C" int impg_path_sgd_apply(void* x, void* acc, void* cnt, int64_t n,
                                   void* stream) {
  if (n <= 0) return kNoLaunch;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  impg_k_path_sgd_apply<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(acc),
      static_cast<float*>(cnt), n);
  return static_cast<int>(cudaGetLastError());
}
