// K-F syncmer_scan and K-G map_pack: the closed-syncmer scan over one flat
// row of 2-bit base codes in which sequences (K-F) or reads (K-G) follow one
// another, each followed by one 255 (the invalid code).  K-F compacts the
// selected windows of a whole index's sequences on the card; K-G adds each
// selected id's hit in the sorted syncmer universe into resident counts.
//
// Replaces: impg_tpu/ops/syncmer_jax.py:syncmer_scan (K-F) and
// :map_pack_step (K-G), which trace the numpy pipeline of ops/syncmer.py as
// whole-array shift/compare passes over 255-padded [B, L] rows (span-doubling
// k-mer packing, a span-doubling sliding minimum, a 4^k reverse-complement
// table gather, a binary search of the universe as uint32 halves, a
// segment-sum).  A window that crosses a separator holds an invalid k-mer
// and never selects, exactly as a JAX window that reaches the padding.
//
// Bound on the H100: the function reads each code once and writes 17 bytes
// a selected window (K-F) or reads the universe once and an 8-byte count per
// hit (K-G); its arithmetic is about 19 32-bit operations a window start (a
// rolling k-mer pack, one mix32 per k-mer, a sliding minimum, the end test)
// and 38 more a selected window (the id's four mix32 and its compare and
// select).  Only about 2 / (w + 1) of the windows select, so on real
// sequence the bytes bind, the operations a little below them
// (chip_smoke.py's scan_bytes_ops).
//
// Design: a block of kThreads threads owns a tile of kTile = kThreads *
// kPerThread window starts of the flat row, so blocks fill the card whatever
// the reads' lengths and each block's fixed latencies (the codes' load from
// device memory, three barriers, the serial minimum scans) are paid once for
// kTile windows.  The block stages the tile's codes plus the k + w - 1 halo
// in shared memory (16-byte loads; codes past the row's end read as 255)
// and, from the same registers, a bitmask of the invalid codes (a code's top
// bit: valid codes are 0-3).  Each thread then rolls the packed k-mer over
// its own run of consecutive k-mers (one code read a k-mer, kBatch reads in
// flight, the last invalid code's position for validity) and stores the
// canonical k-mer's mix32 (0xFFFFFFFF when invalid).  Then one warp turns
// the bitmask into per-word prefix counts while other threads compute the
// van Herk / Gil-Werman sliding minimum: the tile's hashes in chunks of
// w + 1, each chunk's prefix and suffix minima (one thread a scan, kBatch
// loads in flight, eight prefix and eight suffix scans a warp to keep
// shared-memory bank conflicts low), so that the minimum of [t, t + w] is
// min(suffix[t], prefix[t + w]).  A window is all-valid when the prefix
// counts of invalid codes at its two ends agree, and selects when its first
// or last hash is the minimum.  Thread tid owns windows tid + r * kThreads,
// so each warp's ballot over one r is 32 consecutive windows: one word of
// the tile's selection bitmask.
//
// K-F runs two passes over the codes.  The scan pass writes each tile's
// selection bitmask (kTileWords words) and count, and one block scans the
// tile counts into output offsets (1,024 counts a step, coalesced); the
// host reads the total and sizes the output by it (a homopolymer selects
// every window).  The write pass gives each tile one warp: lane r takes the
// tile's r-th selected window (and r + 32, ...), found through a warp scan
// of the words' popcounts, and writes at the tile's offset plus r its
// position within its sequence (walked from the tile's first sequence,
// found by a 32-way search of the starts), its id (from the two end k-mers,
// read again from the codes) and its orientation, so the output is in
// (sequence, position) order; it also writes, for each sequence, the output
// index of its first syncmer (the rank of its start), whose differences are
// the per-sequence counts.
//
// K-G looks each selected id up in a directory of 2^16 + 1 bucket starts,
// keyed by the top 16 bits of the id (the canonical hi word is a mix32, so
// the buckets are balanced), then by a lower-bound search inside the bucket
// (a few entries instead of log2 U dependent probes), taking ids as the
// uint64 they are; a hit adds one to its int64 count with a 64-bit atomic
// and the block's hit total goes into n_matched with one atomic.  The
// reverse complement is arithmetic, so any k <= 16 works; the JAX table
// gather is exact only for k <= 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // window starts a thread
constexpr int kTile = kThreads * kPerThread;  // window starts a block
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = kTile / 32;  // selection bitmask words a tile
constexpr int kLaneWords = kTileWords / 32;  // of them, a write-pass lane's
static_assert(kTileWords % 32 == 0, "whole bitmask words a write-pass lane");
constexpr int kScanThreads = 1024;
// Shared-memory reads a thread keeps in flight in its serial scans.
constexpr int kBatch = 8;
// Blocks an SM keeps resident (2,048 threads): at most 32 registers a
// thread for the scan kernels.
constexpr int kBlocksPerSM = 8;
constexpr uint8_t kInvalid = 255;
constexpr int kBucketShift = 48;  // directory key: the id's top 16 bits
// Returned by an entry point that launched nothing (empty input); see
// kernels.NO_LAUNCH.
constexpr int kNoLaunch = -1;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Reverse complement of a packed k-mer (k <= 16, 2 bits a base, A=0 C=1
// G=2 T=3): complement the 2k code bits, reverse the bit order, swap the
// two bits of each base back, and shift the k bases down.
__device__ __forceinline__ uint32_t revcomp(uint32_t code, int k) {
  const uint32_t mask = k == 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  uint32_t r = __brev(code ^ mask);
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return k == 16 ? r : r >> (32 - 2 * k);
}

// The k codes at p packed (all valid: the window was selected).
__device__ __forceinline__ uint32_t pack_kmer(const uint8_t* p, int k) {
  uint32_t code = 0;
  for (int b = 0; b < k; ++b) code = (code << 2) | p[b];
  return code;
}

// The canonical id of the window whose end k-mers are `first` and `last`:
// (mix32(first), mix32(last, seed + 1)) forward, or those of the reverse
// complement, whichever is smaller as (hi, lo); *fwd says which.
__device__ __forceinline__ unsigned long long canonical_id(
    uint32_t first, uint32_t last, int k, uint32_t seed, bool* fwd) {
  const uint32_t fh_hi = mix32(first, seed);
  const uint32_t fh_lo = mix32(last, seed + 1u);
  const uint32_t rh_hi = mix32(revcomp(last, k), seed);
  const uint32_t rh_lo = mix32(revcomp(first, k), seed + 1u);
  *fwd = fh_hi < rh_hi || (fh_hi == rh_hi && fh_lo <= rh_lo);
  const uint32_t hi = *fwd ? fh_hi : rh_hi;
  const uint32_t lo = *fwd ? fh_lo : rh_lo;
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The tile's shared-memory arrays for (k, w).
struct Tile {
  int n_kmers;  // kTile + w
  int n_codes;  // n_kmers + k - 1
  int n_words;  // invalid-code bitmask words, one spare (all valid)
  int code_bytes;  // n_codes rounded up to 16-byte loads
};

__host__ __device__ inline Tile tile_of(int k, int w) {
  Tile t;
  t.n_kmers = kTile + w;
  t.n_codes = t.n_kmers + k - 1;
  t.n_words = (t.n_codes + 31) / 32 + 1;
  t.code_bytes = (t.n_codes + 15) & ~15;
  return t;
}

// Shared-memory bytes of one block's scan: codes, then hashes, prefix and
// suffix minima, the invalid-code words and their prefix counts.  Mirrored
// by ops/syncmer_device.py:scan_smem_bytes, which refuses more than 48 KB.
__host__ __device__ inline int scan_smem_bytes(int k, int w) {
  const Tile t = tile_of(k, w);
  return t.code_bytes + 4 * (3 * t.n_kmers + 2 * t.n_words);
}

// Invalid codes in the tile's codes [0, p).
__device__ __forceinline__ int invalid_before(const uint32_t* s_inv,
                                              const int* s_cnt, int p) {
  return s_cnt[p >> 5] + __popc(s_inv[p >> 5] & ((1u << (p & 31)) - 1u));
}

// The block's scan of window starts [i0, i0 + kTile) of the row: bit r of
// the result says whether this thread's window i0 + r * kThreads +
// threadIdx.x (< m) selects.  On return the tile's codes are at
// smem[0, n_codes) for the caller.
__device__ uint32_t scan_tile(const uint8_t* __restrict__ row, int64_t len,
                              int64_t i0, int64_t m, int k, int w,
                              uint32_t seed, uint8_t* smem) {
  const Tile T = tile_of(k, w);
  const int w1 = w + 1;
  uint8_t* s_code = smem;
  uint32_t* s_hash = reinterpret_cast<uint32_t*>(smem + T.code_bytes);
  uint32_t* s_pre = s_hash + T.n_kmers;
  uint32_t* s_suf = s_pre + T.n_kmers;
  uint32_t* s_inv = s_suf + T.n_kmers;
  int* s_cnt = reinterpret_cast<int*>(s_inv + T.n_words);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The tile's codes, 16 bytes a load where the row allows, and the
  // invalid-code bitmask from them: a code is invalid when its top bit is
  // set (255; valid codes are 0-3), 16 bits a load, two loads a word.
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int n_vec = T.code_bytes / 16;
  for (int v0 = warp * 32; v0 < n_vec; v0 += kThreads) {
    const int v = v0 + lane;
    const int64_t p = i0 + 16 * v;
    uint32_t q[4] = {0, 0, 0, 0};
    if (v < n_vec) {
      if (aligned && p + 16 <= len) {
        const uint4 x = *reinterpret_cast<const uint4*>(row + p);
        q[0] = x.x;
        q[1] = x.y;
        q[2] = x.z;
        q[3] = x.w;
      } else {
        for (int j = 0; j < 16; ++j) {
          const uint32_t c = p + j < len ? row[p + j] : kInvalid;
          q[j >> 2] |= c << (8 * (j & 3));
        }
      }
      reinterpret_cast<uint4*>(s_code)[v] = make_uint4(q[0], q[1], q[2], q[3]);
    }
    uint32_t inv = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t y = (q[u] >> 7) & 0x01010101u;
      inv |= ((y | (y >> 7) | (y >> 14) | (y >> 21)) & 0xFu) << (4 * u);
    }
    inv |= __shfl_down_sync(0xffffffffu, inv, 1) << 16;
    if ((v & 1) == 0 && v < n_vec) s_inv[v >> 1] = inv;
  }
  __syncthreads();

  // The k-mer hashes: each thread rolls the packed k-mer over its own run
  // [j0, j1) of consecutive k-mers, reading the run's codes kBatch at a time;
  // `last_inv` is the last invalid code read, so k-mer j is valid when
  // last_inv < j.
  const int per = (T.n_kmers + kThreads - 1) / kThreads;
  const int j0 = tid * per;
  const int n_read = min(j0 + per, T.n_kmers) - j0 + k - 1;
  if (n_read >= k) {
    const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
    uint32_t code = 0;
    int last_inv = -1;
    for (int b0 = 0; b0 < n_read; b0 += kBatch) {
      uint32_t cb[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        cb[u] = b0 + u < n_read ? s_code[j0 + b0 + u] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = b0 + u;
        if (i < n_read) {
          const uint32_t c = cb[u];
          if (c == kInvalid) last_inv = j0 + i;
          code = ((code << 2) | (c == kInvalid ? 0u : c)) & kmask;
          const int j = j0 + i - (k - 1);  // the k-mer ending at code i
          if (j >= j0) {
            const uint32_t rc = revcomp(code, k);
            s_hash[j] = last_inv < j ? mix32(code < rc ? code : rc, seed)
                                     : 0xFFFFFFFFu;
          }
        }
      }
    }
  }
  __syncthreads();

  // Warp 0: the bitmask's exclusive prefix counts, 32 words a step.  Lanes
  // 0-7 of the other warps: van Herk / Gil-Werman prefix minima within each
  // chunk of w + 1 hashes, one thread a chunk; lanes 8-15 the suffix minima
  // of the same chunks (at w = 55 a warp's prefix and suffix lanes never
  // share a bank, and its chunks fall on two lanes a bank).
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < T.n_words; base += 32) {
      const int x = base + lane;
      const int c = x < T.n_words ? __popc(s_inv[x]) : 0;
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (x < T.n_words) s_cnt[x] = carry + incl - c;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  } else if (lane < 16) {
    const int n_chunks = (T.n_kmers + w) / w1;
    const bool suffix = lane >= 8;
    const int step = suffix ? -1 : 1;
    const uint32_t* __restrict__ h = s_hash;
    uint32_t* __restrict__ out = suffix ? s_suf : s_pre;
    for (int chunk = (warp - 1) * 8 + (lane & 7); chunk < n_chunks;
         chunk += (kWarps - 1) * 8) {
      const int lo = chunk * w1;
      const int n = min(w1, T.n_kmers - lo);
      int j = suffix ? lo + n - 1 : lo;
      uint32_t mn = 0xFFFFFFFFu;
      for (int i0 = 0; i0 < n; i0 += kBatch) {
        uint32_t v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = i0 + u < n ? h[j + u * step] : 0xFFFFFFFFu;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          mn = min(mn, v[u]);
          if (i0 + u < n) out[j + u * step] = mn;
        }
        j += kBatch * step;
      }
    }
  }
  __syncthreads();

  uint32_t sel = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = r * kThreads + tid;
    if (i0 + t < m) {
      const uint32_t mn = min(s_suf[t], s_pre[t + w]);
      const bool all_valid = invalid_before(s_inv, s_cnt, t + w + k) ==
                             invalid_before(s_inv, s_cnt, t);
      if (all_valid && (s_hash[t] == mn || s_hash[t + w] == mn)) {
        sel |= 1u << r;
      }
    }
  }
  return sel;
}

// Position of the n-th (0-based) set bit of x; x has more than n set bits.
__device__ __forceinline__ int nth_set_bit(uint32_t x, int n) {
  int pos = 0;
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

// Selected windows at row positions below p, from the tile bitmasks and the
// tile offsets (p < m).
__device__ __forceinline__ int64_t rank_of(const uint32_t* __restrict__ masks,
                                           const int64_t* __restrict__ offsets,
                                           int64_t p) {
  const int64_t tile = p / kTile;
  const int off = static_cast<int>(p - tile * kTile);
  const uint32_t* tm = masks + tile * kTileWords;
  int64_t r = offsets[tile];
  for (int j = 0; j < (off >> 5); ++j) r += __popc(tm[j]);
  return r + __popc(tm[off >> 5] & ((1u << (off & 31)) - 1u));
}
}  // namespace

// K-F pass 1: each tile's selection bitmask and count.
extern "C" __global__ void __launch_bounds__(kThreads, kBlocksPerSM)
impg_k_syncmer_scan(
    const uint8_t* __restrict__ codes, int64_t len, int64_t m, int32_t k,
    int32_t w, uint32_t seed, uint32_t* __restrict__ masks,
    int32_t* __restrict__ tile_counts) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_warp[kWarps];
  const int64_t tile = blockIdx.x;
  const uint32_t sel =
      scan_tile(codes, len, tile * kTile, m, k, w, seed, smem);
  const int warp = threadIdx.x >> 5;
  int count = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const uint32_t bits = __ballot_sync(0xffffffffu, (sel >> r) & 1u);
    if ((threadIdx.x & 31) == 0) {
      masks[tile * kTileWords + r * kWarps + warp] = bits;
    }
    count += __popc(bits);
  }
  if ((threadIdx.x & 31) == 0) s_warp[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int j = 0; j < kWarps; ++j) c += s_warp[j];
    tile_counts[tile] = c;
  }
}

// K-F: exclusive scan of the tile counts into offsets [n + 1] (offsets[n]
// is the total), one block walking the counts kScanThreads at a time, one a
// thread (coalesced, the next load issued before the current step's scan),
// each step's total carried on.
extern "C" __global__ void __launch_bounds__(kScanThreads) impg_k_tile_scan(
    const int32_t* __restrict__ counts, int64_t n,
    int64_t* __restrict__ offsets) {
  __shared__ int s_part[kScanThreads / 32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t carry = 0;
  int next = threadIdx.x < n ? counts[threadIdx.x] : 0;
  for (int64_t base = 0; base < n; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int c = next;
    next = i + kScanThreads < n ? counts[i + kScanThreads] : 0;
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) s_part[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int part = s_part[lane];
      int x = part;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += u;
      }
      s_part[lane] = x - part;
      if (lane == 31) s_total = x;
    }
    __syncthreads();
    if (i < n) offsets[i] = carry + s_part[warp] + incl - c;
    carry += s_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n] = carry;
}

// K-F pass 2: one warp a tile writes the tile's selected windows at its
// offset, lane r taking the tile's r-th, (r + 32)-th, ... selected window
// (each lane holds kLaneWords consecutive bitmask words: a search of their
// popcounts' scan across the lanes, then within the lane's words).  The
// warp finds the tile's first sequence with a 32-way search of the starts
// (one probe a lane, a ballot a step); a window's own is walked to from
// there.  The grid's threads also write first[s] = rank(starts[s]) for s in
// [0, n_seqs].
extern "C" __global__ void __launch_bounds__(kThreads) impg_k_syncmer_write(
    const uint8_t* __restrict__ codes, int64_t m, int32_t k, int32_t w,
    uint32_t seed, const uint32_t* __restrict__ masks,
    const int64_t* __restrict__ offsets, int64_t n_tiles,
    const int64_t* __restrict__ starts, int64_t n_seqs,
    int64_t* __restrict__ pos, unsigned long long* __restrict__ ids,
    uint8_t* __restrict__ fwd, int64_t* __restrict__ first) {
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  for (int64_t s = gtid; s <= n_seqs;
       s += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t p = starts[s];
    first[s] = p < m ? rank_of(masks, offsets, p) : offsets[n_tiles];
  }
  const int64_t tile = gtid >> 5;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  uint32_t words[kLaneWords];
  int c = 0;
#pragma unroll
  for (int q = 0; q < kLaneWords; ++q) {
    words[q] = masks[tile * kTileWords + lane * kLaneWords + q];
    c += __popc(words[q]);
  }
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  const int count = __shfl_sync(0xffffffffu, incl, 31);
  if (count == 0) return;
  const int64_t base = offsets[tile];
  // The tile's first sequence: the last s with starts[s] <= its first
  // window, in [lo, hi) narrowed 32-fold a step.
  const int64_t g0 = tile * kTile;
  int64_t lo = 0, hi = n_seqs;
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;
    const uint32_t le =
        __ballot_sync(0xffffffffu, probe < hi && starts[probe] <= g0);
    lo += (31 - __clz(le)) * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  for (int r0 = 0; r0 < count; r0 += 32) {
    const int r = r0 + lane;
    // The lane holding rank r: the number of lanes whose inclusive count
    // is at most r; then the word and the bit within its words.
    int j = 0;
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(0xffffffffu, incl, j + step - 1) <= r) j += step;
    }
    int rem = r - __shfl_sync(0xffffffffu, incl - c, j);
    int word = 0, bit = 0;
    bool found = false;
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) {
      const uint32_t wq = __shfl_sync(0xffffffffu, words[q], j);
      const int cq = __popc(wq);
      if (!found && rem < cq) {
        word = j * kLaneWords + q;
        bit = nth_set_bit(wq, rem);
        found = true;
      }
      if (!found) rem -= cq;
    }
    if (r >= count) continue;
    const int64_t g = g0 + word * 32 + bit;
    int64_t s = lo;
    while (s + 1 < n_seqs && starts[s + 1] <= g) ++s;
    bool f;
    const int64_t o = base + r;
    ids[o] = canonical_id(pack_kmer(codes + g, k),
                          pack_kmer(codes + g + w, k), k, seed, &f);
    pos[o] = g - starts[s];
    fwd[o] = f;
  }
}

extern "C" __global__ void __launch_bounds__(kThreads, kBlocksPerSM)
impg_k_map_pack(
    const uint8_t* __restrict__ codes, int64_t len, int64_t m, int32_t k,
    int32_t w, uint32_t seed, const unsigned long long* __restrict__ universe,
    const int32_t* __restrict__ directory,
    unsigned long long* __restrict__ counts,
    unsigned long long* __restrict__ n_matched) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_hits;
  if (threadIdx.x == 0) s_hits = 0;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
  uint32_t sel = scan_tile(codes, len, i0, m, k, w, seed, smem);
  int hits = 0;
  while (sel) {
    const int t = (__ffs(sel) - 1) * kThreads + threadIdx.x;
    sel &= sel - 1;
    bool f;
    const unsigned long long id = canonical_id(
        pack_kmer(smem + t, k), pack_kmer(smem + t + w, k), k, seed, &f);
    const int bucket = static_cast<int>(id >> kBucketShift);
    int lo = directory[bucket];
    const int end = directory[bucket + 1];
    int hi = end;  // lower bound in [lo, hi)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (universe[mid] < id) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < end && universe[lo] == id) {
      atomicAdd(counts + lo, 1ull);
      ++hits;
    }
  }
  const int warp_hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0 && warp_hits) atomicAdd(&s_hits, warp_hits);
  __syncthreads();
  if (threadIdx.x == 0 && s_hits) {
    atomicAdd(n_matched, static_cast<unsigned long long>(s_hits));
  }
}

// K-F pass 1 over a flat row of len codes: masks [n_tiles * kTileWords]
// uint32, tile_counts [n_tiles] int32 and offsets [n_tiles + 1] int64,
// n_tiles = ceil((len - k - w + 1) / kTile).  Two launches (scan, tile
// scan).
extern "C" int impg_syncmer_scan(const void* codes, int64_t len, int32_t k,
                                 int32_t w, uint32_t seed, void* masks,
                                 void* tile_counts, void* offsets,
                                 void* stream) {
  const int64_t m = len - k - w + 1;
  if (m <= 0) return kNoLaunch;
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  impg_k_syncmer_scan<<<static_cast<unsigned>(n_tiles), kThreads,
                        scan_smem_bytes(k, w), st>>>(
      static_cast<const uint8_t*>(codes), len, m, k, w, seed,
      static_cast<uint32_t*>(masks), static_cast<int32_t*>(tile_counts));
  impg_k_tile_scan<<<1, kScanThreads, 0, st>>>(
      static_cast<const int32_t*>(tile_counts), n_tiles,
      static_cast<int64_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// K-F pass 2, after pass 1 on the same row: pos [n], ids [n], fwd [n] and
// first [n_seqs + 1], n = offsets[n_tiles].  starts [n_seqs + 1] ascending,
// starts[0] = 0, starts[n_seqs] = len; each sequence's codes are followed by
// one 255.
extern "C" int impg_syncmer_write(const void* codes, int64_t len, int32_t k,
                                  int32_t w, uint32_t seed, const void* masks,
                                  const void* offsets, const void* starts,
                                  int64_t n_seqs, void* pos, void* ids,
                                  void* fwd, void* first, void* stream) {
  const int64_t m = len - k - w + 1;
  if (m <= 0 || n_seqs <= 0) return kNoLaunch;
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  const int64_t blocks = (n_tiles + kWarps - 1) / kWarps;
  impg_k_syncmer_write<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), m, k, w, seed,
      static_cast<const uint32_t*>(masks),
      static_cast<const int64_t*>(offsets), n_tiles,
      static_cast<const int64_t*>(starts), n_seqs,
      static_cast<int64_t*>(pos), static_cast<unsigned long long*>(ids),
      static_cast<uint8_t*>(fwd), static_cast<int64_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

// Adds the row's hits into counts [n_universe] and their total into
// *n_matched (both int64, accumulated across calls; never zeroed here).
// directory [2^16 + 1]: the universe index of the first id of each value of
// the ids' top 16 bits (n_universe < 2^31).
extern "C" int impg_map_pack(const void* codes, int64_t len, int32_t k,
                             int32_t w, uint32_t seed, const void* universe,
                             int64_t n_universe, const void* directory,
                             void* counts, void* n_matched, void* stream) {
  const int64_t m = len - k - w + 1;
  if (m <= 0 || n_universe <= 0) return kNoLaunch;
  impg_k_map_pack<<<static_cast<unsigned>((m + kTile - 1) / kTile), kThreads,
                    scan_smem_bytes(k, w),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), len, m, k, w, seed,
      static_cast<const unsigned long long*>(universe),
      static_cast<const int32_t*>(directory),
      static_cast<unsigned long long*>(counts),
      static_cast<unsigned long long*>(n_matched));
  return static_cast<int>(cudaGetLastError());
}
