// The port's copy of impg_tpu/native/align.cpp, built into the port's native
// host library (io/native.py).
//
// Pairwise affine-gap alignment with CIGAR traceback for impg_tpu.
//
// Role of the reference's WFA2/lib FFI (impg.rs:43-71 thread-local
// AffineWavefronts): reconstruct base-level CIGARs for bounded segments —
// anchor-gap alignment in the `align` command and tracepoint segment
// reconstruction.  Global Gotoh DP with =/X distinction in the traceback;
// segments are bounded by the callers (anchor gaps / tracepoint spacing), so
// O(n*m) time with a 2-bit-per-cell traceback matrix is plenty.
//
// CIGAR runs use the repo codec: (op << 29) | len with ops = 0 '=', 1 'X',
// 2 'I' (query-only), 3 'D' (target-only).  Query = sequence A, target = B,
// matching PAF orientation (I consumes A, D consumes B).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t NEG = INT32_MIN / 4;
constexpr uint32_t kLenMask = (1u << 29) - 1;

inline void push_run(std::vector<uint32_t>* out, uint32_t op, uint32_t len) {
  if (len == 0) return;
  if (!out->empty() && (out->back() >> 29) == op) {
    uint32_t combined = (out->back() & kLenMask) + len;
    out->back() = (op << 29) | (combined & kLenMask);
  } else {
    out->push_back((op << 29) | (len & kLenMask));
  }
}

}  // namespace

namespace {

// Shared Gotoh DP.  With free_b_end, the alignment is anchored at (0,0) but
// the target end is FREE: traceback starts from the best column of the last
// row (the ends-free extension mode of the reference's BiWFA boundary
// refinement, syng_transitive.rs:436 set_alignment_free_ends).
int64_t align_impl(const uint8_t* a, int64_t alen, const uint8_t* b,
                   int64_t blen, int match, int mismatch, int gap_open,
                   int gap_ext, uint32_t* out, int64_t out_cap,
                   bool free_b_end) {
  if (alen == 0 && blen == 0) return 0;
  if (alen == 0) {
    if (free_b_end) return 0;  // best prefix of b is empty
    if (out_cap < 1) return -1;
    out[0] = (3u << 29) | (static_cast<uint32_t>(blen) & kLenMask);
    return 1;
  }
  if (blen == 0) {
    if (out_cap < 1) return -1;
    out[0] = (2u << 29) | (static_cast<uint32_t>(alen) & kLenMask);
    return 1;
  }
  // Guard: bounded segments only.
  if (alen * blen > (int64_t)256 * 1024 * 1024) return -1;

  const int64_t cols = blen + 1;
  const int64_t n_cells = (alen + 1) * cols;
  std::vector<uint8_t> tb(static_cast<size_t>(n_cells), 0);

  auto TB = [&](int64_t i, int64_t j) -> uint8_t& {
    return tb[static_cast<size_t>(i) * cols + j];
  };

  std::vector<int32_t> Hrow(cols), Erow(cols), Frow(cols), Hup(cols), Fup(cols);
  // tb bits: 0-1 H source (0 diag, 1 from E ('D'), 2 from F ('I')),
  // bit 2: E extension (E[i][j] came from E[i][j-1]),
  // bit 3: F extension (F[i][j] came from F[i-1][j]).
  Hup[0] = 0;
  Fup[0] = NEG;
  for (int64_t j = 1; j <= blen; ++j) {
    Hup[j] = -gap_open - gap_ext * static_cast<int32_t>(j - 1);
    Fup[j] = NEG;
    TB(0, j) = 1 | 4;  // chain of D
  }
  for (int64_t i = 1; i <= alen; ++i) {
    Hrow[0] = -gap_open - gap_ext * static_cast<int32_t>(i - 1);
    Erow[0] = NEG;
    Frow[0] = std::max(Hup[0] - gap_open, Fup[0] - gap_ext);
    TB(i, 0) = 2 | 8;
    for (int64_t j = 1; j <= blen; ++j) {
      int32_t e_open = Hrow[j - 1] - gap_open;
      int32_t e_ext = Erow[j - 1] - gap_ext;
      bool e_is_ext = e_ext >= e_open;
      Erow[j] = e_is_ext ? e_ext : e_open;

      int32_t f_open = Hup[j] - gap_open;
      int32_t f_ext = Fup[j] - gap_ext;
      bool f_is_ext = f_ext >= f_open;
      Frow[j] = f_is_ext ? f_ext : f_open;

      bool is_match = a[i - 1] == b[j - 1];
      int32_t diag = Hup[j - 1] + (is_match ? match : -mismatch);

      int32_t best = diag;
      uint8_t src = 0;
      if (Erow[j] > best) {
        best = Erow[j];
        src = 1;
      }
      if (Frow[j] > best) {
        best = Frow[j];
        src = 2;
      }
      Hrow[j] = best;
      TB(i, j) = src | (e_is_ext ? 4 : 0) | (f_is_ext ? 8 : 0);
    }
    std::swap(Hup, Hrow);
    std::swap(Fup, Frow);
  }

  // Traceback from (alen, blen) — or the best last-row column when the
  // target end is free.
  int64_t j_final = blen;
  if (free_b_end) {
    int32_t best = Hup[0];
    j_final = 0;
    for (int64_t j = 1; j <= blen; ++j) {
      if (Hup[j] > best) {
        best = Hup[j];
        j_final = j;
      }
    }
  }
  std::vector<uint32_t> rev;
  rev.reserve(static_cast<size_t>((alen + blen) / 16 + 4));
  int64_t i = alen, j = j_final;
  int state = 0;  // 0 = H, 1 = E chain, 2 = F chain
  while (i > 0 || j > 0) {
    uint8_t cell = TB(i, j);
    if (state == 0) {
      uint8_t src = cell & 3;
      if (i == 0) src = 1;
      if (j == 0) src = 2;
      if (src == 0) {
        bool is_match = a[i - 1] == b[j - 1];
        push_run(&rev, is_match ? 0u : 1u, 1);
        --i;
        --j;
      } else if (src == 1) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      // Consuming b ('D'); whether the chain continues depends on this cell.
      push_run(&rev, 3u, 1);
      bool ext = (cell & 4) != 0 && j > 1;
      --j;
      state = ext ? 1 : 0;
    } else {
      push_run(&rev, 2u, 1);
      bool ext = (cell & 8) != 0 && i > 1;
      --i;
      state = ext ? 2 : 0;
    }
  }

  // rev holds runs in reverse order (merged); reverse into out.
  int64_t n = static_cast<int64_t>(rev.size());
  if (n > out_cap) return -1;
  for (int64_t r = 0; r < n; ++r) out[r] = rev[static_cast<size_t>(n - 1 - r)];
  // Merge adjacent same-op runs across the reversal boundary artifacts.
  int64_t w = 0;
  for (int64_t r = 1; r < n; ++r) {
    if ((out[w] >> 29) == (out[r] >> 29)) {
      uint32_t combined = (out[w] & kLenMask) + (out[r] & kLenMask);
      out[w] = (out[w] & ~kLenMask) | (combined & kLenMask);
    } else {
      out[++w] = out[r];
    }
  }
  return n == 0 ? 0 : w + 1;
}

// ---------------------------------------------------------------------------
// Affine-gap wavefront alignment (WFA) — the reference's WFA2 role proper
// (impg.rs:43-71 thread-local AffineWavefronts). Near-linear time/memory in
// the optimal penalty s (O(s^2) cells), so long near-identical segments
// (tracepoint reconstruction, chain-gap fills) avoid the Gotoh O(n*m) wall.
//
// Score-domain transform (Eizenga & Paten 2022): Gotoh maximizes
//   m*matches - x*mism - sum(go + ge*(k-1)) over gaps
// which with gap(k) = (go-ge) + ge*k maps to penalty-only WFA
//   X = 2*(m+x), O = 2*(go-ge), E = 2*ge + m
// with identical optima (score = (m*(n+alen) - S)/2).  Gotoh (align_impl)
// stays the exact oracle; impg_align_pair falls back to it whenever WFA
// declines (divergent inputs exceeding the cell budget, go < ge, ...).

constexpr int32_t WF_INVALID = INT32_MIN / 2;

struct WfLevel {
  int32_t lo = 1, hi = -1;  // empty when lo > hi
  int64_t base = -1;        // pool offset of M; I, D follow (width apart)
};

// Returns run count >= 0, -1 on out_cap overflow, -3 when WFA declines
// (unsupported scoring or cell budget exceeded) — caller should fall back.
int64_t align_wfa(const uint8_t* a, int64_t alen, const uint8_t* b,
                  int64_t blen, int match, int mismatch, int gap_open,
                  int gap_ext, uint32_t* out, int64_t out_cap,
                  int64_t cell_budget) {
  if (gap_open < gap_ext || gap_ext <= 0 || match + mismatch <= 0 ||
      match < 0) {
    return -3;
  }
  if (alen == 0 || blen == 0) return -3;  // Gotoh emits the single-run case
  const int64_t X = 2 * (int64_t)(match + mismatch);
  const int64_t O = 2 * (int64_t)(gap_open - gap_ext);
  const int64_t E = 2 * (int64_t)gap_ext + match;
  const int64_t k_end = alen - blen;

  std::vector<WfLevel> levels;
  std::vector<int32_t> pool;
  levels.reserve(256);

  auto comp = [&](int64_t s, int64_t k, int which) -> int32_t {
    if (s < 0 || s >= (int64_t)levels.size()) return WF_INVALID;
    const WfLevel& L = levels[(size_t)s];
    if (k < L.lo || k > L.hi) return WF_INVALID;
    int64_t width = L.hi - L.lo + 1;
    return pool[(size_t)(L.base + which * width + (k - L.lo))];
  };
  auto Mv = [&](int64_t s, int64_t k) { return comp(s, k, 0); };
  auto Iv = [&](int64_t s, int64_t k) { return comp(s, k, 1); };
  auto Dv = [&](int64_t s, int64_t k) { return comp(s, k, 2); };

  // Level 0: M[0] = 0 extended along the main diagonal.
  {
    WfLevel L;
    L.lo = 0;
    L.hi = 0;
    L.base = 0;
    pool.assign(3, WF_INVALID);
    int32_t h = 0;
    while (h < alen && h < blen && a[h] == b[h]) ++h;
    pool[0] = h;
    levels.push_back(L);
  }
  if (Mv(0, k_end) >= alen) {
    // Perfect match (or empty) — a single '=' run.
    if (alen == 0) return 0;
    if (out_cap < 1) return -1;
    out[0] = (0u << 29) | (static_cast<uint32_t>(alen) & kLenMask);
    return 1;
  }

  int64_t s = 0;
  int64_t goal_s = -1;
  while (true) {
    ++s;
    // New level bounds from the three predecessor levels.
    int32_t lo = 1, hi = -1;
    bool any = false;
    for (int64_t ps : {s - X, s - O - E, s - E}) {
      if (ps < 0 || ps >= (int64_t)levels.size()) continue;
      const WfLevel& P = levels[(size_t)ps];
      if (P.lo > P.hi) continue;
      if (!any) {
        lo = P.lo - 1;
        hi = P.hi + 1;
        any = true;
      } else {
        lo = std::min(lo, P.lo - 1);
        hi = std::max(hi, P.hi + 1);
      }
    }
    if (!any) {
      levels.push_back(WfLevel{});
      // No predecessor in reach for the last max-dependency span means the
      // recurrence is dead (cannot happen before the goal for valid inputs;
      // defensive bail).
      int64_t span = std::max({X, O + E, E});
      bool all_empty = (int64_t)levels.size() > span;
      for (int64_t t = s - span + 1; all_empty && t <= s; ++t) {
        if (t >= 0 && t < (int64_t)levels.size() &&
            levels[(size_t)t].lo <= levels[(size_t)t].hi) {
          all_empty = false;
        }
      }
      if (all_empty && (int64_t)levels.size() > span) return -3;
      continue;
    }
    lo = std::max<int32_t>(lo, (int32_t)-blen);
    hi = std::min<int32_t>(hi, (int32_t)alen);
    if (lo > hi) {
      levels.push_back(WfLevel{});
      continue;
    }
    int64_t width = (int64_t)hi - lo + 1;
    if ((int64_t)pool.size() + 3 * width > cell_budget) return -3;
    WfLevel L;
    L.lo = lo;
    L.hi = hi;
    L.base = (int64_t)pool.size();
    pool.resize(pool.size() + (size_t)(3 * width), WF_INVALID);
    levels.push_back(L);
    const WfLevel& cur = levels.back();
    for (int64_t k = lo; k <= hi; ++k) {
      // I: consume one a-base (i+1, j fixed) — from diag k-1.
      int32_t icand = std::max(Mv(s - O - E, k - 1), Iv(s - E, k - 1));
      int32_t iv = WF_INVALID;
      if (icand != WF_INVALID) {
        int32_t h = icand + 1;
        if (h <= alen && h - k >= 0 && h - k <= blen) iv = h;
      }
      // D: consume one b-base (j+1, i fixed) — from diag k+1.
      int32_t dcand = std::max(Mv(s - O - E, k + 1), Dv(s - E, k + 1));
      int32_t dv = WF_INVALID;
      if (dcand != WF_INVALID) {
        int32_t h = dcand;
        if (h >= 0 && h <= alen && h - k >= 0 && h - k <= blen) dv = h;
      }
      // M: mismatch step or close a gap, then greedy match extension.
      int32_t mv = std::max(iv, dv);
      int32_t xprev = Mv(s - X, k);
      if (xprev != WF_INVALID) {
        int32_t h = xprev + 1;
        if (h <= alen && h - k >= 1 && h - k <= blen && h >= 1) {
          mv = std::max(mv, h);
        }
      }
      if (mv != WF_INVALID) {
        int32_t h = mv;
        while (h < alen && h - k < blen && a[h] == b[h - k]) ++h;
        mv = h;
      }
      int64_t idx = cur.base + (k - lo);
      pool[(size_t)idx] = mv;
      pool[(size_t)(idx + width)] = iv;
      pool[(size_t)(idx + 2 * width)] = dv;
    }
    if (Mv(s, k_end) >= alen) {
      goal_s = s;
      break;
    }
  }

  // Traceback.
  std::vector<uint32_t> rev;
  rev.reserve(64);
  int64_t ts = goal_s;
  int64_t k = k_end;
  int32_t h = Mv(ts, k);
  int state = 0;  // 0 = M, 1 = I, 2 = D
  while (true) {
    if (state == 0) {
      if (ts == 0) {
        push_run(&rev, 0u, (uint32_t)h);
        break;
      }
      int32_t iv = Iv(ts, k);
      int32_t dv = Dv(ts, k);
      int32_t xp = Mv(ts - X, k);
      int32_t xv = WF_INVALID;
      if (xp != WF_INVALID && xp + 1 <= alen && xp + 1 - k >= 1 &&
          xp + 1 - k <= blen && xp + 1 >= 1) {
        xv = xp + 1;
      }
      int32_t pre = std::max({iv, dv, xv});
      push_run(&rev, 0u, (uint32_t)(h - pre));
      h = pre;
      if (xv == h) {
        push_run(&rev, 1u, 1);
        ts -= X;
        --h;
      } else if (iv == h) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      push_run(&rev, 2u, 1);
      int32_t fromI = Iv(ts - E, k - 1);
      if (fromI != WF_INVALID && fromI + 1 == h) {
        ts -= E;
      } else {
        ts -= O + E;
        state = 0;
      }
      --k;
      --h;
    } else {
      push_run(&rev, 3u, 1);
      int32_t fromD = Dv(ts - E, k + 1);
      if (fromD != WF_INVALID && fromD == h) {
        ts -= E;
      } else {
        ts -= O + E;
        state = 0;
      }
      ++k;
    }
  }

  int64_t n = static_cast<int64_t>(rev.size());
  if (n > out_cap) return -1;
  for (int64_t r = 0; r < n; ++r) out[r] = rev[static_cast<size_t>(n - 1 - r)];
  int64_t w = 0;
  for (int64_t r = 1; r < n; ++r) {
    if ((out[w] >> 29) == (out[r] >> 29)) {
      uint32_t combined = (out[w] & kLenMask) + (out[r] & kLenMask);
      out[w] = (out[w] & ~kLenMask) | (combined & kLenMask);
    } else {
      out[++w] = out[r];
    }
  }
  return n == 0 ? 0 : w + 1;
}

}  // namespace

extern "C" {

// Align query a[0..alen) against target b[0..blen); writes packed runs into
// out (capacity out_cap).  Returns the number of runs, or -1 if the problem
// is too large / capacity too small.  Scores: positive penalties.
//
// Routing: tiny problems go straight to Gotoh (cheap, any divergence);
// larger ones try WFA first (near-linear when the pair is similar — the
// tracepoint-segment / chain-gap regime) and fall back to Gotoh, which
// keeps its own O(n*m) guard for the divergent-and-huge corner.
int64_t impg_align_pair(const uint8_t* a, int64_t alen, const uint8_t* b,
                        int64_t blen, int match, int mismatch, int gap_open,
                        int gap_ext, uint32_t* out, int64_t out_cap) {
  if ((alen + 1) * (blen + 1) > (int64_t)1 << 22) {
    // ~128 MiB of wavefront cells — penalties up to roughly 3-4k resolve.
    int64_t r = align_wfa(a, alen, b, blen, match, mismatch, gap_open,
                          gap_ext, out, out_cap, (int64_t)32 * 1024 * 1024);
    if (r >= -1) return r;
  }
  return align_impl(a, alen, b, blen, match, mismatch, gap_open, gap_ext,
                    out, out_cap, false);
}

// Direct WFA entry (tests / benchmarking): -3 when WFA declines.
int64_t impg_align_wfa(const uint8_t* a, int64_t alen, const uint8_t* b,
                       int64_t blen, int match, int mismatch, int gap_open,
                       int gap_ext, uint32_t* out, int64_t out_cap) {
  return align_wfa(a, alen, b, blen, match, mismatch, gap_open, gap_ext, out,
                   out_cap, (int64_t)32 * 1024 * 1024);
}

// Ends-free extension: align ALL of a against the best-scoring PREFIX of b.
int64_t impg_align_prefix(const uint8_t* a, int64_t alen, const uint8_t* b,
                          int64_t blen, int match, int mismatch, int gap_open,
                          int gap_ext, uint32_t* out, int64_t out_cap) {
  return align_impl(a, alen, b, blen, match, mismatch, gap_open, gap_ext,
                    out, out_cap, true);
}

}  // extern "C"
