// Path-spelling kernel for the columnar GFA model (graph/columnar_ops.py).
//
// The port's copy of impg_tpu/native/spellc.cpp, built into the port's
// native host library (io/native.py).
//
// Role model: the reference's streaming path validation over flat vectors
// (docs/crush-perf-report.md:82 — 136 ms for a 115 MiB graph). A numpy
// formulation needs several large gather/where temporaries whose first-touch
// page faults dominate; this function is a single pass that writes each
// output byte exactly once.
//
// Threads split the step range; every step writes a disjoint output slice,
// so no synchronization is needed.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>
#include <utility>

namespace {

inline uint8_t rc_base(uint8_t b) {
  switch (b) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    case 'N': return 'N';
    case 'n': return 'n';
    default:  return b;  // IUPAC and others pass through like the LUT
  }
}

void spell_range(const uint8_t* blob, const int64_t* seg_off,
                 const int32_t* step_row, const uint8_t* step_rev,
                 const int64_t* out_off, uint8_t* out, int64_t lo,
                 int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t r = step_row[i];
    const int64_t s = seg_off[r];
    const int64_t len = seg_off[r + 1] - s;
    uint8_t* dst = out + out_off[i];
    if (!step_rev[i]) {
      std::memcpy(dst, blob + s, static_cast<size_t>(len));
    } else {
      const uint8_t* src = blob + s + len - 1;
      for (int64_t j = 0; j < len; ++j) dst[j] = rc_base(src[-j]);
    }
  }
}

}  // namespace

extern "C" {

// out must be sized out_off[n_steps]; out_off has n_steps+1 entries.
void impg_spell_steps(const uint8_t* blob, const int64_t* seg_off,
                      const int32_t* step_row, const uint8_t* step_rev,
                      int64_t n_steps, const int64_t* out_off, uint8_t* out,
                      int32_t n_threads) {
  if (n_steps <= 0) return;
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || n_steps < 4096) {
    spell_range(blob, seg_off, step_row, step_rev, out_off, out, 0, n_steps);
    return;
  }
  // Split by output bytes, not steps, for balance on skewed segment sizes.
  const int64_t total = out_off[n_steps];
  std::vector<std::thread> threads;
  int64_t lo = 0;
  for (int t = 0; t < nt && lo < n_steps; ++t) {
    const int64_t want = total * (t + 1) / nt;
    // first step index whose out_off exceeds `want`
    int64_t hi = lo;
    while (hi < n_steps && out_off[hi + 1] <= want) ++hi;
    if (t == nt - 1 || hi >= n_steps) hi = n_steps;
    else if (hi == lo) hi = lo + 1;
    threads.emplace_back(spell_range, blob, seg_off, step_row, step_rev,
                         out_off, out, lo, hi);
    lo = hi;
  }
  for (auto& th : threads) th.join();
}

// Token-stream concatenation: like impg_spell_steps but with explicit
// (start, len) per token table entry (tokens may overlap in the blob),
// no reverse-complement. Used by the columnar GFA writer.
void impg_concat_tokens(const uint8_t* blob, const int64_t* tok_start,
                        const int64_t* tok_len, const int64_t* rows,
                        int64_t n_rows, const int64_t* out_off,
                        uint8_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t r = rows[i];
    std::memcpy(out + out_off[i], blob + tok_start[r],
                static_cast<size_t>(tok_len[r]));
  }
}

// Offsets pass for the mt variant: out_off[i] = sum of the first i
// token lengths (n_rows+1 entries).  One native pass replaces the
// python-side 100+ MB gather + cumsum.  Returns the total size.
int64_t impg_concat_tokens_offsets(const int64_t* tok_len,
                                   const int64_t* rows, int64_t n_rows,
                                   int64_t* out_off) {
  int64_t acc = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    out_off[i] = acc;
    acc += tok_len[rows[i]];
  }
  out_off[n_rows] = acc;
  return acc;
}

// Parallel token copy: every row writes a disjoint out slice, so
// threads split the row range with no synchronization.  Tokens average
// a few bytes — the serial loop is latency-bound, not bandwidth-bound
// (measured 1.27 s for ~16M tokens / 130 MB on the 103 MiB graph).
void impg_concat_tokens_mt(const uint8_t* blob, const int64_t* tok_start,
                           const int64_t* tok_len, const int64_t* rows,
                           int64_t n_rows, const int64_t* out_off,
                           uint8_t* out, int32_t threads) {
  int nt = threads > 0 ? threads
                       : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if ((int64_t)nt > n_rows / 65536 + 1)
    nt = (int)(n_rows / 65536 + 1);
  if (nt == 1) {
    impg_concat_tokens(blob, tok_start, tok_len, rows, n_rows, out_off,
                       out);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    int64_t lo = n_rows * t / nt, hi = n_rows * (t + 1) / nt;
    pool.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t r = rows[i];
        std::memcpy(out + out_off[i], blob + tok_start[r],
                    static_cast<size_t>(tok_len[r]));
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Priority topological sort (gfasort 's' stage role): Kahn's algorithm
// with a min-heap keyed on each node's CURRENT order position, so ties
// follow a preceding path-SGD layout (graph/sortgfa.py _topo_priority).
// Self-edges are ignored; nodes left on cycles append in priority order.
// order_out receives node ids (0..n-1) in sorted order.
void impg_topo_priority(int32_t n, const int32_t* edge_a,
                        const int32_t* edge_b, int64_t n_edges,
                        const int32_t* prio, int32_t* order_out) {
  std::vector<int64_t> head(static_cast<size_t>(n) + 1, 0);
  std::vector<int32_t> indeg(n, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    const int32_t a = edge_a[e], b = edge_b[e];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    ++head[a + 1];
    ++indeg[b];
  }
  for (int32_t v = 0; v < n; ++v) head[v + 1] += head[v];
  std::vector<int32_t> succ(head[n]);
  {
    std::vector<int64_t> at(head.begin(), head.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      const int32_t a = edge_a[e], b = edge_b[e];
      if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
      succ[at[a]++] = b;
    }
  }
  // Binary min-heap of (prio, node).
  std::vector<std::pair<int32_t, int32_t>> heap;
  heap.reserve(n);
  auto cmp = [](const std::pair<int32_t, int32_t>& x,
                const std::pair<int32_t, int32_t>& y) { return x > y; };
  for (int32_t v = 0; v < n; ++v)
    if (indeg[v] == 0) heap.emplace_back(prio[v], v);
  std::make_heap(heap.begin(), heap.end(), cmp);
  std::vector<uint8_t> seen(n, 0);
  int64_t out_at = 0;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    const int32_t v = heap.back().second;
    heap.pop_back();
    if (seen[v]) continue;
    seen[v] = 1;
    order_out[out_at++] = v;
    for (int64_t i = head[v]; i < head[v + 1]; ++i) {
      const int32_t w = succ[i];
      if (--indeg[w] == 0 && !seen[w]) {
        heap.emplace_back(prio[w], w);
        std::push_heap(heap.begin(), heap.end(), cmp);
      }
    }
  }
  if (out_at < n) {
    // Cycle remnants: stable in priority order.
    std::vector<std::pair<int32_t, int32_t>> rest;
    for (int32_t v = 0; v < n; ++v)
      if (!seen[v]) rest.emplace_back(prio[v], v);
    std::sort(rest.begin(), rest.end());
    for (auto& pv : rest) order_out[out_at++] = pv.second;
  }
}

}  // extern "C"
