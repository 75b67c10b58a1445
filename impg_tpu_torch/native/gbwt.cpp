// GBWT-lite: native path-walk index over signed syncmer walks.
//
// Role model: the reference's vendored C syng GBWT (syng_ffi.rs:151
// syngBWTcreate/pathAdd/matchStart/matchNext/locFind) and its MEM driver
// (syng.rs:4022 gbwt_mems_for_walk).  The C structure is a dynamic
// run-length BWT over oriented syncmer nodes with sampled-position
// sidecars (.spos/.pstep) for locate.
//
// This implementation keeps the same *contract* — exact maximal-exact-match
// step ranges, per-match occurrence counts, and (path, step, bp) locate —
// on a flat SoA layout instead of an FM-index:
//   * every indexed sequence's forward syncmer walk is stored once as
//     (signed node, bp position) arrays; the reference inserts each
//     sequence twice (forward + reverse complement, syng.rs:2598-2650) —
//     here the reverse orientation is served by walking the same arrays
//     backwards with negated node signs, which is equivalent by
//     construction of the offset keying.
//   * per unsigned node id, a visit list (global step indices, ordered by
//     (path, step)) replaces BWT rank ranges; a match state is the explicit
//     anchor list filtered step by step.  Occurrence counts and locate
//     fall out directly; the trade-off is O(|anchors|) per extension
//     instead of O(log), which upstream seed-frequency filters keep small
//     (mirroring the reference's own seed filtering, syng.rs:1866).
//
// Scaling measurement (round 2, C4-scale panel: 90 haplotypes x 77 kb =
// 6.9 Mb, 150 bp read MEM matching, 4-core host): 12.8k reads/s on
// unique-ish content; 4.7k reads/s when 40% of every haplotype is one
// shared 171 bp tandem unit (visit lists ~16k entries/node); 1.8k
// reads/s with reads drawn entirely from that repeat ocean.  The
// adversarial regime costs ~7x, not orders of magnitude — acceptable
// against the run-length-BWT alternative given the seed filters.
//
// Exposed via C ABI for ctypes (see impg_tpu/syng/gbwt.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct GbwtIndex {
    int64_t n_paths = 0;
    int32_t n_node_ids = 0;  // dense unsigned ids are 1..n_node_ids
    std::vector<int64_t> path_offsets;  // [n_paths + 1] into steps
    std::vector<int32_t> nodes;         // [S] signed dense node per step
    std::vector<uint64_t> bpos;         // [S] bp position of step on its path
    std::vector<int32_t> step_path;     // [S] path id per step
    // Visit lists: steps bucketed by |node|, ordered by (path, step).
    std::vector<int64_t> visit_offsets;  // [n_node_ids + 2]
    std::vector<int64_t> visit_steps;    // [S]
};

struct Anchor {
    int64_t step;  // global step index of the *current* (latest) matched node
    int8_t dir;    // +1: walk follows the stored path forward; -1: backward
};

// Match state = explicit anchor list (replaces the C GBWT's (low, high)
// rank range; counts and locate read off the list directly).
using MatchState = std::vector<Anchor>;

bool valid_node(const GbwtIndex& g, int32_t signed_node) {
    int32_t a = signed_node < 0 ? -signed_node : signed_node;
    return signed_node != 0 && a >= 1 && a <= g.n_node_ids;
}

// All visits of `signed_node`: stored steps whose node matches the sign
// read forward, plus steps whose node is the negation read backward.
void start_match(const GbwtIndex& g, int32_t signed_node, MatchState& out) {
    out.clear();
    if (!valid_node(g, signed_node)) return;
    int32_t a = signed_node < 0 ? -signed_node : signed_node;
    int64_t lo = g.visit_offsets[a], hi = g.visit_offsets[a + 1];
    for (int64_t i = lo; i < hi; ++i) {
        int64_t s = g.visit_steps[i];
        if (g.nodes[s] == signed_node) out.push_back({s, +1});
        if (g.nodes[s] == -signed_node) out.push_back({s, -1});
    }
}

// Filter anchors by one walk step: successor must be `signed_node` at bp
// distance `offset` (the (node, offset) edge keying of syngBWTmatchNext).
bool advance_match(const GbwtIndex& g, MatchState& st, int32_t signed_node,
                   uint32_t offset) {
    if (!valid_node(g, signed_node)) return false;
    size_t w = 0;
    for (const Anchor& an : st) {
        if (an.dir > 0) {
            int64_t t = an.step + 1;
            if (t < (int64_t)g.nodes.size() && g.step_path[t] == g.step_path[an.step] &&
                g.nodes[t] == signed_node && g.bpos[t] - g.bpos[an.step] == offset) {
                st[w++] = {t, +1};
            }
        } else {
            int64_t t = an.step - 1;
            if (t >= 0 && g.step_path[t] == g.step_path[an.step] &&
                g.nodes[t] == -signed_node && g.bpos[an.step] - g.bpos[t] == offset) {
                st[w++] = {t, -1};
            }
        }
    }
    if (w == 0) return false;  // mismatch: caller keeps the previous state
    st.resize(w);
    return true;
}

constexpr uint64_t OFFSET_INVALID = ~0ull;

// walk_step_offset (syng.rs:3856): bp delta, must be a non-negative u32.
uint64_t step_offset(uint64_t prev_bp, uint64_t next_bp) {
    if (next_bp < prev_bp) return OFFSET_INVALID;
    uint64_t d = next_bp - prev_bp;
    if (d > 0xFFFFFFFFull) return OFFSET_INVALID;
    return d;
}

}  // namespace

extern "C" {

void* impg_gbwt_build(int64_t n_paths, const int64_t* path_offsets,
                      const int32_t* nodes, const uint64_t* bpos,
                      int32_t n_node_ids) {
    auto* g = new GbwtIndex();
    g->n_paths = n_paths;
    g->n_node_ids = n_node_ids;
    int64_t S = path_offsets[n_paths];
    g->path_offsets.assign(path_offsets, path_offsets + n_paths + 1);
    g->nodes.assign(nodes, nodes + S);
    g->bpos.assign(bpos, bpos + S);
    g->step_path.resize(S);
    for (int64_t p = 0; p < n_paths; ++p) {
        for (int64_t s = path_offsets[p]; s < path_offsets[p + 1]; ++s) {
            g->step_path[s] = (int32_t)p;
        }
    }
    // Counting sort of steps by |node|; step order inside a bucket is
    // (path, step) because steps are scanned in global order.
    g->visit_offsets.assign((size_t)n_node_ids + 2, 0);
    for (int64_t s = 0; s < S; ++s) {
        int32_t a = g->nodes[s] < 0 ? -g->nodes[s] : g->nodes[s];
        if (a >= 1 && a <= n_node_ids) g->visit_offsets[a + 1]++;
    }
    for (int32_t a = 1; a <= n_node_ids + 1; ++a) {
        g->visit_offsets[a] += g->visit_offsets[a - 1];
    }
    g->visit_steps.resize(S);
    std::vector<int64_t> cursor(g->visit_offsets.begin(), g->visit_offsets.end());
    for (int64_t s = 0; s < S; ++s) {
        int32_t a = g->nodes[s] < 0 ? -g->nodes[s] : g->nodes[s];
        if (a >= 1 && a <= n_node_ids) g->visit_steps[cursor[a]++] = s;
    }
    return g;
}

void impg_gbwt_destroy(void* handle) { delete (GbwtIndex*)handle; }

int64_t impg_gbwt_num_steps(void* handle) {
    return (int64_t)((GbwtIndex*)handle)->nodes.size();
}

// Occurrence count of a signed node (both stored orientations contribute,
// mirroring the dual-path insertion of the reference).
int64_t impg_gbwt_node_count(void* handle, int32_t signed_node) {
    auto* g = (GbwtIndex*)handle;
    MatchState st;
    start_match(*g, signed_node, st);
    return (int64_t)st.size();
}

// Maximal exact matches of a signed walk (syng.rs:4022 gbwt_mems_for_walk).
// walk_nodes[i] == 0 marks an invalid/unmatched step.  Outputs one row per
// raw candidate MEM (pre-pruning): [step_start, step_end, occurrences].
// Caller must size the out arrays to at least n_steps + 1 rows.
// Returns the number of candidate MEMs.
int64_t impg_gbwt_match_walk(void* handle, const int32_t* walk_nodes,
                             const uint64_t* walk_bpos, int64_t n_steps,
                             int64_t* mem_step_start, int64_t* mem_step_end,
                             int64_t* mem_occ) {
    auto* g = (GbwtIndex*)handle;
    int64_t n_mems = 0;
    MatchState st;
    bool active = false;
    int64_t active_start = 0, run_start = 0;

    auto push_mem = [&](int64_t start, int64_t end) {
        if (start >= end || st.empty()) return;
        mem_step_start[n_mems] = start;
        mem_step_end[n_mems] = end;
        mem_occ[n_mems] = (int64_t)st.size();
        ++n_mems;
    };

    // restart_gbwt_match_at_suffix (syng.rs:3967): reverse-search the
    // longest suffix of the failed run that still matches, then re-match
    // it forward.  Returns the new active_start or -1.
    MatchState rev;
    auto restart_at_suffix = [&](int64_t current) -> int64_t {
        start_match(*g, -walk_nodes[current], rev);
        if (rev.empty()) return -1;
        int64_t suffix_start = current;
        while (suffix_start > run_start) {
            int64_t prev = suffix_start - 1;
            uint64_t off = step_offset(walk_bpos[prev], walk_bpos[suffix_start]);
            if (off == OFFSET_INVALID) break;
            if (!advance_match(*g, rev, -walk_nodes[prev], (uint32_t)off)) break;
            suffix_start = prev;
        }
        start_match(*g, walk_nodes[suffix_start], st);
        if (st.empty()) return -1;
        for (int64_t next = suffix_start + 1; next <= current; ++next) {
            uint64_t off = step_offset(walk_bpos[next - 1], walk_bpos[next]);
            if (off == OFFSET_INVALID) return -1;
            if (!advance_match(*g, st, walk_nodes[next], (uint32_t)off)) return -1;
        }
        return suffix_start;
    };

    for (int64_t idx = 0; idx < n_steps; ++idx) {
        if (!valid_node(*g, walk_nodes[idx])) {
            if (active) {
                push_mem(active_start, idx);
                active = false;
            }
            run_start = idx + 1;
            continue;
        }
        if (!active) {
            start_match(*g, walk_nodes[idx], st);
            if (st.empty()) {
                run_start = idx + 1;
                continue;
            }
            active = true;
            active_start = idx;
            run_start = idx;
            continue;
        }
        uint64_t off = step_offset(walk_bpos[idx - 1], walk_bpos[idx]);
        if (off == OFFSET_INVALID) {
            push_mem(active_start, idx);
            start_match(*g, walk_nodes[idx], st);
            if (st.empty()) {
                active = false;
                run_start = idx + 1;
            } else {
                active_start = idx;
                run_start = idx;
            }
            continue;
        }
        MatchState saved = st;
        if (advance_match(*g, st, walk_nodes[idx], (uint32_t)off)) continue;
        st = saved;
        push_mem(active_start, idx);
        int64_t restarted = restart_at_suffix(idx);
        if (restarted >= 0) {
            active_start = restarted;
        } else {
            active = false;
            run_start = idx + 1;
        }
    }
    if (active) push_mem(active_start, n_steps);
    return n_mems;
}

// Locate all occurrences of the walk segment [start, end): outputs, per
// anchor, the stored path id, the global step index of the *final* segment
// node's visit, and the direction (+1 forward / -1 backward).  Returns the
// anchor count (clipped to max_out), or -1 on an unmatched segment.
int64_t impg_gbwt_locate_segment(void* handle, const int32_t* walk_nodes,
                                 const uint64_t* walk_bpos, int64_t start,
                                 int64_t end, int32_t* out_paths,
                                 int64_t* out_steps, int8_t* out_dirs,
                                 int64_t max_out) {
    auto* g = (GbwtIndex*)handle;
    if (start >= end) return -1;
    MatchState st;
    start_match(*g, walk_nodes[start], st);
    if (st.empty()) return -1;
    for (int64_t i = start + 1; i < end; ++i) {
        uint64_t off = step_offset(walk_bpos[i - 1], walk_bpos[i]);
        if (off == OFFSET_INVALID) return -1;
        if (!advance_match(*g, st, walk_nodes[i], (uint32_t)off)) return -1;
    }
    int64_t n = (int64_t)st.size();
    int64_t emit = n < max_out ? n : max_out;
    for (int64_t i = 0; i < emit; ++i) {
        out_paths[i] = g->step_path[st[i].step];
        out_steps[i] = st[i].step;
        out_dirs[i] = st[i].dir;
    }
    return n;
}

}  // extern "C"
