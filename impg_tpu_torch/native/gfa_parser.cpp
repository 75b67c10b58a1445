// Native GFA tokenizer -> columnar arrays (the graph-layer twin of
// paf_parser.cpp).
//
// The port's copy of impg_tpu/native/gfa_parser.cpp, built into the port's
// native host library (io/native.py); tests/test_torch_sortgfa.py holds the
// columns equal.
//
// Role model: the reference's crush GFA parse hot path
// (docs/crush-perf-report.md: 115 MiB blunt GFA in ~50 ms after
// optimization).  Produces struct-of-arrays output:
//   * one interned name table (segments, link endpoints, path steps)
//   * segment sequences as a single blob + offsets
//   * links as (a_idx, a_rev, b_idx, b_rev)
//   * paths as CSR (path_off -> step_name_idx / step_rev) with names,
//     W lines converted to PanSN-range path names (graph/gfa.py contract)
//
// Semantics mirror graph/gfa.py Gfa.parse EXACTLY (it remains the oracle):
// malformed lines with too few fields are skipped, the LAST H line wins,
// P steps drop their final orientation char whatever it is and rev is
// (last char == '-'), empty step tokens are skipped, S tags and L
// overlaps are ignored (blunt 0M contract), '#' comments skipped, and a
// bad W walk orientation is a hard error.
//
// Parallel path (impg_gfa_parse_mt): the buffer is split at line
// boundaries into one chunk per thread; each thread runs the identical
// single-thread tokenizer with a chunk-local intern table; a sequential
// merge then re-interns each chunk's name table in chunk order (local
// first-seen order within a chunk IS file order, so the merged table
// preserves the oracle's global first-seen order exactly), after which
// every chunk remaps its index arrays through a local->global LUT in
// parallel and the columns are concatenated in chunk order.

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct GfaOut {
    std::string error;
    std::string header;  // last H line (empty = default)

    // Interned names (all referenced ids, in first-seen order).
    std::string names_blob;             // concatenated
    std::vector<int64_t> name_offsets;  // n_names + 1

    // Segments.
    std::vector<int32_t> seg_name_idx;
    std::string seq_blob;
    std::vector<int64_t> seq_offsets;  // n_segs + 1

    // Links.
    std::vector<int32_t> link_a, link_b;
    std::vector<int8_t> link_a_rev, link_b_rev;

    // Paths (CSR).
    std::string path_names_blob;
    std::vector<int64_t> path_name_offsets;  // n_paths + 1
    std::vector<int8_t> path_is_walk;
    std::vector<int64_t> path_off;  // n_paths + 1
    std::vector<int32_t> step_name_idx;
    std::vector<int8_t> step_rev;

    std::unordered_map<std::string_view, int32_t> intern;
    // Fast intern for canonical decimal names (the overwhelmingly common
    // case: numeric node ids): value -> idx + 1, 0 = absent.  Capped so a
    // stray huge id can't balloon memory; overflow falls to the hash map.
    std::vector<int32_t> numeric_intern;
    static constexpr uint32_t kNumericCap = 1u << 25;  // 32M ids, 128 MB max

    void init(size_t len_hint) {
        name_offsets.push_back(0);
        seq_offsets.push_back(0);
        path_name_offsets.push_back(0);
        path_off.push_back(0);
        seq_blob.reserve(len_hint / 2);
        names_blob.reserve(len_hint / 32 + 1024);
        step_name_idx.reserve(len_hint / 16 + 1024);
        step_rev.reserve(len_hint / 16 + 1024);
    }

    int32_t add_name(std::string_view s) {
        int32_t idx = (int32_t)(name_offsets.size() - 1);
        names_blob.append(s);
        name_offsets.push_back((int64_t)names_blob.size());
        return idx;
    }

    int32_t intern_name(std::string_view s) {
        // Canonical decimal (no leading zeros except "0") up to 9 digits.
        if (!s.empty() && s.size() <= 9 &&
            (s[0] != '0' || s.size() == 1)) {
            uint32_t v = 0;
            bool numeric = true;
            for (char c : s) {
                if (c < '0' || c > '9') {
                    numeric = false;
                    break;
                }
                v = v * 10 + (uint32_t)(c - '0');
            }
            if (numeric && v < kNumericCap) {
                if (v >= numeric_intern.size()) {
                    size_t grow = numeric_intern.empty()
                                      ? 1024
                                      : numeric_intern.size() * 2;
                    numeric_intern.resize(
                        std::max<size_t>(grow, (size_t)v + 1), 0);
                }
                int32_t& slot = numeric_intern[v];
                if (slot == 0) slot = add_name(s) + 1;
                return slot - 1;
            }
        }
        auto it = intern.find(s);
        if (it != intern.end()) return it->second;
        int32_t idx = add_name(s);
        // string_view into names_blob would dangle on realloc; key views
        // must point into the INPUT buffer, which outlives the parse.
        intern.emplace(s, idx);
        return idx;
    }

    void parse_range(const char* data, const char* end);
};

// Split a line into tab-separated fields (mirrors str.split("\t")).
inline void split_fields(const char* line, const char* lend,
                         std::vector<std::string_view>& out) {
    out.clear();
    const char* s = line;
    for (const char* p = line; p <= lend; ++p) {
        if (p == lend || *p == '\t') {
            out.emplace_back(s, (size_t)(p - s));
            s = p + 1;
        }
    }
}

// Next tab within [p, lend), or nullptr.
inline const char* next_tab(const char* p, const char* lend) {
    return (const char*)memchr(p, '\t', (size_t)(lend - p));
}

void GfaOut::parse_range(const char* data, const char* end) {
    const char* p = data;
    std::vector<std::string_view> f;
    while (p < end) {
        const char* line = p;
        const char* eol = (const char*)memchr(p, '\n', (size_t)(end - p));
        const char* lend = eol ? eol : end;
        if (lend > line && lend[-1] == '\r') --lend;
        p = eol ? eol + 1 : end;
        if (line == lend || *line == '#') continue;
        char kind = *line;
        if (kind != 'H' && kind != 'S' && kind != 'L' && kind != 'P' &&
            kind != 'W')
            continue;
        // S/P/W carry one huge field (sequence / step list / walk);
        // locate the small leading fields with memchr instead of a
        // whole-line split_fields pass.  Field semantics are identical:
        // f[0].size()==1 <=> the line's second byte is a tab (or the
        // line is the single char, which always fails the arity check).
        if (kind == 'S' || kind == 'P' || kind == 'W') {
            if (line + 1 >= lend || line[1] != '\t') continue;
        } else {
            split_fields(line, lend, f);
            if (f[0].size() != 1) continue;
        }
        if (kind == 'H') {
            header.assign(line, (size_t)(lend - line));
        } else if (kind == 'S') {
            const char* t2 = next_tab(line + 2, lend);
            if (!t2) continue;  // f.size() < 3
            const char* t3 = next_tab(t2 + 1, lend);
            const char* send = t3 ? t3 : lend;
            seg_name_idx.push_back(
                intern_name(std::string_view(line + 2, (size_t)(t2 - line - 2))));
            seq_blob.append(t2 + 1, (size_t)(send - t2 - 1));
            seq_offsets.push_back((int64_t)seq_blob.size());
        } else if (kind == 'L' && f.size() >= 6) {
            link_a.push_back(intern_name(f[1]));
            link_a_rev.push_back(f[2] == "-" ? 1 : 0);
            link_b.push_back(intern_name(f[3]));
            link_b_rev.push_back(f[4] == "-" ? 1 : 0);
        } else if (kind == 'P') {
            const char* t2 = next_tab(line + 2, lend);
            if (!t2) continue;  // f.size() < 3
            const char* t3 = next_tab(t2 + 1, lend);
            const char* send = t3 ? t3 : lend;
            path_names_blob.append(line + 2, (size_t)(t2 - line - 2));
            path_name_offsets.push_back((int64_t)path_names_blob.size());
            path_is_walk.push_back(0);
            const char* sp = t2 + 1;
            while (sp < send) {
                const char* tok = sp;
                while (sp < send && *sp != ',') ++sp;
                size_t tl = (size_t)(sp - tok);
                if (sp < send) ++sp;  // skip comma
                if (tl == 0) continue;
                bool rev = tok[tl - 1] == '-';
                step_name_idx.push_back(
                    intern_name(std::string_view(tok, tl - 1)));
                step_rev.push_back(rev ? 1 : 0);
            }
            path_off.push_back((int64_t)step_name_idx.size());
        } else if (kind == 'W') {
            // W sample hap seq start end walk [tags] — six tabs minimum.
            std::string_view wf[6];
            const char* cur = line + 2;
            bool ok = true;
            for (int i = 0; i < 5; ++i) {
                const char* t = next_tab(cur, lend);
                if (!t) {
                    ok = false;  // f.size() < 7
                    break;
                }
                wf[i] = std::string_view(cur, (size_t)(t - cur));
                cur = t + 1;
            }
            if (!ok) continue;
            const char* t7 = next_tab(cur, lend);
            wf[5] = std::string_view(cur, (size_t)((t7 ? t7 : lend) - cur));
            std::string nm;
            nm.reserve(wf[0].size() + wf[1].size() + wf[2].size() +
                       wf[3].size() + wf[4].size() + 4);
            nm.append(wf[0]);
            nm.push_back('#');
            nm.append(wf[1]);
            nm.push_back('#');
            nm.append(wf[2]);
            nm.push_back(':');
            nm.append(wf[3]);
            nm.push_back('-');
            nm.append(wf[4]);
            path_names_blob.append(nm);
            path_name_offsets.push_back((int64_t)path_names_blob.size());
            path_is_walk.push_back(1);
            const char* sp = wf[5].data();
            const char* send = sp + wf[5].size();
            while (sp < send) {
                char orient = *sp;
                if (orient != '>' && orient != '<') {
                    error = "invalid W walk orientation";
                    return;
                }
                const char* tok = ++sp;
                while (sp < send && *sp != '>' && *sp != '<') ++sp;
                step_name_idx.push_back(intern_name(
                    std::string_view(tok, (size_t)(sp - tok))));
                step_rev.push_back(orient == '<' ? 1 : 0);
            }
            path_off.push_back((int64_t)step_name_idx.size());
        }
    }
}

}  // namespace

extern "C" {

void* impg_gfa_parse(const char* data, size_t len) {
    auto* o = new GfaOut();
    o->init(len);
    o->parse_range(data, data + len);
    // Keys view into the caller's buffer, which dies after this call.
    o->intern.clear();
    return o;
}

// Parallel variant. threads <= 0 selects a hardware default; the result
// is bit-identical to impg_gfa_parse for any thread count.
void* impg_gfa_parse_mt(const char* data, size_t len, int32_t threads) {
    int nt = threads > 0 ? threads
                         : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
    // Auto mode: don't spin threads for small inputs (>=4 MB per chunk).
    // An explicit thread count is honored regardless of size so tests can
    // exercise the parallel merge on small fixtures.
    if (threads <= 0 && (size_t)nt > len / (4 << 20) + 1)
        nt = (int)(len / (4 << 20) + 1);
    if (nt == 1) return impg_gfa_parse(data, len);

    // More chunks than threads: line kinds cluster (S first, P/W step
    // lists — the expensive part — at the end), so equal byte ranges
    // would leave most threads idle.  A shared atomic cursor balances.
    int oversub = 2;
    if (const char* e = getenv("IMPG_GFA_OVERSUB")) {
        int v = atoi(e);
        if (v >= 1 && v <= 64) oversub = v;
    }
    int nc = nt * oversub;
    if ((size_t)nc > len / (2 << 20) + 1)
        nc = (int)(len / (2 << 20) + 1);
    if (nc < nt) nc = nt;

    // Chunk boundaries on line starts.
    std::vector<const char*> bounds(nc + 1);
    bounds[0] = data;
    bounds[nc] = data + len;
    for (int i = 1; i < nc; ++i) {
        const char* p = data + len * (size_t)i / nc;
        if (p < bounds[i - 1]) p = bounds[i - 1];
        const char* nl =
            (const char*)memchr(p, '\n', (size_t)(data + len - p));
        bounds[i] = nl ? nl + 1 : data + len;
    }

    std::vector<GfaOut> locals(nc);
    {
        std::atomic<int> cursor{0};
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int i = 0; i < nt; ++i) {
            pool.emplace_back([&] {
                for (;;) {
                    int c = cursor.fetch_add(1);
                    if (c >= nc) return;
                    locals[c].init((size_t)(bounds[c + 1] - bounds[c]));
                    locals[c].parse_range(bounds[c], bounds[c + 1]);
                }
            });
        }
        for (auto& t : pool) t.join();
    }
    const int n_workers = nt;
    nt = nc;  // the merge below walks per-chunk state

    auto* o = new GfaOut();
    o->name_offsets.push_back(0);
    o->seq_offsets.push_back(0);
    o->path_name_offsets.push_back(0);
    o->path_off.push_back(0);

    for (auto& loc : locals) {
        if (!loc.error.empty()) {  // earliest (file-order) error wins
            o->error = loc.error;
            return o;
        }
        if (!loc.header.empty()) o->header = loc.header;  // last H wins
    }

    // Global intern in chunk order: a chunk's local first-seen order is
    // its file order, so names whose first global occurrence falls in
    // this chunk land at exactly the single-thread index.
    std::vector<std::vector<int32_t>> luts(nt);
    size_t total_names = 0;
    for (auto& loc : locals) total_names += loc.name_offsets.size() - 1;
    o->names_blob.reserve(total_names * 8);
    o->intern.reserve(total_names);
    for (int c = 0; c < nt; ++c) {
        GfaOut& loc = locals[c];
        size_t n = loc.name_offsets.size() - 1;
        luts[c].resize(n);
        for (size_t i = 0; i < n; ++i) {
            std::string_view nm(
                loc.names_blob.data() + loc.name_offsets[i],
                (size_t)(loc.name_offsets[i + 1] - loc.name_offsets[i]));
            // Keys view into the locals' blobs, which outlive the merge.
            luts[c][i] = o->intern_name(nm);
        }
    }

    // Per-chunk base offsets (prefix sums), then one parallel pass that
    // writes every chunk's slice of every column — fusing the LUT remap
    // of index columns into the copy so the data is touched once.
    std::vector<size_t> b_step(nt + 1, 0), b_seg(nt + 1, 0),
        b_link(nt + 1, 0), b_path(nt + 1, 0), b_seq(nt + 1, 0),
        b_pnb(nt + 1, 0);
    for (int c = 0; c < nt; ++c) {
        b_step[c + 1] = b_step[c] + locals[c].step_name_idx.size();
        b_seg[c + 1] = b_seg[c] + locals[c].seg_name_idx.size();
        b_link[c + 1] = b_link[c] + locals[c].link_a.size();
        b_path[c + 1] = b_path[c] + locals[c].path_is_walk.size();
        b_seq[c + 1] = b_seq[c] + locals[c].seq_blob.size();
        b_pnb[c + 1] = b_pnb[c] + locals[c].path_names_blob.size();
    }
    o->step_name_idx.resize(b_step[nt]);
    o->step_rev.resize(b_step[nt]);
    o->seg_name_idx.resize(b_seg[nt]);
    o->seq_blob.resize(b_seq[nt]);
    o->seq_offsets.resize(b_seg[nt] + 1);
    o->link_a.resize(b_link[nt]);
    o->link_b.resize(b_link[nt]);
    o->link_a_rev.resize(b_link[nt]);
    o->link_b_rev.resize(b_link[nt]);
    o->path_names_blob.resize(b_pnb[nt]);
    o->path_name_offsets.resize(b_path[nt] + 1);
    o->path_is_walk.resize(b_path[nt]);
    o->path_off.resize(b_path[nt] + 1);
    o->seq_offsets[0] = 0;
    o->path_name_offsets[0] = 0;
    o->path_off[0] = 0;
    {
        std::atomic<int> cursor{0};
        std::vector<std::thread> pool;
        pool.reserve(n_workers);
        for (int w = 0; w < n_workers; ++w) {
            pool.emplace_back([&] {
              for (;;) {
                int c = cursor.fetch_add(1);
                if (c >= nt) return;
                GfaOut& loc = locals[c];
                const auto& lut = luts[c];
                auto remap_into = [&](const std::vector<int32_t>& src,
                                      int32_t* dst) {
                    for (size_t i = 0; i < src.size(); ++i)
                        dst[i] = lut[(size_t)src[i]];
                };
                auto copy_into = [&](const std::vector<int8_t>& src,
                                     int8_t* dst) {
                    if (!src.empty())
                        memcpy(dst, src.data(), src.size());
                };
                auto shift_into = [&](const std::vector<int64_t>& src,
                                      int64_t* dst, int64_t base) {
                    for (size_t i = 1; i < src.size(); ++i)
                        dst[i - 1] = src[i] + base;
                };
                remap_into(loc.step_name_idx,
                           o->step_name_idx.data() + b_step[c]);
                copy_into(loc.step_rev, o->step_rev.data() + b_step[c]);
                remap_into(loc.seg_name_idx,
                           o->seg_name_idx.data() + b_seg[c]);
                if (!loc.seq_blob.empty())
                    memcpy(&o->seq_blob[b_seq[c]], loc.seq_blob.data(),
                           loc.seq_blob.size());
                shift_into(loc.seq_offsets,
                           o->seq_offsets.data() + 1 + b_seg[c],
                           (int64_t)b_seq[c]);
                remap_into(loc.link_a, o->link_a.data() + b_link[c]);
                remap_into(loc.link_b, o->link_b.data() + b_link[c]);
                copy_into(loc.link_a_rev,
                          o->link_a_rev.data() + b_link[c]);
                copy_into(loc.link_b_rev,
                          o->link_b_rev.data() + b_link[c]);
                if (!loc.path_names_blob.empty())
                    memcpy(&o->path_names_blob[b_pnb[c]],
                           loc.path_names_blob.data(),
                           loc.path_names_blob.size());
                shift_into(loc.path_name_offsets,
                           o->path_name_offsets.data() + 1 + b_path[c],
                           (int64_t)b_pnb[c]);
                copy_into(loc.path_is_walk,
                          o->path_is_walk.data() + b_path[c]);
                shift_into(loc.path_off, o->path_off.data() + 1 + b_path[c],
                           (int64_t)b_step[c]);
              }
            });
        }
        for (auto& t : pool) t.join();
    }
    o->intern.clear();
    return o;
}

const char* impg_gfa_error(void* h) {
    auto* o = (GfaOut*)h;
    return o->error.empty() ? nullptr : o->error.c_str();
}
const char* impg_gfa_header(void* h) { return ((GfaOut*)h)->header.c_str(); }
int64_t impg_gfa_n_names(void* h) {
    return (int64_t)((GfaOut*)h)->name_offsets.size() - 1;
}
int64_t impg_gfa_names_size(void* h) {
    return (int64_t)((GfaOut*)h)->names_blob.size();
}
const char* impg_gfa_names_buf(void* h) {
    return ((GfaOut*)h)->names_blob.data();
}
const int64_t* impg_gfa_name_offsets(void* h) {
    return ((GfaOut*)h)->name_offsets.data();
}
int64_t impg_gfa_n_segs(void* h) {
    return (int64_t)((GfaOut*)h)->seg_name_idx.size();
}
const int32_t* impg_gfa_seg_name_idx(void* h) {
    return ((GfaOut*)h)->seg_name_idx.data();
}
int64_t impg_gfa_seq_size(void* h) {
    return (int64_t)((GfaOut*)h)->seq_blob.size();
}
const char* impg_gfa_seq_buf(void* h) { return ((GfaOut*)h)->seq_blob.data(); }
const int64_t* impg_gfa_seq_offsets(void* h) {
    return ((GfaOut*)h)->seq_offsets.data();
}
int64_t impg_gfa_n_links(void* h) {
    return (int64_t)((GfaOut*)h)->link_a.size();
}
const int32_t* impg_gfa_link_a(void* h) { return ((GfaOut*)h)->link_a.data(); }
const int32_t* impg_gfa_link_b(void* h) { return ((GfaOut*)h)->link_b.data(); }
const int8_t* impg_gfa_link_a_rev(void* h) {
    return ((GfaOut*)h)->link_a_rev.data();
}
const int8_t* impg_gfa_link_b_rev(void* h) {
    return ((GfaOut*)h)->link_b_rev.data();
}
int64_t impg_gfa_n_paths(void* h) {
    return (int64_t)((GfaOut*)h)->path_off.size() - 1;
}
int64_t impg_gfa_path_names_size(void* h) {
    return (int64_t)((GfaOut*)h)->path_names_blob.size();
}
const char* impg_gfa_path_names_buf(void* h) {
    return ((GfaOut*)h)->path_names_blob.data();
}
const int64_t* impg_gfa_path_name_offsets(void* h) {
    return ((GfaOut*)h)->path_name_offsets.data();
}
const int8_t* impg_gfa_path_is_walk(void* h) {
    return ((GfaOut*)h)->path_is_walk.data();
}
const int64_t* impg_gfa_path_off(void* h) {
    return ((GfaOut*)h)->path_off.data();
}
int64_t impg_gfa_n_steps(void* h) {
    return (int64_t)((GfaOut*)h)->step_name_idx.size();
}
const int32_t* impg_gfa_step_name_idx(void* h) {
    return ((GfaOut*)h)->step_name_idx.data();
}
const int8_t* impg_gfa_step_rev(void* h) {
    return ((GfaOut*)h)->step_rev.data();
}
void impg_gfa_free(void* h) { delete (GfaOut*)h; }

}  // extern "C"
