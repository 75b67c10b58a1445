// The port's copy of impg_tpu/native/visited.cpp, built by
// impg_tpu_torch/io/native.py (tests/test_torch_host.py holds the two equal).
// Visited-range bookkeeping for transitive walks (native hot path).
//
// Role model: the reference's SortedRanges (impg.rs:242-369) and the
// per-hit visited bookkeeping of query_transitive_bfs (impg.rs:2505-2545
// proximity check + insert-returning-uncovered).  The Python
// core/intervals.py SortedRanges remains the semantics oracle; the engine
// always uses min_distance=0 on insert, so of the snap rules only the
// end-of-sequence clamp stays active (see insert_range), and proximity is
// a separate pre-check.
//
// The batched API processes one depth's hits in order for MANY walks at
// once: each hit optionally (book flag) runs the too-close pre-check and
// the visited insert, and uncovered sub-ranges long enough to keep walking
// accumulate as the next frontier, exactly mirroring the Python loop in
// query/engine.py query_transitive_bfs_many.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using Range = std::pair<int64_t, int64_t>;
using Book = std::vector<Range>;

struct Entry {
    Book ranges;
    int64_t seq_len = 0;  // end-of-sequence clamp (SortedRanges snap)
};

struct VisitedBook {
    // key = walk * KEY_SHIFT + seq_id
    std::unordered_map<int64_t, Entry> books;
    std::vector<int64_t> seq_lens;  // per seq id (real lengths)
    bool masked_none = true;        // entry-creation length rule
    std::vector<int64_t> fw, fq, fs, fe;  // frontier accumulator
};

constexpr int64_t KEY_SHIFT = 1ll << 32;

inline size_t search_start(const Book& b, int64_t start) {
    return std::lower_bound(
               b.begin(), b.end(), start,
               [](const Range& r, int64_t v) { return r.first < v; }) -
           b.begin();
}

// Mirror of SortedRanges.insert with min_distance == 0: the END snaps to
// the entry's sequence_length (impg.rs:294 `end > len - min_dist` clamp —
// active even at min_distance 0, and the mechanism by which sequences
// absent from a supplied mask dict are suppressed, since their entries
// carry length 0 exactly like the reference, impg.rs:2047-2053); returns
// the sub-ranges of [start, end) not already covered, then merges.
void insert_range(Entry& e, int64_t start, int64_t end,
                  std::vector<Range>& uncovered) {
    Book& b = e.ranges;
    uncovered.clear();
    if (start > end) std::swap(start, end);
    if (end > e.seq_len) end = e.seq_len;

    int64_t current = start;
    size_t i = search_start(b, start);
    if (i > 0 && b[i - 1].second > start) --i;
    while (i < b.size() && current < end) {
        int64_t r_start = b[i].first, r_end = b[i].second;
        if (r_start > end) break;
        if (current < r_start) uncovered.push_back({current, r_start});
        current = std::max(current, r_end);
        ++i;
    }
    if (current < end) uncovered.push_back({current, end});

    size_t pos = search_start(b, start);
    if (pos > 0 && b[pos - 1].second >= start) {
        b[pos - 1].second = std::max(b[pos - 1].second, end);
        pos -= 1;
    } else if (pos < b.size() && end >= b[pos].first) {
        b[pos].first = std::min(start, b[pos].first);
        b[pos].second = std::max(end, b[pos].second);
    } else {
        b.insert(b.begin() + pos, {start, end});
        return;  // no merge needed for a fresh disjoint range
    }
    // Merge forward while the grown range swallows successors.
    size_t j = pos + 1;
    while (j < b.size() && b[j].first <= b[pos].second) {
        b[pos].second = std::max(b[pos].second, b[j].second);
        ++j;
    }
    if (j > pos + 1) b.erase(b.begin() + pos + 1, b.begin() + j);
}

// Mirror of engine._too_close (impg.rs:2505-2545 proximity pre-check).
bool too_close(const Book& b, int64_t lo, int64_t hi, int64_t min_dist) {
    if (min_dist <= 0) return false;
    size_t idx = search_start(b, lo);
    if (idx > 0 && std::llabs(lo - b[idx - 1].second) < min_dist) return true;
    if (idx < b.size() && std::llabs(b[idx].first - hi) < min_dist)
        return true;
    return false;
}

}  // namespace

extern "C" {

// seq_lens: real sequence lengths per id; masked_none selects the length
// rule for lazily-created entries (real length when no mask dict was
// supplied, 0 otherwise — the reference's visited_entry contract).
void* vb_create(int64_t n_seqs, const int64_t* seq_lens,
                int32_t masked_none) {
    auto* v = new VisitedBook();
    v->seq_lens.assign(seq_lens, seq_lens + n_seqs);
    v->masked_none = masked_none != 0;
    return v;
}

static Entry& get_entry(VisitedBook* v, int64_t walk, int64_t qid) {
    int64_t key = walk * KEY_SHIFT + qid;
    auto it = v->books.find(key);
    if (it != v->books.end()) return it->second;
    Entry& e = v->books[key];
    e.seq_len = (v->masked_none && qid >= 0 &&
                 qid < (int64_t)v->seq_lens.size())
                    ? v->seq_lens[qid]
                    : 0;
    return e;
}
void vb_destroy(void* h) { delete (VisitedBook*)h; }

// Masked-region preload: plain insert, result discarded.  `seq_len` sets
// the entry's clamp length (the mask entry's own sequence_length, as a
// Python-side clone would keep it).
void vb_preload(void* h, int64_t walk, int64_t qid, int64_t s, int64_t e,
                int64_t seq_len) {
    auto* v = (VisitedBook*)h;
    int64_t key = walk * KEY_SHIFT + qid;
    auto it = v->books.find(key);
    if (it == v->books.end()) {
        v->books[key].seq_len = seq_len;
    }
    std::vector<Range> scratch;
    insert_range(v->books[key], s, e, scratch);
}

// Seed insert: returns the uncovered sub-ranges (capped at cap).
int64_t vb_seed(void* h, int64_t walk, int64_t qid, int64_t s, int64_t e,
                int64_t* out_s, int64_t* out_e, int64_t cap) {
    auto* v = (VisitedBook*)h;
    std::vector<Range> uncovered;
    insert_range(get_entry(v, walk, qid), s, e, uncovered);
    int64_t n = (int64_t)uncovered.size();
    for (int64_t i = 0; i < n && i < cap; ++i) {
        out_s[i] = uncovered[i].first;
        out_e[i] = uncovered[i].second;
    }
    return n;
}

// Bulk seed: insert walk[i]'s range (qid[i], s[i], e[i]) for every i in
// order; ALL uncovered sub-ranges (no length filter — seeds become result
// rows regardless) accumulate into the frontier vectors tagged by
// (walk, qid).  Fetch with vb_frontier_size/fetch, then clear.  Replaces
// one ctypes round trip per walk with one per batch.
void vb_seed_many(void* h, const int64_t* walk, const int64_t* qid,
                  const int64_t* s, const int64_t* e, int64_t n) {
    auto* v = (VisitedBook*)h;
    std::vector<Range> uncovered;
    for (int64_t i = 0; i < n; ++i) {
        insert_range(get_entry(v, walk[i], qid[i]), s[i], e[i], uncovered);
        for (const Range& r : uncovered) {
            v->fw.push_back(walk[i]);
            v->fq.push_back(qid[i]);
            v->fs.push_back(r.first);
            v->fe.push_back(r.second);
        }
    }
}

// One depth's hits, in order.  book[i] == 0 skips bookkeeping entirely
// (self-target or subset-filtered hits).  Frontier entries accumulate
// internally; fetch with vb_frontier_*.
extern "C++" template <typename T>
void vb_process_impl(VisitedBook* v, const T* walk, const T* qid,
                     const T* aq_s, const T* aq_e,
                     const uint8_t* book, int64_t n, int64_t min_dist,
                     int64_t min_trans_len) {
    std::vector<Range> uncovered;
    for (int64_t i = 0; i < n; ++i) {
        if (!book[i]) continue;
        Entry& e = get_entry(v, walk[i], qid[i]);
        int64_t lo = aq_s[i], hi = aq_e[i];
        if (lo > hi) std::swap(lo, hi);
        if (too_close(e.ranges, lo, hi, min_dist)) continue;
        insert_range(e, aq_s[i], aq_e[i], uncovered);
        for (const Range& r : uncovered) {
            if (std::llabs(r.second - r.first) >= min_trans_len) {
                v->fw.push_back(walk[i]);
                v->fq.push_back(qid[i]);
                v->fs.push_back(r.first);
                v->fe.push_back(r.second);
            }
        }
    }
}

void vb_process(void* h, const int64_t* walk, const int64_t* qid,
                const int64_t* aq_s, const int64_t* aq_e,
                const uint8_t* book, int64_t n, int64_t min_dist,
                int64_t min_trans_len) {
    vb_process_impl((VisitedBook*)h, walk, qid, aq_s, aq_e, book, n,
                    min_dist, min_trans_len);
}

// int32 ABI twin: the device engine returns int32 columns, so taking them
// directly keeps the whole host pipeline 32-bit (no widening pass per
// chunk).  Coordinates are guaranteed < 2^31 by the index upload checks;
// the caller falls back to the 64-bit entry points otherwise.
void vb_process32(void* h, const int32_t* walk, const int32_t* qid,
                  const int32_t* aq_s, const int32_t* aq_e,
                  const uint8_t* book, int64_t n, int64_t min_dist,
                  int64_t min_trans_len) {
    vb_process_impl((VisitedBook*)h, walk, qid, aq_s, aq_e, book, n,
                    min_dist, min_trans_len);
}

int64_t vb_frontier_size(void* h) {
    return (int64_t)((VisitedBook*)h)->fw.size();
}

void vb_frontier_fetch(void* h, int64_t* w, int64_t* q, int64_t* s,
                       int64_t* e) {
    auto* v = (VisitedBook*)h;
    std::copy(v->fw.begin(), v->fw.end(), w);
    std::copy(v->fq.begin(), v->fq.end(), q);
    std::copy(v->fs.begin(), v->fs.end(), s);
    std::copy(v->fe.begin(), v->fe.end(), e);
}

void vb_frontier_fetch32(void* h, int32_t* w, int32_t* q, int32_t* s,
                         int32_t* e) {
    auto* v = (VisitedBook*)h;
    size_t n = v->fw.size();
    for (size_t i = 0; i < n; ++i) {
        w[i] = (int32_t)v->fw[i];
        q[i] = (int32_t)v->fq[i];
        s[i] = (int32_t)v->fs[i];
        e[i] = (int32_t)v->fe[i];
    }
}

void vb_frontier_clear(void* h) {
    auto* v = (VisitedBook*)h;
    v->fw.clear();
    v->fq.clear();
    v->fs.clear();
    v->fe.clear();
}

}  // extern "C"
