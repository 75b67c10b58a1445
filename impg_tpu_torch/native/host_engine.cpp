// The port's copy of impg_tpu/native/host_engine.cpp, built by
// impg_tpu_torch/io/native.py (tests/test_torch_host.py holds the two equal).
// Native transitive-query host engine: the CPU baseline of record.
//
// Purpose (bench honesty): BENCH headlines compare the TPU engine against
// the strongest CPU implementation of the same query semantics we can
// build in this image.  The reference is Rust (rayon over per-target
// coitrees + a serial per-op CIGAR walk per projection,
// impg.rs:1852-1928, 2311-2597, 2760-2898) and cannot be compiled here
// (no cargo), so this file provides two C++ stand-ins:
//
//   mode 1 "walk"   — Rust-proxy cost model: O(log n + k) interval-tree
//                     stab (coitrees role) + a LINEAR run walk from the
//                     record start to the end of the requested range per
//                     projection, exactly like the reference's
//                     project_target_range_through_alignment.  Outputs
//                     are finished with the shared closed-form boundary
//                     math, so results are identical to the engine —
//                     only the cost model mirrors the reference.
//   mode 0 "closed" — our own algorithm on CPU: the same interval-tree
//                     stab + the closed-form two-binary-search projection
//                     (ops/projection.py scalar port).  This is the
//                     strongest known CPU implementation of the query —
//                     a HARDER baseline than the reference design.
//   mode 2 "paf"    — the reference's FULL default-path cost model for
//                     PAF-backed queries: per projection, re-parse the
//                     record's ASCII CIGAR end to end (the reference
//                     materializes Vec<CigarOp> from the cg:Z: bytes on
//                     every get_cigar_ops, impg.rs:495-530 pread +
//                     :2935 parse_cigar_to_delta byte scan), then the
//                     linear run walk.  Generous to the reference: the
//                     ASCII lives in RAM (no pread syscall, no Vec
//                     allocation), only the byte scan is charged.
//
// Both modes run the full depth-limited transitive BFS with the exact
// bookkeeping semantics of query/engine.py (visited SortedRanges insert,
// too-close pre-check, frontier sort+merge), reusing visited.cpp's
// tested vb_* primitives.  Walks are data-parallel across threads
// (one walk = one unit, like the reference's rayon over BED rows).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// visited.cpp primitives (same shared object).
extern "C" {
void* vb_create(int64_t n_seqs, const int64_t* seq_lens, int32_t masked_none);
void vb_destroy(void* h);
void vb_preload(void* h, int64_t walk, int64_t qid, int64_t s, int64_t e,
                int64_t seq_len);
void vb_seed_many(void* h, const int64_t* walk, const int64_t* qid,
                  const int64_t* s, const int64_t* e, int64_t n);
void vb_process(void* h, const int64_t* walk, const int64_t* qid,
                const int64_t* aq_s, const int64_t* aq_e,
                const uint8_t* book, int64_t n, int64_t min_dist,
                int64_t min_trans_len);
int64_t vb_frontier_size(void* h);
void vb_frontier_fetch(void* h, int64_t* w, int64_t* q, int64_t* s,
                       int64_t* e);
void vb_frontier_clear(void* h);
}

namespace {

constexpr uint32_t LEN_MASK = (1u << 29) - 1;
constexpr uint32_t OP_I = 2, OP_D = 3;
// consumes_target: op != I.  (ops: 0 '=', 1 'X', 2 'I', 3 'D', 4 'M')

struct HostEngine {
    int64_t n_records = 0, n_seqs = 0, n_runs = 0;
    const int32_t *tgt = nullptr, *qid = nullptr, *ts = nullptr,
                  *te = nullptr;
    const int8_t* strand = nullptr;
    const int64_t* op_off = nullptr;
    const int32_t* op_cnt = nullptr;
    const int64_t* tgt_off = nullptr;
    const int64_t* seq_lens = nullptr;
    const uint32_t* runs = nullptr;
    const int32_t *cum_t = nullptr, *cum_q = nullptr;
    const int32_t *irb = nullptr, *ira = nullptr;
    // Identity-statistics prefix arrays ('before this run', arena.py):
    // '='/'M' bp, 'X' bp, 'I' run count, 'D' run count.
    const int32_t *cm = nullptr, *cmm = nullptr, *cic = nullptr,
                  *cdc = nullptr;
    // Per-run min-identity gate (gap-compressed, impg.rs:2952); active
    // for the duration of one he_run when >= 0.
    double min_ident = -1.0;
    // Output-only gates for one he_run: subset sequence pass/fail (rows
    // on non-subset sequences other than the walk's own target drop from
    // results AND frontier, engine.py:748) and minimum output length
    // (results only; frontier unaffected, engine.py:753).
    const uint8_t* seq_ok = nullptr;
    int64_t min_out_len = -1;
    bool approx = false;  // one-run approximate-mode flag
    // IMPG_HE_PROF=1: per-phase wall accumulators (ns) printed to
    // stderr by he_run — the reference's ad-hoc Instant span logging
    // role (SURVEY §5) for the C++ engine.
    bool prof = false;
    mutable std::atomic<int64_t> ns_stab{0}, ns_proj{0}, ns_vb{0},
        ns_front{0};
    // Tracepoint arena for --approximate (index/tracepoints.py): uniform
    // target-grid boundaries with query positions and edit/aligned
    // prefix sums; set via he_set_tracepoints.
    int32_t tp_spacing = 0;
    const int64_t* tp_off = nullptr;
    const int32_t* tp_nseg = nullptr;
    const int32_t* tp_qb = nullptr;
    const int64_t* tp_diffs = nullptr;
    const int64_t* tp_aligned = nullptr;
    const int32_t *qs_rec = nullptr, *qe_rec = nullptr;
    // Implicit-BST subtree max t_end per record position (built per target
    // segment): O(log n + k) stabs, the coitrees role
    // (reference impg.rs:394 per-target trees).
    std::vector<int32_t> submax;
    // Resident ASCII CIGAR text for mode 2 "paf" (one blob + per-record
    // offsets), regenerated from the run arena by he_build_cigar_text.
    std::vector<char> cig_text;
    std::vector<int64_t> cig_off;
    // Per-walk result rows, 6 int32 per row:
    // (q_id, q_first, q_last, t_id, t_first, t_last).
    std::vector<std::vector<int32_t>> rows;
};

int32_t build_submax(HostEngine& E, int64_t lo, int64_t hi) {
    if (lo >= hi) return INT32_MIN;
    int64_t mid = lo + (hi - lo) / 2;
    int32_t m = E.te[mid];
    m = std::max(m, build_submax(E, lo, mid));
    m = std::max(m, build_submax(E, mid + 1, hi));
    E.submax[mid] = m;
    return m;
}

// In-order interval stab over a target segment: ascending t_start order
// (ties resolve to array order), closed-interval semantics like
// ImpgIndex.stab: t_start <= end AND t_end >= start.
void stab_tree(const HostEngine& E, int64_t lo, int64_t hi, int32_t start,
               int32_t end, std::vector<int64_t>& out) {
    while (lo < hi) {
        int64_t mid = lo + (hi - lo) / 2;
        if (E.submax[mid] < start) return;  // whole subtree ends too early
        stab_tree(E, lo, mid, start, end, out);
        if (E.ts[mid] > end) return;  // mid and right subtree start too late
        if (E.te[mid] >= start) out.push_back(mid);
        lo = mid + 1;  // tail-recurse into the right subtree
    }
}

struct Proj {
    bool valid;
    int32_t pq_s, pq_e, pt_s, pt_e;
};

// Shared boundary math given the first/last candidate runs (i0, j1):
// the scalar port of ops/projection.py project_batch (same variable
// names; int32 arithmetic end to end like the batched path).
inline Proj finish(const HostEngine& E, int64_t k, int32_t rs, int32_t re,
                   int32_t i0, int32_t j1) {
    const int64_t off = E.op_off[k];
    const int32_t n = E.op_cnt[k];
    const int32_t ts_rec = E.ts[k], te_rec = E.te[k];
    const int32_t last_t = std::min(te_rec, re);
    Proj p{};
    bool has_overlap = rs < te_rec && re > ts_rec && n > 0 && rs < re;
    int32_t i0c = std::min(std::max(i0, 0), std::max(n - 1, 0));
    int32_t j1c = std::min(std::max(j1, 0), std::max(n - 1, 0));

    int32_t ts_i0 = E.cum_t[off + i0c];
    int32_t f = (ts_i0 >= rs) ? i0c - E.irb[off + i0c] : i0c;
    int32_t te_j1 = (j1c + 1 < n)
                        ? E.cum_t[off + j1c + 1]
                        : te_rec;
    int32_t l = (te_j1 <= last_t) ? j1c + E.ira[off + j1c] : j1c;

    const uint32_t run_f = E.runs[off + f];
    const uint32_t run_l = E.runs[off + l];
    const uint32_t kind_f = run_f >> 29, kind_l = run_l >> 29;
    const int32_t len_l = (int32_t)(run_l & LEN_MASK);
    const int32_t ts_f = E.cum_t[off + f], qs_f = E.cum_q[off + f];
    const int32_t ts_l = E.cum_t[off + l], qs_l = E.cum_q[off + l];
    const int32_t dir = (E.strand[k] == 0) ? 1 : -1;

    const bool is_i_f = kind_f == OP_I, is_d_f = kind_f == OP_D;
    const int32_t ov_s = std::max(ts_f, rs);
    p.pt_s = is_i_f ? ts_f : ov_s;
    p.pq_s = (is_i_f || is_d_f) ? qs_f : qs_f + (ov_s - ts_f) * dir;

    const bool is_i_l = kind_l == OP_I, is_d_l = kind_l == OP_D;
    const int32_t tdelta_l = is_i_l ? 0 : len_l;
    const int32_t te_l = ts_l + tdelta_l;
    const int32_t qdelta_l = is_d_l ? 0 : len_l * dir;
    const int32_t ov_e = std::min(te_l, re);
    p.pt_e = is_i_l ? ts_l : ov_e;
    p.pq_e = is_i_l ? qs_l + qdelta_l
                    : (is_d_l ? qs_l : qs_l + (ov_e - ts_l) * dir);

    p.valid = has_overlap && p.pq_s != p.pq_e && p.pt_s != p.pt_e && f <= l;

    // Gap-compressed identity gate (ops/projection.py slice_stat +
    // gap_compressed_identity): prefix-sum differences over [f, l] with
    // the same boundary corrections — matches/mismatches shrink by the
    // front clip and grow by the (non-positive) tail remainder; indel
    // RUN counts are not clipped.
    if (p.valid && E.min_ident >= 0.0) {
        const bool is_m_f = kind_f == 0 || kind_f == 4;
        const bool is_x_f = kind_f == 1;
        const bool is_m_l = kind_l == 0 || kind_l == 4;
        const bool is_x_l = kind_l == 1;
        const int32_t first_clip = is_i_f ? 0 : ov_s - ts_f;
        const int32_t last_rem = is_i_l ? 0 : ov_e - te_l;
        int64_t matches = (int64_t)E.cm[off + l] - E.cm[off + f] +
                          (is_m_l ? len_l : 0) - (is_m_f ? first_clip : 0) +
                          (is_m_l ? last_rem : 0);
        int64_t mm = (int64_t)E.cmm[off + l] - E.cmm[off + f] +
                     (is_x_l ? len_l : 0) - (is_x_f ? first_clip : 0) +
                     (is_x_l ? last_rem : 0);
        int64_t ic = (int64_t)E.cic[off + l] - E.cic[off + f] +
                     (is_i_l ? 1 : 0);
        int64_t dc = (int64_t)E.cdc[off + l] - E.cdc[off + f] +
                     (is_d_l ? 1 : 0);
        const int64_t total = matches + mm + ic + dc;
        const double gci =
            total > 0 ? (double)matches / (double)std::max<int64_t>(total, 1)
                      : 0.0;
        if (!(gci >= E.min_ident)) p.valid = false;
    }
    return p;
}

// Closed-form projection: two binary searches over the record's cum_t
// prefix (ops/projection.py _bisect), then the shared boundary math.
// Kept as the single-candidate SPEC for project_closed_batch below
// (which must stay bit-identical); run_walk dispatches to the batch.
Proj project_closed(const HostEngine& E, int64_t k,
                    int32_t rs, int32_t re) {
    const int64_t off = E.op_off[k];
    const int32_t n = E.op_cnt[k];
    // (te_rec unused: the stab invariant te > rs folds it out of both searches)
    const int32_t* ct = E.cum_t + off;
    // Short records (the hundreds-of-genomes regime averages ~20 runs):
    // count-based linear scans over the 1-2 cache lines the runs occupy
    // beat the binary searches' data-dependent mispredicts.
    if (n <= 64) {
        int32_t i0 = 0;
        // i0 = first run with run_te(i) > rs; run_te(i) = ct[i+1] for
        // i+1 < n else te_rec (te_rec > rs is a stab invariant).
        for (int32_t i = 1; i < n; ++i) i0 += (ct[i] <= rs);
        int32_t j1 = 0;
        for (int32_t i = 1; i < n; ++i) j1 += (ct[i] < re);
        return finish(E, k, rs, re, i0, j1);
    }
    // Long records: BRANCHLESS searches (cmov base-advance form) — the
    // classic loop's data-dependent branches mispredict half the time.
    // Both reduce to "count elements satisfying a predicate" over
    // ct[1..n): i0 = #(ct[i] <= rs) (run_te(i) = ct[i+1] for i+1 < n,
    // and run_te(n-1) = te_rec > rs by the stab invariant); j1 =
    // #(ct[i] < re) (ct[0] = t_start < re always).
    // The two searches are independent dependent-load chains; stepping
    // them in lockstep overlaps their cache-miss latencies (the arena
    // region is cold per candidate — this halves the critical path).
    const int32_t* bi = ct + 1;
    const int32_t* bj = ct + 1;
    size_t m = (size_t)n - 1;
    while (m > 1) {
        size_t half = m / 2;
        bi = (bi[half - 1] <= rs) ? bi + half : bi;
        bj = (bj[half - 1] < re) ? bj + half : bj;
        m -= half;
    }
    int32_t i0 = (int32_t)(bi - (ct + 1)) + (m >= 1 && bi[0] <= rs ? 1 : 0);
    int32_t j1 = (int32_t)(bj - (ct + 1)) + (m >= 1 && bj[0] < re ? 1 : 0);
    return finish(E, k, rs, re, i0, j1);
}

// Scratch for the batched closed projection (reused across frontiers).
struct BatchScratch {
    std::vector<int32_t> i0, j1, ovs, ove;
    std::vector<uint8_t> skip;
    struct BState {
        const int32_t* bi;
        const int32_t* bj;
        const int32_t* base;  // ct + 1
        size_t m;
        int32_t rs, re, idx;
    };
    std::vector<BState> states;
};

// Batched closed-form projection over one frontier's candidate list.
// Per-candidate results are bit-identical to project_closed; the
// long-record binary searches advance in lockstep WAVES across
// candidates so their dependent cache-miss chains overlap.  A single
// candidate's search is ~log2(runs) serialized cold loads (the
// scale-tier bottleneck: ~580 ns/row measured at ~520 runs/record,
// memory-latency-bound); a wave issues one level for EVERY active
// candidate per pass, giving the core cand-count-wide memory-level
// parallelism instead of 2 chains.
void project_closed_batch(const HostEngine& E,
                          const std::vector<int64_t>& cand, int64_t fr_s,
                          int64_t fr_e, BatchScratch& S) {
    const size_t nc = cand.size();
    S.i0.resize(nc);
    S.j1.resize(nc);
    S.ovs.resize(nc);
    S.ove.resize(nc);
    S.skip.resize(nc);
    S.states.clear();
    for (size_t c = 0; c < nc; ++c) {
        const int64_t k = cand[c];
        const int32_t ov_s = std::max((int32_t)fr_s, E.ts[k]);
        const int32_t ov_e = std::min((int32_t)fr_e, E.te[k]);
        S.ovs[c] = ov_s;
        S.ove[c] = ov_e;
        if (ov_s >= ov_e) {
            S.skip[c] = 1;
            continue;
        }
        S.skip[c] = 0;
        const int32_t n = E.op_cnt[k];
        const int32_t* ct = E.cum_t + E.op_off[k];
        if (n <= 64) {
            // Short records: count-based linear scans over the 1-2
            // cache lines the runs occupy (same as project_closed);
            // loop iterations are independent across candidates, so
            // out-of-order execution already overlaps their misses.
            int32_t i0 = 0, j1 = 0;
            for (int32_t i = 1; i < n; ++i) i0 += (ct[i] <= ov_s);
            for (int32_t i = 1; i < n; ++i) j1 += (ct[i] < ov_e);
            S.i0[c] = i0;
            S.j1[c] = j1;
        } else {
            S.states.push_back({ct + 1, ct + 1, ct + 1, (size_t)n - 1,
                                ov_s, ov_e, (int32_t)c});
        }
    }
    // Wave passes: each pass advances every active search by one
    // branchless level (cmov base-advance, as in project_closed).
    size_t na = S.states.size();
    while (na) {
        size_t w = 0;
        for (size_t t = 0; t < na; ++t) {
            BatchScratch::BState st = S.states[t];
            const size_t half = st.m / 2;
            st.bi = (st.bi[half - 1] <= st.rs) ? st.bi + half : st.bi;
            st.bj = (st.bj[half - 1] < st.re) ? st.bj + half : st.bj;
            st.m -= half;
            if (st.m > 1) {
                S.states[w++] = st;
            } else {
                S.i0[st.idx] = (int32_t)(st.bi - st.base) +
                               (st.m >= 1 && st.bi[0] <= st.rs ? 1 : 0);
                S.j1[st.idx] = (int32_t)(st.bj - st.base) +
                               (st.m >= 1 && st.bj[0] < st.re ? 1 : 0);
            }
        }
        na = w;
    }
}

// Walk projection: the reference's cost model — scan runs linearly from
// the record start, accumulating the target coordinate, until past the
// range end (impg.rs:2760-2898 walks every op before and inside the
// range).  i0/j1 fall out of the scan; outputs finish identically.
Proj project_walk(const HostEngine& E, int64_t k, int32_t rs, int32_t re) {
    const int64_t off = E.op_off[k];
    const int32_t n = E.op_cnt[k];
    const int32_t te_rec = E.te[k];
    int32_t t = E.ts[k];
    int32_t i0 = n, j1 = -1;
    for (int32_t i = 0; i < n; ++i) {
        const uint32_t run = E.runs[off + i];
        const uint32_t op = run >> 29;
        const int32_t tlen = (op == OP_I) ? 0 : (int32_t)(run & LEN_MASK);
        if (t >= re) break;  // runs from here start past the range
        const int32_t rte = (i + 1 < n) ? t + tlen : te_rec;
        if (i0 == n && rte > rs) i0 = i;
        j1 = i;  // last run with t (its start) < re
        t += tlen;
    }
    return finish(E, k, rs, re, i0, j1);
}

// PAF cost-model projection (mode 2): decode the record's WHOLE ASCII
// CIGAR byte stream — the reference's get_cigar_ops re-parses the full
// cg:Z: field on every projection (impg.rs:2935 parse_cigar_to_delta
// scans every byte before projecting) — while tracking the same i0/j1
// the walk model finds.  No early exit: the charge is the full byte
// scan, exactly like the reference's Vec<CigarOp> materialization.
Proj project_paf(const HostEngine& E, int64_t k, int32_t rs, int32_t re) {
    const char* p = E.cig_text.data() + E.cig_off[k];
    const char* end = E.cig_text.data() + E.cig_off[k + 1];
    const int32_t n = E.op_cnt[k];
    const int32_t te_rec = E.te[k];
    int32_t t = E.ts[k];
    int32_t i0 = n, j1 = -1;
    int32_t i = 0;
    bool past = false;
    while (p < end) {
        int32_t len = 0;
        while (p < end && *p >= '0' && *p <= '9')
            len = len * 10 + (*p++ - '0');
        const char op = (p < end) ? *p++ : '=';
        if (!past) {
            const int32_t tlen = (op == 'I') ? 0 : len;
            if (t >= re) {
                past = true;
            } else {
                const int32_t rte = (i + 1 < n) ? t + tlen : te_rec;
                if (i0 == n && rte > rs) i0 = i;
                j1 = i;
                t += tlen;
            }
        }
        ++i;
    }
    return finish(E, k, rs, re, i0, j1);
}

// Approximate (tracepoint) projection: the scalar port of
// index/tracepoints.py project_batch_approx — O(1) segment arithmetic,
// boundary interpolation (np.round = round-half-even, hence nearbyint),
// identity from the aligned/diff prefix sums.  pt = the requested
// (overlap-clipped) range itself, matching impg.rs:1508.
Proj project_approx(const HostEngine& E, int64_t k, int32_t rs, int32_t re) {
    Proj p{};
    const int64_t t0 = E.ts[k], te = E.te[k];
    const int64_t q0 = E.qs_rec[k], qe = E.qe_rec[k];
    const int64_t sp = E.tp_spacing;
    const int64_t off = E.tp_off[k];
    const int64_t nseg = E.tp_nseg[k];
    p.valid = rs < te && re > t0 && rs < re;
    const int64_t rs_c = std::min(std::max((int64_t)rs, t0), te - 1);
    const int64_t re_c = std::min(std::max((int64_t)re, t0 + 1), te);
    const int64_t i0 = std::min(std::max((rs_c - t0) / sp, (int64_t)0),
                                nseg - 1);
    const int64_t j1 = std::min(std::max((re_c - 1 - t0) / sp, (int64_t)0),
                                nseg - 1);
    const int64_t qlo = std::min(q0, qe), qhi = std::max(q0, qe);
    auto boundary = [&](int64_t i) { return std::min(t0 + i * sp, te); };
    auto refine = [&](int64_t i, int64_t pos) {
        const int64_t seg_s = boundary(i), seg_e = boundary(i + 1);
        const int64_t qp = E.tp_qb[off + i], qn = E.tp_qb[off + i + 1];
        const int64_t t_delta = seg_e - seg_s;
        double advance = 0.0;
        if (t_delta > 0)
            advance = std::nearbyint(
                (double)(pos - seg_s) * (double)(qn - qp) /
                (double)std::max(t_delta, (int64_t)1));
        const int64_t refined = qp + (int64_t)advance;
        return std::min(std::max(refined, qlo), qhi);
    };
    p.pq_s = (int32_t)refine(i0, std::max(boundary(i0), rs_c));
    p.pq_e = (int32_t)refine(j1, std::min(boundary(j1 + 1), re_c));
    p.pt_s = rs;
    p.pt_e = re;
    if (p.valid && E.min_ident >= 0.0) {
        const int64_t aligned =
            E.tp_aligned[off + j1 + 1] - E.tp_aligned[off + i0];
        const int64_t diffs = E.tp_diffs[off + j1 + 1] - E.tp_diffs[off + i0];
        const int64_t m = std::max(aligned - diffs, (int64_t)0);
        const int64_t total = m + diffs;
        const double gci =
            total > 0 ? (double)m / (double)std::max<int64_t>(total, 1)
                      : 0.0;
        if (!(gci >= E.min_ident)) p.valid = false;
    }
    return p;
}

struct Frontier {
    int64_t q, s, e;
};

// One full transitive BFS walk (exact engine.py semantics; see module
// docstring of query/engine.py for the reference mapping).
void run_walk(const HostEngine& E, void* vb, int32_t tid0, int32_t s0,
              int32_t e0, int32_t max_depth, int32_t min_trans_len,
              int32_t min_dist, int32_t mode, std::vector<int32_t>& out) {
    vb_frontier_clear(vb);
    const int64_t w0 = 0, t64 = tid0, s64 = s0, e64 = e0;
    vb_seed_many(vb, &w0, &t64, &s64, &e64, 1);
    int64_t m = vb_frontier_size(vb);
    std::vector<int64_t> fw(m), fq(m), fs(m), fe(m);
    if (m) vb_frontier_fetch(vb, fw.data(), fq.data(), fs.data(), fe.data());
    vb_frontier_clear(vb);

    std::vector<Frontier> current;
    for (int64_t i = 0; i < m; ++i) {
        out.insert(out.end(),
                   {(int32_t)fq[i], (int32_t)fs[i], (int32_t)fe[i],
                    (int32_t)fq[i], (int32_t)fs[i], (int32_t)fe[i]});
        if (std::llabs(fe[i] - fs[i]) >= min_trans_len)
            current.push_back({fq[i], fs[i], fe[i]});
    }

    std::vector<int64_t> cand;
    std::vector<int64_t> h_w, h_q, h_s, h_e;
    std::vector<uint8_t> h_b;
    BatchScratch bs;
    int32_t depth = 0;
    while (!current.empty() && (max_depth == 0 || depth < max_depth)) {
        h_w.clear();
        h_q.clear();
        h_s.clear();
        h_e.clear();
        h_b.clear();
        for (const Frontier& fr : current) {
            const int64_t lo = E.tgt_off[fr.q], hi = E.tgt_off[fr.q + 1];
            cand.clear();
            std::chrono::steady_clock::time_point t0;
            if (E.prof) t0 = std::chrono::steady_clock::now();
            if (lo < hi)
                stab_tree(E, lo, hi, (int32_t)fr.s, (int32_t)fr.e, cand);
            if (E.prof) {
                auto t1 = std::chrono::steady_clock::now();
                E.ns_stab += std::chrono::duration_cast<
                    std::chrono::nanoseconds>(t1 - t0).count();
                t0 = t1;
            }
            auto emit = [&](int64_t k, const Proj& p) {
                if (!p.valid) return;
                const int32_t q = E.qid[k];
                if (E.seq_ok != nullptr && q != tid0 && !E.seq_ok[q])
                    return;  // subset: drops result AND frontier
                if (E.min_out_len < 0 ||
                    std::llabs((int64_t)p.pq_e - p.pq_s) >= E.min_out_len)
                    out.insert(out.end(), {q, p.pq_s, p.pq_e,
                                           (int32_t)fr.q, p.pt_s, p.pt_e});
                h_w.push_back(0);
                h_q.push_back(q);
                h_s.push_back(p.pq_s);
                h_e.push_back(p.pq_e);
                h_b.push_back(q != (int32_t)fr.q ? 1 : 0);
            };
            static const bool use_batch = [] {
                const char* e = getenv("IMPG_HE_BATCH");
                return !(e && *e == '0');
            }();
            if (!E.approx && mode == 0 && use_batch) {
                // Closed mode: lockstep-batched searches, then an
                // in-order finish+emit pass (iterations independent —
                // OOO overlaps their arena misses).
                project_closed_batch(E, cand, fr.s, fr.e, bs);
                for (size_t c = 0; c < cand.size(); ++c) {
                    if (bs.skip[c]) continue;
                    const int64_t k = cand[c];
                    emit(k, finish(E, k, bs.ovs[c], bs.ove[c], bs.i0[c],
                                   bs.j1[c]));
                }
            } else {
                for (int64_t k : cand) {
                    const int32_t ov_s = std::max((int32_t)fr.s, E.ts[k]);
                    const int32_t ov_e = std::min((int32_t)fr.e, E.te[k]);
                    if (ov_s >= ov_e) continue;
                    const Proj p =
                        E.approx ? project_approx(E, k, ov_s, ov_e)
                        : (mode == 1) ? project_walk(E, k, ov_s, ov_e)
                        : (mode == 2) ? project_paf(E, k, ov_s, ov_e)
                                      : project_closed(E, k, ov_s, ov_e);
                    emit(k, p);
                }
            }
            if (E.prof)
                E.ns_proj += std::chrono::duration_cast<
                    std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
        }
        std::chrono::steady_clock::time_point tv;
        if (E.prof) tv = std::chrono::steady_clock::now();
        vb_frontier_clear(vb);
        if (!h_q.empty())
            vb_process(vb, h_w.data(), h_q.data(), h_s.data(), h_e.data(),
                       h_b.data(), (int64_t)h_q.size(), min_dist,
                       min_trans_len);
        m = vb_frontier_size(vb);
        if (E.prof) {
            auto t1 = std::chrono::steady_clock::now();
            E.ns_vb += std::chrono::duration_cast<
                std::chrono::nanoseconds>(t1 - tv).count();
            tv = t1;
        }
        ++depth;
        current.clear();
        if (!m) {
            if (E.prof)
                E.ns_front += std::chrono::duration_cast<
                    std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - tv).count();
            continue;
        }
        fw.resize(m);
        fq.resize(m);
        fs.resize(m);
        fe.resize(m);
        vb_frontier_fetch(vb, fw.data(), fq.data(), fs.data(), fe.data());
        vb_frontier_clear(vb);
        std::vector<Frontier> next(m);
        for (int64_t i = 0; i < m; ++i) next[i] = {fq[i], fs[i], fe[i]};
        std::sort(next.begin(), next.end(), [](const Frontier& a,
                                               const Frontier& b) {
            return a.q != b.q ? a.q < b.q : a.s < b.s;
        });
        for (const Frontier& fr : next) {
            if (!current.empty() && current.back().q == fr.q &&
                current.back().e >= fr.s) {
                current.back().e = std::max(current.back().e, fr.e);
            } else {
                current.push_back(fr);
            }
        }
        if (E.prof)
            E.ns_front += std::chrono::duration_cast<
                std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - tv).count();
    }
}

}  // namespace

extern "C" {

void* he_create(int64_t n_records, const int32_t* tgt, const int32_t* qid,
                const int32_t* ts, const int32_t* te, const int8_t* strand,
                const int64_t* op_off, const int32_t* op_cnt, int64_t n_seqs,
                const int64_t* tgt_offsets, const int64_t* seq_lens,
                int64_t n_runs, const uint32_t* runs, const int32_t* cum_t,
                const int32_t* cum_q, const int32_t* irb,
                const int32_t* ira, const int32_t* cum_match,
                const int32_t* cum_mm, const int32_t* cum_icnt,
                const int32_t* cum_dcnt) {
    auto* E = new HostEngine();
    E->n_records = n_records;
    E->n_seqs = n_seqs;
    E->n_runs = n_runs;
    E->tgt = tgt;
    E->qid = qid;
    E->ts = ts;
    E->te = te;
    E->strand = strand;
    E->op_off = op_off;
    E->op_cnt = op_cnt;
    E->tgt_off = tgt_offsets;
    E->seq_lens = seq_lens;
    E->runs = runs;
    E->cum_t = cum_t;
    E->cum_q = cum_q;
    E->irb = irb;
    E->ira = ira;
    E->cm = cum_match;
    E->cmm = cum_mm;
    E->cic = cum_icnt;
    E->cdc = cum_dcnt;
    E->submax.assign((size_t)n_records, INT32_MIN);
    for (int64_t s = 0; s < n_seqs; ++s)
        build_submax(*E, tgt_offsets[s], tgt_offsets[s + 1]);
    return E;
}

void he_destroy(void* h) { delete (HostEngine*)h; }

// Attach the identity-statistics prefix arrays after creation.  The
// engine only dereferences them under a min-identity gate, so callers
// with lazily-derived stats (arena v3) bind them on first use instead
// of paying the 24 B/run materialization for interval-only walks.
void he_set_stats(void* h, const int32_t* cum_match, const int32_t* cum_mm,
                  const int32_t* cum_icnt, const int32_t* cum_dcnt) {
    auto* E = (HostEngine*)h;
    E->cm = cum_match;
    E->cmm = cum_mm;
    E->cic = cum_icnt;
    E->cdc = cum_dcnt;
}

// Materialize the resident ASCII CIGAR blob for mode 2 "paf" from the
// run arena (decimal length + op char per run — the cg:Z: bytes the
// reference re-parses per projection).  Idempotent; returns blob bytes.
int64_t he_build_cigar_text(void* h) {
    auto* E = (HostEngine*)h;
    if (!E->cig_off.empty()) return (int64_t)E->cig_text.size();
    static const char OPS[5] = {'=', 'X', 'I', 'D', 'M'};
    E->cig_off.assign((size_t)E->n_records + 1, 0);
    // Size pass (exact), then fill — avoids a 2x over-reserve on
    // 100M-run arenas.
    int64_t total = 0;
    for (int64_t k = 0; k < E->n_records; ++k) {
        const int64_t off = E->op_off[k];
        const int32_t n = E->op_cnt[k];
        int64_t bytes = 0;
        for (int32_t i = 0; i < n; ++i) {
            uint32_t len = E->runs[off + i] & LEN_MASK;
            int d = 1;
            while (len >= 10) {
                len /= 10;
                ++d;
            }
            bytes += d + 1;
        }
        total += bytes;
        E->cig_off[(size_t)k + 1] = total;
    }
    E->cig_text.resize((size_t)total);
    char* base = E->cig_text.data();
    for (int64_t k = 0; k < E->n_records; ++k) {
        const int64_t off = E->op_off[k];
        const int32_t n = E->op_cnt[k];
        char* p = base + E->cig_off[k];
        for (int32_t i = 0; i < n; ++i) {
            const uint32_t run = E->runs[off + i];
            uint32_t len = run & LEN_MASK;
            char tmp[12];
            int d = 0;
            do {
                tmp[d++] = (char)('0' + len % 10);
                len /= 10;
            } while (len);
            while (d) *p++ = tmp[--d];
            *p++ = OPS[run >> 29];
        }
    }
    return (int64_t)E->cig_text.size();
}

// Attach the tracepoint arena (index/tracepoints.py TracepointArena) for
// --approximate runs; q_start/q_end are the directed records' query
// endpoints (clip window for boundary refinement).
void he_set_tracepoints(void* h, int32_t spacing, const int64_t* seg_off,
                        const int32_t* n_seg, const int32_t* q_bound,
                        const int64_t* pre_diffs, const int64_t* pre_aligned,
                        const int32_t* q_start, const int32_t* q_end) {
    auto* E = (HostEngine*)h;
    E->tp_spacing = spacing;
    E->tp_off = seg_off;
    E->tp_nseg = n_seg;
    E->tp_qb = q_bound;
    E->tp_diffs = pre_diffs;
    E->tp_aligned = pre_aligned;
    E->qs_rec = q_start;
    E->qe_rec = q_end;
}

// Run n transitive BFS walks across `threads` OS threads (one walk = one
// unit, atomic work stealing).  mode: 0 closed-form, 1 reference walk.
// Returns the total emitted row count; rows stay inside per-walk buffers
// until fetched.
//
// Masked regions (partition's pre-visited bookkeeping, partition.rs:978):
// `masked` selects the masked-entry contract (lazily-created visited
// entries clamp to length 0, impg.rs:2047); each walk's fresh visited
// book is preloaded with the (qid, s, e, entry_seq_len) rows — a
// zero-length row materializes an empty entry so its sequence_length
// governs later inserts, exactly like a Python-side clone
// (query/engine.py:847-859).
int64_t he_run(void* h, const int32_t* q_tid, const int32_t* q_s,
               const int32_t* q_e, int64_t n, int32_t max_depth,
               int32_t min_trans_len, int32_t min_dist, int32_t mode,
               int32_t threads, int32_t masked, const int64_t* m_qid,
               const int64_t* m_s, const int64_t* m_e,
               const int64_t* m_len, int64_t n_mask, double min_identity,
               int32_t subset_on, const uint8_t* seq_ok,
               int64_t min_output_length, int32_t approximate) {
    auto* E = (HostEngine*)h;
    E->min_ident = (E->cm != nullptr) ? min_identity : -1.0;
    E->seq_ok = subset_on ? seq_ok : nullptr;
    E->min_out_len = min_output_length;
    E->approx = approximate != 0 && E->tp_off != nullptr;
    {
        const char* p = getenv("IMPG_HE_PROF");
        E->prof = p && *p == '1';
        E->ns_stab = E->ns_proj = E->ns_vb = E->ns_front = 0;
    }
    if (approximate && E->tp_off == nullptr) return -1;
    if (mode == 2 && E->cig_off.empty()) return -1;  // he_build_cigar_text first
    E->rows.assign((size_t)n, {});
    std::atomic<int64_t> next(0);
    const int nt = std::max(1, (int)threads);
    const int32_t mnone = masked ? 0 : 1;
    auto make_vb = [&]() {
        void* vb = vb_create(E->n_seqs, E->seq_lens, mnone);
        for (int64_t i = 0; i < n_mask; ++i)
            vb_preload(vb, 0, m_qid[i], m_s[i], m_e[i], m_len[i]);
        return vb;
    };
    auto worker = [&]() {
        void* vb = make_vb();
        for (int64_t w = next.fetch_add(1); w < n; w = next.fetch_add(1)) {
            run_walk(*E, vb, q_tid[w], q_s[w], q_e[w], max_depth,
                     min_trans_len, min_dist, mode, E->rows[w]);
            // Fresh bookkeeping per walk: recreate the visited book.
            vb_destroy(vb);
            vb = make_vb();
        }
        vb_destroy(vb);
    };
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (const auto& r : E->rows) total += (int64_t)r.size() / 6;
    if (E->prof)
        fprintf(stderr,
                "[he_prof] stab %.1f ms  project+emit %.1f ms  "
                "visited %.1f ms  frontier %.1f ms (thread-summed)\n",
                E->ns_stab.load() / 1e6, E->ns_proj.load() / 1e6,
                E->ns_vb.load() / 1e6, E->ns_front.load() / 1e6);
    return total;
}

int64_t he_walk_rows(void* h, int64_t walk) {
    auto* E = (HostEngine*)h;
    return (int64_t)E->rows[(size_t)walk].size() / 6;
}

// Fetch one walk's rows as 6 parallel int32 columns.
void he_fetch_walk(void* h, int64_t walk, int32_t* q_id, int32_t* q_first,
                   int32_t* q_last, int32_t* t_id, int32_t* t_first,
                   int32_t* t_last) {
    auto* E = (HostEngine*)h;
    const auto& r = E->rows[(size_t)walk];
    const int64_t n = (int64_t)r.size() / 6;
    for (int64_t i = 0; i < n; ++i) {
        q_id[i] = r[i * 6 + 0];
        q_first[i] = r[i * 6 + 1];
        q_last[i] = r[i * 6 + 2];
        t_id[i] = r[i * 6 + 3];
        t_first[i] = r[i * 6 + 4];
        t_last[i] = r[i * 6 + 5];
    }
}

// Prefix offsets over per-walk row counts (off has n_walks+1 slots).
void he_walk_offsets(void* h, int64_t n_walks, int64_t* off) {
    auto* E = (HostEngine*)h;
    int64_t acc = 0;
    for (int64_t w = 0; w < n_walks; ++w) {
        off[w] = acc;
        acc += (int64_t)E->rows[(size_t)w].size() / 6;
    }
    off[n_walks] = acc;
}

// Fetch EVERY walk's rows concatenated into 6 parallel int32 columns
// (walk w occupies [off[w], off[w+1]) — one ctypes call for the whole
// batch instead of one per walk).  Threaded: the copy is memory-bound
// and the destination pages are FRESH numpy allocations, so fanning the
// first-touch page faults across cores is a ~4x win on multi-million-row
// batches (this environment faults large fresh maps at ~3-6 ms/MB).
void he_fetch_all(void* h, int64_t n_walks, const int64_t* off,
                  int32_t threads, int32_t* q_id, int32_t* q_first,
                  int32_t* q_last, int32_t* t_id, int32_t* t_first,
                  int32_t* t_last) {
    auto* E = (HostEngine*)h;
    std::atomic<int64_t> next_w(0);
    auto worker = [&]() {
        for (int64_t w = next_w.fetch_add(1); w < n_walks;
             w = next_w.fetch_add(1)) {
            const auto& r = E->rows[(size_t)w];
            const int64_t n = (int64_t)r.size() / 6;
            int64_t at = off[w];
            for (int64_t i = 0; i < n; ++i, ++at) {
                q_id[at] = r[i * 6 + 0];
                q_first[at] = r[i * 6 + 1];
                q_last[at] = r[i * 6 + 2];
                t_id[at] = r[i * 6 + 3];
                t_first[at] = r[i * 6 + 4];
                t_last[at] = r[i * 6 + 5];
            }
        }
    };
    const int nt = std::max(1, (int)threads);
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
}

void he_clear(void* h) { ((HostEngine*)h)->rows.clear(); }

}  // extern "C"
