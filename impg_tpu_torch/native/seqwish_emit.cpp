// The port's copy of impg_tpu/native/seqwish_emit.cpp, built into the port's native
// host library (io/native.py).
//
// Seqwish chain compaction + GFA emission (native tail of the closure).
//
// Role model: the reference's in-process seqwish engine finishing stages
// (commands/graph.rs:156 build_graph: node chain compaction and GFA
// write-out after the transitive closure).  The closure itself runs in
// seqwish_uf.cpp (parity union-find); this file takes the per-base
// (class, orientation) arrays and materializes the unchopped graph:
//   * oriented adjacency from consecutive walk steps (deduped),
//   * unique-continuation chain merging with path-endpoint breaks
//     (the unchop contract shared with graph/poa.py),
//   * S/L/P text emission.
// Mirrors impg_tpu/graph/seqwish.py's emission semantics exactly; the
// Python tail remains as the fallback.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

inline uint64_t pack_edge(uint64_t a_step, uint64_t b_step) {
    return (a_step << 32) | b_step;
}

// Full IUPAC complement (matches io/fasta._COMPLEMENT and the Python
// emitter) — ambiguity codes must survive reverse-oriented spelling.
inline char comp_base(char b) {
    switch (b) {
        case 'A': return 'T';
        case 'T': return 'A';
        case 'C': return 'G';
        case 'G': return 'C';
        case 'U': return 'A';
        case 'R': return 'Y';
        case 'Y': return 'R';
        case 'S': return 'S';
        case 'W': return 'W';
        case 'K': return 'M';
        case 'M': return 'K';
        case 'B': return 'V';
        case 'V': return 'B';
        case 'D': return 'H';
        case 'H': return 'D';
        case 'a': return 't';
        case 't': return 'a';
        case 'c': return 'g';
        case 'g': return 'c';
        case 'u': return 'a';
        case 'r': return 'y';
        case 'y': return 'r';
        case 's': return 's';
        case 'w': return 'w';
        case 'k': return 'm';
        case 'm': return 'k';
        case 'b': return 'v';
        case 'v': return 'b';
        case 'd': return 'h';
        case 'h': return 'd';
        case 'N': return 'N';
        case 'n': return 'n';
        default: return b;
    }
}

}  // namespace

extern "C" {

// Emit the unchopped GFA.  `cls`/`orient` are per-base class ids and
// orientations over the concatenated sequence space; `seq_offsets` has
// n_seqs + 1 entries; `node_base` gives each class's canonical base;
// `path_labels` is a '\n'-joined list of n_seqs P-line names.
// Returns a malloc'd string (length via *out_len); free with
// impg_seqwish_emit_free.
char* impg_seqwish_emit(
    int64_t n_seqs, const int64_t* seq_offsets, const int64_t* cls,
    const uint8_t* orient, int64_t n_nodes, const uint8_t* node_base,
    const char* path_labels, int64_t* out_len) {
    const int64_t n_steps = 2 * n_nodes;

    // 1. Oriented edge set from consecutive walk steps.
    std::unordered_set<uint64_t> edges;
    for (int64_t s = 0; s < n_seqs; ++s) {
        for (int64_t i = seq_offsets[s]; i + 1 < seq_offsets[s + 1]; ++i) {
            uint64_t a = ((uint64_t)cls[i] << 1) | orient[i];
            uint64_t b = ((uint64_t)cls[i + 1] << 1) | orient[i + 1];
            edges.insert(pack_edge(a, b));
        }
    }

    // 2. Unique-successor/predecessor tables over oriented steps
    //    (each edge also contributes its reverse traversal).
    std::vector<int64_t> succ_val(n_steps, -1), pred_val(n_steps, -1);
    std::vector<uint8_t> succ_multi(n_steps, 0), pred_multi(n_steps, 0);
    auto add_succ = [&](int64_t from, int64_t to) {
        if (succ_val[from] == -1) {
            succ_val[from] = to;
        } else if (succ_val[from] != to) {
            succ_multi[from] = 1;
        }
    };
    auto add_pred = [&](int64_t to, int64_t from) {
        if (pred_val[to] == -1) {
            pred_val[to] = from;
        } else if (pred_val[to] != from) {
            pred_multi[to] = 1;
        }
    };
    for (uint64_t e : edges) {
        int64_t a = (int64_t)(e >> 32);
        int64_t b = (int64_t)(e & 0xFFFFFFFFull);
        add_succ(a, b);
        add_pred(b, a);
        add_succ(b ^ 1, a ^ 1);
        add_pred(a ^ 1, b ^ 1);
    }
    auto uniq_next = [&](int64_t step) -> int64_t {
        return succ_multi[step] ? -1 : succ_val[step];
    };
    auto uniq_prev = [&](int64_t step) -> int64_t {
        return pred_multi[step] ? -1 : pred_val[step];
    };

    // 3. Path endpoint breaks (incl. reverse-orientation images, applied
    //    in the same order as the Python tail: starts gain flipped ends
    //    first, then ends gain flips of the widened start set).
    std::vector<uint8_t> is_start(n_steps, 0), is_end(n_steps, 0);
    for (int64_t s = 0; s < n_seqs; ++s) {
        if (seq_offsets[s] == seq_offsets[s + 1]) continue;
        int64_t f = seq_offsets[s];
        int64_t l = seq_offsets[s + 1] - 1;
        is_start[((uint64_t)cls[f] << 1) | orient[f]] = 1;
        is_end[((uint64_t)cls[l] << 1) | orient[l]] = 1;
    }
    std::vector<uint8_t> start2(is_start), end2(is_end);
    for (int64_t st = 0; st < n_steps; ++st) {
        if (is_end[st]) start2[st ^ 1] = 1;
    }
    for (int64_t st = 0; st < n_steps; ++st) {
        if (start2[st]) end2[st ^ 1] = 1;
    }
    auto can_link = [&](int64_t a, int64_t b) -> bool {
        return uniq_next(a) == b && uniq_prev(b) == a && !start2[b] &&
               !end2[a];
    };

    // 4. Chain discovery in walk order.
    std::vector<uint8_t> visited(n_nodes, 0);
    std::vector<int64_t> seg_of(n_nodes, -1), idx_of(n_nodes, -1);
    std::vector<std::vector<int64_t>> segments;
    for (int64_t s = 0; s < n_seqs; ++s) {
        for (int64_t i = seq_offsets[s]; i < seq_offsets[s + 1]; ++i) {
            int64_t node = cls[i];
            if (visited[node]) continue;
            int64_t cur = ((uint64_t)node << 1) | orient[i];
            while (true) {
                int64_t prev = uniq_prev(cur);
                if (prev < 0 || visited[prev >> 1] || !can_link(prev, cur))
                    break;
                cur = prev;
            }
            std::vector<int64_t> seg;
            seg.push_back(cur);
            visited[cur >> 1] = 1;
            while (true) {
                int64_t nxt = uniq_next(cur);
                if (nxt < 0 || visited[nxt >> 1] || !can_link(cur, nxt))
                    break;
                seg.push_back(nxt);
                visited[nxt >> 1] = 1;
                cur = nxt;
            }
            int64_t sid = (int64_t)segments.size();
            for (size_t k = 0; k < seg.size(); ++k) {
                seg_of[seg[k] >> 1] = sid;
                idx_of[seg[k] >> 1] = (int64_t)k;
            }
            segments.push_back(std::move(seg));
        }
    }

    // 5. Emit.
    std::string out;
    out.reserve((size_t)(n_nodes * 8 + n_seqs * 64 + 64));
    out += "H\tVN:Z:1.0\n";
    for (size_t sid = 0; sid < segments.size(); ++sid) {
        out += "S\t";
        out += std::to_string(sid + 1);
        out += '\t';
        for (int64_t st : segments[sid]) {
            char b = (char)node_base[st >> 1];
            out += (st & 1) ? comp_base(b) : b;
        }
        out += '\n';
    }

    // Path steps + links.
    std::vector<uint64_t> links;
    std::vector<std::string> p_lines;
    const char* label = path_labels;
    for (int64_t s = 0; s < n_seqs; ++s) {
        const char* label_end = strchr(label, '\n');
        size_t label_len = label_end ? (size_t)(label_end - label)
                                     : strlen(label);
        std::string line = "P\t";
        line.append(label, label_len);
        line += '\t';
        int64_t L = seq_offsets[s + 1] - seq_offsets[s];
        int64_t i = 0;
        std::vector<uint64_t> steps;
        while (i < L) {
            int64_t gi = seq_offsets[s] + i;
            int64_t st = ((uint64_t)cls[gi] << 1) | orient[gi];
            int64_t sid = seg_of[st >> 1];
            int64_t idx = idx_of[st >> 1];
            bool fwd = segments[sid][idx] == st;
            steps.push_back(((uint64_t)sid << 1) | (fwd ? 0 : 1));
            int64_t seg_len = (int64_t)segments[sid].size();
            i += seg_len <= L - i ? seg_len : L - i;
        }
        for (size_t k = 0; k < steps.size(); ++k) {
            if (k) line += ',';
            line += std::to_string((steps[k] >> 1) + 1);
            line += (steps[k] & 1) ? '-' : '+';
            if (k + 1 < steps.size())
                links.push_back(pack_edge(steps[k], steps[k + 1]));
        }
        line += "\t*\n";
        p_lines.push_back(std::move(line));
        label = label_end ? label_end + 1 : label + label_len;
    }
    std::sort(links.begin(), links.end());
    links.erase(std::unique(links.begin(), links.end()), links.end());
    for (uint64_t lk : links) {
        uint64_t a = lk >> 32, b = lk & 0xFFFFFFFFull;
        out += "L\t";
        out += std::to_string((a >> 1) + 1);
        out += (a & 1) ? "\t-\t" : "\t+\t";
        out += std::to_string((b >> 1) + 1);
        out += (b & 1) ? "\t-\t0M\n" : "\t+\t0M\n";
    }
    for (const std::string& pl : p_lines) out += pl;

    char* buf = (char*)malloc(out.size() + 1);
    memcpy(buf, out.data(), out.size());
    buf[out.size()] = '\0';
    *out_len = (int64_t)out.size();
    return buf;
}

void impg_seqwish_emit_free(char* p) { free(p); }

}  // extern "C"
