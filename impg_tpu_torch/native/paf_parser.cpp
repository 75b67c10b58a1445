// The port's copy of impg_tpu/native/paf_parser.cpp, built by
// impg_tpu_torch/io/native.py (tests/test_torch_host.py holds the two equal).
// Native PAF + CIGAR ingest for impg_tpu.
//
// The reference's ingest path is native (Rust paf.rs + byte-wise CIGAR scan,
// impg.rs:2935); this is the equivalent C++ tokenizer for the TPU build: one
// pass over the whole buffer producing struct-of-array outputs that Python
// wraps as numpy arrays and feeds straight into the run-arena build.
//
// Exposed via a C ABI (ctypes-friendly): parse -> opaque handle -> array
// getters -> free.  No dependencies beyond the C++17 standard library.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct ParseResult {
  // Per-record columns.
  std::vector<int32_t> query_name_idx;
  std::vector<int32_t> target_name_idx;
  std::vector<int32_t> q_start, q_end, t_start, t_end;
  std::vector<int8_t> strand;
  // Packed CIGAR runs (op << 29 | len) and per-record offsets.
  std::vector<uint32_t> runs;
  std::vector<int64_t> run_offsets;
  // Interned names: concatenated bytes + offsets + lengths (sequence length).
  std::string names_buf;
  std::vector<int64_t> name_offsets;  // size n_names + 1
  std::vector<int64_t> name_lengths;  // sequence length per name
  std::string error;
  int64_t lines_seen = 0;  // total lines consumed (mt line-number offsets)
};

constexpr uint32_t kLenMask = (1u << 29) - 1;

inline int op_code(uint8_t c) {
  switch (c) {
    case '=': return 0;
    case 'X': return 1;
    case 'I': return 2;
    case 'D': return 3;
    case 'M': return 4;
    default: return -1;
  }
}

// Parse a decimal integer from [p, end); returns false on empty/overflow.
inline bool parse_i64(const uint8_t* p, const uint8_t* end, int64_t* out) {
  if (p == end) return false;
  int64_t v = 0;
  for (; p != end; ++p) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
    if (v > INT64_MAX / 2) return false;
  }
  *out = v;
  return true;
}

// Tokenize [buf, bend) into r.  Error messages carry line numbers
// offset by lineno0 so parallel chunks report the same "line N" a
// single-thread scan would.
void paf_parse_range(const uint8_t* buf, const uint8_t* bend,
                     int require_cigar, int64_t lineno0, ParseResult* r) {
  std::unordered_map<std::string_view, int32_t> interned;
  r->run_offsets.push_back(0);
  r->name_offsets.push_back(0);

  auto intern = [&](std::string_view name, int64_t length) -> int32_t {
    auto it = interned.find(name);
    if (it != interned.end()) {
      int32_t idx = it->second;
      if (r->name_lengths[idx] == 0) r->name_lengths[idx] = length;
      return idx;
    }
    int32_t idx = static_cast<int32_t>(r->name_offsets.size() - 1);
    // Map keys are views into the INPUT buffer (stable); names_buf may
    // reallocate as it grows, so never key on it.
    interned.emplace(name, idx);
    r->names_buf.append(name.data(), name.size());
    r->name_offsets.push_back(static_cast<int64_t>(r->names_buf.size()));
    r->name_lengths.push_back(length);
    return idx;
  };

  const uint8_t* p = buf;
  int64_t lineno = lineno0;
  std::vector<std::pair<const uint8_t*, const uint8_t*>> fields;
  fields.reserve(24);

  while (p < bend) {
    ++lineno;
    const uint8_t* line_end = static_cast<const uint8_t*>(
        memchr(p, '\n', static_cast<size_t>(bend - p)));
    if (line_end == nullptr) line_end = bend;
    const uint8_t* le = line_end;
    if (le > p && le[-1] == '\r') --le;

    if (le == p || *p == '#') {
      p = line_end + 1;
      continue;
    }

    fields.clear();
    const uint8_t* f = p;
    while (f < le) {
      const uint8_t* tab = static_cast<const uint8_t*>(
          memchr(f, '\t', static_cast<size_t>(le - f)));
      if (tab == nullptr) tab = le;
      fields.emplace_back(f, tab);
      f = tab + 1;
    }
    if (fields.size() < 12) {
      r->error = "line " + std::to_string(lineno) + ": PAF record has <12 fields";
      r->lines_seen = lineno - lineno0;
      return;
    }

    int64_t q_len, q_s, q_e, t_len, t_s, t_e;
    if (!parse_i64(fields[1].first, fields[1].second, &q_len) ||
        !parse_i64(fields[2].first, fields[2].second, &q_s) ||
        !parse_i64(fields[3].first, fields[3].second, &q_e) ||
        !parse_i64(fields[6].first, fields[6].second, &t_len) ||
        !parse_i64(fields[7].first, fields[7].second, &t_s) ||
        !parse_i64(fields[8].first, fields[8].second, &t_e)) {
      r->error = "line " + std::to_string(lineno) + ": invalid integer field";
      r->lines_seen = lineno - lineno0;
      return;
    }
    int8_t strand;
    if (fields[4].second - fields[4].first == 1 && *fields[4].first == '+') {
      strand = 0;
    } else if (fields[4].second - fields[4].first == 1 &&
               *fields[4].first == '-') {
      strand = 1;
    } else {
      r->error = "line " + std::to_string(lineno) + ": invalid strand";
      r->lines_seen = lineno - lineno0;
      return;
    }

    std::string_view qname(reinterpret_cast<const char*>(fields[0].first),
                           static_cast<size_t>(fields[0].second - fields[0].first));
    std::string_view tname(reinterpret_cast<const char*>(fields[5].first),
                           static_cast<size_t>(fields[5].second - fields[5].first));

    // cg:Z: tag scan + inline CIGAR decoding.
    bool have_cigar = false;
    for (size_t i = 12; i < fields.size(); ++i) {
      const uint8_t* tf = fields[i].first;
      const uint8_t* te = fields[i].second;
      if (te - tf >= 5 && tf[0] == 'c' && tf[1] == 'g' && tf[2] == ':' &&
          tf[3] == 'Z' && tf[4] == ':') {
        have_cigar = true;
        uint32_t run_len = 0;
        for (const uint8_t* c = tf + 5; c < te; ++c) {
          if (*c >= '0' && *c <= '9') {
            run_len = run_len * 10 + static_cast<uint32_t>(*c - '0');
          } else {
            int code = op_code(*c);
            if (code < 0) {
              r->error = "line " + std::to_string(lineno) +
                         ": invalid CIGAR operation '" +
                         std::string(1, static_cast<char>(*c)) + "'";
              r->lines_seen = lineno - lineno0;
              return;
            }
            r->runs.push_back((static_cast<uint32_t>(code) << 29) |
                              (run_len & kLenMask));
            run_len = 0;
          }
        }
        break;
      }
    }
    if (require_cigar && !have_cigar) {
      r->error = "line " + std::to_string(lineno) +
                 ": alignment record lacks a 'cg:Z:' CIGAR tag";
      r->lines_seen = lineno - lineno0;
      return;
    }

    r->query_name_idx.push_back(intern(qname, q_len));
    r->target_name_idx.push_back(intern(tname, t_len));
    r->q_start.push_back(static_cast<int32_t>(q_s));
    r->q_end.push_back(static_cast<int32_t>(q_e));
    r->t_start.push_back(static_cast<int32_t>(t_s));
    r->t_end.push_back(static_cast<int32_t>(t_e));
    r->strand.push_back(strand);
    r->run_offsets.push_back(static_cast<int64_t>(r->runs.size()));

    p = line_end + 1;
  }

  r->lines_seen = lineno - lineno0;
}

}  // namespace

extern "C" {

ParseResult* impg_paf_parse(const uint8_t* buf, size_t len,
                            int require_cigar) {
  auto* r = new ParseResult();
  paf_parse_range(buf, buf + len, require_cigar, 0, r);
  return r;
}

// Parallel variant: line-aligned chunks parsed with chunk-local intern
// tables, merged in chunk order (global first-seen name order, exact
// single-thread line numbers in error messages).  threads <= 0 = auto.
ParseResult* impg_paf_parse_mt(const uint8_t* buf, size_t len,
                               int require_cigar, int32_t threads) {
  int nt = threads > 0 ? threads
                       : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (threads <= 0 && (size_t)nt > len / (4 << 20) + 1)
    nt = (int)(len / (4 << 20) + 1);  // >=4 MB per chunk in auto mode
  if (nt == 1) return impg_paf_parse(buf, len, require_cigar);

  std::vector<const uint8_t*> bounds(nt + 1);
  bounds[0] = buf;
  bounds[nt] = buf + len;
  for (int i = 1; i < nt; ++i) {
    const uint8_t* p = buf + len * (size_t)i / nt;
    if (p < bounds[i - 1]) p = bounds[i - 1];
    const uint8_t* nl = static_cast<const uint8_t*>(
        memchr(p, '\n', (size_t)(buf + len - p)));
    bounds[i] = nl ? nl + 1 : buf + len;
  }

  std::vector<ParseResult> locals(nt);
  {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i)
      pool.emplace_back([&, i] {
        paf_parse_range(bounds[i], bounds[i + 1], require_cigar, 0,
                        &locals[i]);
      });
    for (auto& t : pool) t.join();
  }

  auto* r = new ParseResult();
  r->run_offsets.push_back(0);
  r->name_offsets.push_back(0);

  // Earliest (file-order) error wins, with the line number rebased to
  // the whole file: chunk-local "line N" + lines consumed before it.
  int64_t line_base = 0;
  for (auto& loc : locals) {
    if (!loc.error.empty()) {
      size_t sp = loc.error.find(' ');
      size_t co = loc.error.find(':');
      int64_t local_line = 0;
      if (sp != std::string::npos && co != std::string::npos && co > sp)
        local_line = atoll(loc.error.substr(sp + 1, co - sp - 1).c_str());
      r->error = "line " + std::to_string(line_base + local_line) +
                 loc.error.substr(co);
      return r;
    }
    line_base += loc.lines_seen;
  }

  // Global intern in chunk order (first-seen order preserved; first
  // nonzero sequence length wins, like the single-thread update rule).
  std::unordered_map<std::string_view, int32_t> interned;
  std::vector<std::vector<int32_t>> luts(nt);
  size_t total_names = 0;
  for (auto& loc : locals) total_names += loc.name_lengths.size();
  interned.reserve(total_names);
  r->names_buf.reserve(total_names * 8);
  for (int c = 0; c < nt; ++c) {
    ParseResult& loc = locals[c];
    size_t n = loc.name_lengths.size();
    luts[c].resize(n);
    for (size_t i = 0; i < n; ++i) {
      std::string_view nm(
          loc.names_buf.data() + loc.name_offsets[i],
          (size_t)(loc.name_offsets[i + 1] - loc.name_offsets[i]));
      auto it = interned.find(nm);
      int32_t gi;
      if (it == interned.end()) {
        gi = (int32_t)(r->name_offsets.size() - 1);
        // Keys view into the locals' blobs (alive through the merge).
        interned.emplace(nm, gi);
        r->names_buf.append(nm.data(), nm.size());
        r->name_offsets.push_back((int64_t)r->names_buf.size());
        r->name_lengths.push_back(loc.name_lengths[i]);
      } else {
        gi = it->second;
        if (r->name_lengths[gi] == 0)
          r->name_lengths[gi] = loc.name_lengths[i];
      }
      luts[c][i] = gi;
    }
  }

  // Pre-size and write every chunk's slice in parallel (name-idx remap
  // fused into the copy; offset columns shifted).
  std::vector<size_t> b_rec(nt + 1, 0), b_run(nt + 1, 0);
  for (int c = 0; c < nt; ++c) {
    b_rec[c + 1] = b_rec[c] + locals[c].q_start.size();
    b_run[c + 1] = b_run[c] + locals[c].runs.size();
  }
  r->query_name_idx.resize(b_rec[nt]);
  r->target_name_idx.resize(b_rec[nt]);
  r->q_start.resize(b_rec[nt]);
  r->q_end.resize(b_rec[nt]);
  r->t_start.resize(b_rec[nt]);
  r->t_end.resize(b_rec[nt]);
  r->strand.resize(b_rec[nt]);
  r->runs.resize(b_run[nt]);
  r->run_offsets.resize(b_rec[nt] + 1);
  r->run_offsets[0] = 0;
  {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int c = 0; c < nt; ++c)
      pool.emplace_back([&, c] {
        ParseResult& loc = locals[c];
        const auto& lut = luts[c];
        size_t n = loc.q_start.size();
        for (size_t i = 0; i < n; ++i) {
          r->query_name_idx[b_rec[c] + i] =
              lut[(size_t)loc.query_name_idx[i]];
          r->target_name_idx[b_rec[c] + i] =
              lut[(size_t)loc.target_name_idx[i]];
        }
        auto cp = [&](auto& dst, auto& src) {
          if (!src.empty())
            memcpy(dst.data() + b_rec[c], src.data(),
                   src.size() * sizeof(src[0]));
        };
        cp(r->q_start, loc.q_start);
        cp(r->q_end, loc.q_end);
        cp(r->t_start, loc.t_start);
        cp(r->t_end, loc.t_end);
        cp(r->strand, loc.strand);
        if (!loc.runs.empty())
          memcpy(r->runs.data() + b_run[c], loc.runs.data(),
                 loc.runs.size() * sizeof(uint32_t));
        for (size_t i = 1; i < loc.run_offsets.size(); ++i)
          r->run_offsets[b_rec[c] + i] =
              loc.run_offsets[i] + (int64_t)b_run[c];
      });
    for (auto& t : pool) t.join();
  }
  return r;
}

const char* impg_paf_error(ParseResult* r) {
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t impg_paf_n_records(ParseResult* r) {
  return static_cast<int64_t>(r->q_start.size());
}
int64_t impg_paf_n_runs(ParseResult* r) {
  return static_cast<int64_t>(r->runs.size());
}
int64_t impg_paf_n_names(ParseResult* r) {
  return static_cast<int64_t>(r->name_lengths.size());
}
int64_t impg_paf_names_size(ParseResult* r) {
  return static_cast<int64_t>(r->names_buf.size());
}

const int32_t* impg_paf_query_name_idx(ParseResult* r) { return r->query_name_idx.data(); }
const int32_t* impg_paf_target_name_idx(ParseResult* r) { return r->target_name_idx.data(); }
const int32_t* impg_paf_q_start(ParseResult* r) { return r->q_start.data(); }
const int32_t* impg_paf_q_end(ParseResult* r) { return r->q_end.data(); }
const int32_t* impg_paf_t_start(ParseResult* r) { return r->t_start.data(); }
const int32_t* impg_paf_t_end(ParseResult* r) { return r->t_end.data(); }
const int8_t* impg_paf_strand(ParseResult* r) { return r->strand.data(); }
const uint32_t* impg_paf_runs(ParseResult* r) { return r->runs.data(); }
const int64_t* impg_paf_run_offsets(ParseResult* r) { return r->run_offsets.data(); }
const char* impg_paf_names_buf(ParseResult* r) { return r->names_buf.data(); }
const int64_t* impg_paf_name_offsets(ParseResult* r) { return r->name_offsets.data(); }
const int64_t* impg_paf_name_lengths(ParseResult* r) { return r->name_lengths.data(); }

void impg_paf_free(ParseResult* r) { delete r; }

}  // extern "C"
