// The port's copy of impg_tpu/native/seqwish_uf.cpp, built into the port's native
// host library (io/native.py).
//
// Bidirected (parity) union-find for seqwish transitive closure
// (graph/seqwish.py _BidirectedUF, run-batched; the per-base unions of a
// whole alignment set run as one native call — the hot loop of graph
// induction at genome scale).

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

struct Uf {
  std::vector<int64_t> parent;
  std::vector<uint8_t> parity;  // parity(x -> parent[x])
  std::vector<int8_t> rank;
};

// find with path compression; returns root, sets *par_out = parity(x->root)
static int64_t find_oriented(Uf *uf, int64_t x, uint8_t *par_out) {
  int64_t r = x;
  uint8_t par = 0;
  while (uf->parent[r] != r) {
    par ^= uf->parity[r];
    r = uf->parent[r];
  }
  // second pass: compress
  int64_t cur = x;
  uint8_t cur_par = par;
  while (uf->parent[cur] != cur) {
    int64_t next = uf->parent[cur];
    uint8_t next_par = cur_par ^ uf->parity[cur];
    uf->parent[cur] = r;
    uf->parity[cur] = cur_par;
    cur = next;
    cur_par = next_par;
  }
  *par_out = par;
  return r;
}

static void do_union(Uf *uf, int64_t a, int64_t b, uint8_t flip) {
  uint8_t pa, pb;
  int64_t ra = find_oriented(uf, a, &pa);
  int64_t rb = find_oriented(uf, b, &pb);
  if (ra == rb) return;
  uint8_t rel = pa ^ pb ^ flip;
  if (uf->rank[ra] < uf->rank[rb]) {
    int64_t t = ra; ra = rb; rb = t;
  }
  uf->parent[rb] = ra;
  uf->parity[rb] = rel;
  if (uf->rank[ra] == uf->rank[rb]) uf->rank[ra]++;
}

}  // namespace

extern "C" {

void *uf_create(int64_t n) {
  Uf *uf = new Uf();
  uf->parent.resize(n);
  uf->parity.assign(n, 0);
  uf->rank.assign(n, 0);
  for (int64_t i = 0; i < n; i++) uf->parent[i] = i;
  return uf;
}

void uf_destroy(void *h) { delete static_cast<Uf *>(h); }

// Union base i of run a with base i of run b for every i in [0, len):
// a walks a_start + a_dir*i, b walks b_start + i; parity `flip` per pair.
void uf_union_runs(void *h, const int64_t *a_start, const int8_t *a_dir,
                   const int64_t *b_start, const int64_t *lens,
                   const uint8_t *flips, int64_t n_runs) {
  Uf *uf = static_cast<Uf *>(h);
  for (int64_t r = 0; r < n_runs; r++) {
    int64_t as = a_start[r], bs = b_start[r], len = lens[r];
    int8_t dir = a_dir[r];
    uint8_t flip = flips[r];
    for (int64_t i = 0; i < len; i++) {
      do_union(uf, as + dir * i, bs + i, flip);
    }
  }
}

// Plain pairwise unions (parity 0) — connected components over edge lists
// (graph report, GFA utilities).
void uf_union_pairs(void *h, const int64_t *a, const int64_t *b,
                    int64_t n_pairs) {
  Uf *uf = static_cast<Uf *>(h);
  for (int64_t i = 0; i < n_pairs; i++) {
    do_union(uf, a[i], b[i], 0);
  }
}

void uf_find_all(void *h, int64_t *roots, uint8_t *orient, int64_t n) {
  Uf *uf = static_cast<Uf *>(h);
  for (int64_t i = 0; i < n; i++) {
    uint8_t p;
    roots[i] = find_oriented(uf, i, &p);
    orient[i] = p;
  }
}

}  // extern "C"
