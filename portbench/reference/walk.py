"""Plain reference of `query -x`: the depth-limited transitive BFS of the
upstream impg (impg.rs:2311-2597), one walk at a time, from the drawn
alignments.

Each alignment gives a forward directed record (target -> query) and, when
its two sequences differ, a swapped one (query -> target) whose runs have I
and D exchanged and, on the '-' strand, their order reversed.  The records
are ordered by (target, target start), ties in the order of the input, as
the index orders them.  A range is projected through a record by walking its
runs: a run that moves along the target is taken when its part inside the
range is not empty, an insertion when its target position lies in
[range start, min(record end, range end)]; the projected ends follow from
the first and the last run taken, and a projection that is empty on either
side is no hit (impg.rs:2760-2898).

A walk keeps one visited book per sequence: sorted disjoint ranges whose
insert returns the parts not yet covered, clamps the end to the sequence
length and joins touching ranges (impg.rs:242-369).  A depth takes every
frontier range in (sequence, start) order, stabs the records of its
sequence in index order, and for every hit emits a row and, for a hit on
another sequence, skips it when it lies within `min_distance` of a visited
range, else inserts it and keeps each uncovered part at least
`min_transitive_len` long for the next depth; the next frontier is sorted
and touching ranges joined.

With `spacing`, a walk projects approximately, through tracepoints every
`spacing` target bases (impg.rs:1317-1534): a record's boundaries are
min(t_start + i spacing, t_end), each with the query position the runs give
there (the last run starting at or before it; inside a run that moves along
both sequences, offset by the distance into it); a range's ends are
interpolated within the first and the last segment it touches, rounded half
to even and clamped to the record's query span; the target side is the
range itself, and every overlapping record is a hit.

`coord="bf16"` carries every projected coordinate through bfloat16: the
control that a program computing coordinates in a 16-bit float must fail.
"""

from __future__ import annotations

import re
from bisect import bisect_left

import numpy as np

OP_EQ, OP_X, OP_I, OP_D, OP_M = 0, 1, 2, 3, 4
LEN_MASK = (1 << 29) - 1
_CIGAR_OPS = {"=": OP_EQ, "X": OP_X, "I": OP_I, "D": OP_D, "M": OP_M}
_CIGAR_RE = re.compile(r"(\d+)([=XIDM])")


def bf16(v: int) -> int:
    """`v` rounded to the nearest bfloat16 (ties to even)."""
    bits = int(np.array([v], np.float32).view(np.uint32)[0])
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return int(np.array([bits], np.uint32).view(np.float32)[0])


def parse_paf(text: str) -> tuple[list, list, list]:
    """One chunk of alignment columns from PAF text with `cg:Z:` CIGARs,
    and the sequence names and lengths in order of first appearance."""
    ids: dict[str, int] = {}
    names: list[str] = []
    lengths: list[int] = []

    def sid(name: str, ln: int) -> int:
        if name not in ids:
            ids[name] = len(names)
            names.append(name)
            lengths.append(ln)
        return ids[name]

    cols = {k: [] for k in ("query_id", "q_start", "q_end", "target_id",
                            "t_start", "t_end", "strand")}
    runs, offsets = [], [0]
    for line in text.splitlines():
        if not line.strip():
            continue
        f = line.split("\t")
        cols["query_id"].append(sid(f[0], int(f[1])))
        cols["q_start"].append(int(f[2]))
        cols["q_end"].append(int(f[3]))
        cols["strand"].append(1 if f[4] == "-" else 0)
        cols["target_id"].append(sid(f[5], int(f[6])))
        cols["t_start"].append(int(f[7]))
        cols["t_end"].append(int(f[8]))
        cg = next(t[5:] for t in f[12:] if t.startswith("cg:Z:"))
        pairs = _CIGAR_RE.findall(cg)
        lens = np.array([int(n) for n, _ in pairs], np.uint32)
        ops = np.array([_CIGAR_OPS[o] for _, o in pairs], np.uint32)
        runs.append((ops << 29) | lens)
        offsets.append(offsets[-1] + lens.size)
    chunk = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    chunk["runs"] = np.concatenate(runs) if runs else np.zeros(0, np.uint32)
    chunk["run_offsets"] = np.asarray(offsets, np.int64)
    return [chunk], names, lengths


class Book:
    """Visited ranges of one sequence in one walk."""

    __slots__ = ("ranges", "length")

    def __init__(self, length: int):
        self.ranges: list[tuple[int, int]] = []
        self.length = length

    def _at(self, start: int) -> int:
        return bisect_left(self.ranges, start, key=lambda r: r[0])

    def too_close(self, lo: int, hi: int, min_distance: int) -> bool:
        if min_distance <= 0:
            return False
        i = self._at(lo)
        r = self.ranges
        if i > 0 and abs(lo - r[i - 1][1]) < min_distance:
            return True
        return i < len(r) and abs(r[i][0] - hi) < min_distance

    def insert(self, start: int, end: int) -> list[tuple[int, int]]:
        if start > end:
            start, end = end, start
        if start < 0:
            start = 0
        if end > self.length:
            end = self.length
        r = self.ranges
        out = []
        cur = start
        i = self._at(start)
        if i > 0 and r[i - 1][1] > start:
            i -= 1
        while i < len(r) and cur < end:
            rs, re_ = r[i]
            if rs > end:
                break
            if cur < rs:
                out.append((cur, rs))
            cur = max(cur, re_)
            i += 1
        if cur < end:
            out.append((cur, end))
        pos = self._at(start)
        if pos > 0 and r[pos - 1][1] >= start:
            r[pos - 1] = (r[pos - 1][0], max(r[pos - 1][1], end))
            self._join_from(pos - 1)
        elif pos < len(r) and end >= r[pos][0]:
            r[pos] = (min(start, r[pos][0]), max(end, r[pos][1]))
            self._join_from(pos)
        else:
            r.insert(pos, (start, end))
        return out

    def _join_from(self, i: int) -> None:
        r = self.ranges
        while i + 1 < len(r) and r[i][1] >= r[i + 1][0]:
            r[i] = (r[i][0], max(r[i][1], r[i + 1][1]))
            del r[i + 1]


def merge_frontier(ranges: list) -> list:
    """Sorted by (sequence, start), touching ranges of a sequence joined."""
    out: list = []
    for t, s, e in sorted(ranges, key=lambda x: (x[0], x[1])):
        if out and out[-1][0] == t and out[-1][2] >= s:
            out[-1] = (t, out[-1][1], max(out[-1][2], e))
        else:
            out.append((t, s, e))
    return out


class DirectedTable:
    """Directed records of drawn alignments, in index order."""

    def __init__(self, chunks: list, names: list, lengths: list):
        self.chunks = chunks
        self.names = list(names)
        self.lengths = np.asarray(lengths, np.int64)
        parts = []
        for c, ch in enumerate(chunks):
            n = ch["query_id"].size
            aln = np.arange(n, dtype=np.int64)
            fwd = dict(target=ch["target_id"], query=ch["query_id"],
                       ts=ch["t_start"], te=ch["t_end"], qs=ch["q_start"],
                       qe=ch["q_end"], strand=ch["strand"], aln=aln,
                       swapped=np.zeros(n, bool))
            sw = np.flatnonzero(ch["query_id"] != ch["target_id"])
            swp = dict(target=ch["query_id"][sw], query=ch["target_id"][sw],
                       ts=ch["q_start"][sw], te=ch["q_end"][sw],
                       qs=ch["t_start"][sw], qe=ch["t_end"][sw],
                       strand=ch["strand"][sw], aln=sw,
                       swapped=np.ones(sw.size, bool))
            for d in (fwd, swp):
                d["chunk"] = np.full(d["aln"].size, c, np.int64)
                parts.append(d)
        cols = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in parts[0]}
        for k in ("target", "query", "ts", "te", "qs", "qe", "strand"):
            cols[k] = cols[k].astype(np.int64)
        order = np.lexsort((cols["ts"], cols["target"]))
        self.cols = {k: v[order] for k, v in cols.items()}
        self.n_records = order.size
        self.tgt_off = np.searchsorted(
            self.cols["target"], np.arange(len(self.names) + 1), side="left")
        self._runs: dict = {}

    def record_runs(self, k: int):
        """Per run of record k in its own direction: target start and end,
        query position at its start (walk direction), query length, and
        whether it is an insertion or a deletion."""
        got = self._runs.get(k)
        if got is not None:
            return got
        c = self.cols
        ch = self.chunks[int(c["chunk"][k])]
        a = int(c["aln"][k])
        r = ch["runs"][int(ch["run_offsets"][a]):int(ch["run_offsets"][a + 1])]
        lens = (r & LEN_MASK).astype(np.int64)
        ops = (r >> 29).astype(np.int64)
        if c["swapped"][k]:
            ops = np.where(ops == OP_I, OP_D,
                           np.where(ops == OP_D, OP_I, ops))
            if c["strand"][k]:
                lens, ops = lens[::-1], ops[::-1]
        is_i = ops == OP_I
        is_d = ops == OP_D
        tlen = np.where(is_i, 0, lens)
        qlen = np.where(is_d, 0, lens)
        ts = int(c["ts"][k]) + np.concatenate([[0], np.cumsum(tlen)[:-1]])
        d = -1 if c["strand"][k] else 1
        q0 = int(c["qe"][k]) if d < 0 else int(c["qs"][k])
        qs = q0 + d * np.concatenate([[0], np.cumsum(qlen)[:-1]])
        got = (ts, ts + tlen, qs, qlen, is_i, is_d)
        self._runs[k] = got
        return got

    def project(self, k: int, rs: int, re_: int):
        """(q_first, q_last, t_first, t_last) of [rs, re_) through record k,
        or None when no hit."""
        ts, te, qs, qlen, is_i, is_d = self.record_runs(k)
        lim = min(int(self.cols["te"][k]), re_)
        inc = np.where(is_i, (ts >= rs) & (ts <= lim),
                       np.maximum(ts, rs) < np.minimum(te, re_))
        idx = np.flatnonzero(inc)
        if idx.size == 0:
            return None
        f, l_ = int(idx[0]), int(idx[-1])
        d = -1 if self.cols["strand"][k] else 1
        if is_i[f]:
            pt_s, pq_s = int(ts[f]), int(qs[f])
        else:
            pt_s = max(int(ts[f]), rs)
            pq_s = int(qs[f]) + (0 if is_d[f] else (pt_s - int(ts[f])) * d)
        if is_i[l_]:
            pt_e, pq_e = int(ts[l_]), int(qs[l_]) + int(qlen[l_]) * d
        else:
            pt_e = min(int(te[l_]), re_)
            pq_e = (int(qs[l_]) if is_d[l_]
                    else int(qs[l_]) + (pt_e - int(ts[l_])) * d)
        if pq_s == pq_e or pt_s == pt_e:
            return None
        return pq_s, pq_e, pt_s, pt_e

    def boundaries(self, k: int, spacing: int) -> np.ndarray:
        """Query positions at record k's tracepoint boundaries."""
        key = (k, spacing)
        got = self._runs.get(key)
        if got is not None:
            return got
        ts, te, qs, qlen, is_i, is_d = self.record_runs(k)
        t0, t1 = int(self.cols["ts"][k]), int(self.cols["te"][k])
        n_seg = max(-(-(t1 - t0) // spacing), 1)
        g = np.minimum(t0 + np.arange(n_seg + 1) * spacing, t1)
        j = np.maximum(np.searchsorted(ts, g, "right") - 1, 0)
        d = -1 if self.cols["strand"][k] else 1
        both = ~is_i[j] & ~is_d[j]
        got = qs[j] + np.where(both, (g - ts[j]) * d, 0)
        self._runs[key] = got
        return got

    def project_approx(self, k: int, rs: int, re_: int, spacing: int):
        """(q_first, q_last, t_first, t_last) of [rs, re_) through record
        k's tracepoints."""
        t0, t1 = int(self.cols["ts"][k]), int(self.cols["te"][k])
        qb = self.boundaries(k, spacing)
        n_seg = qb.size - 1
        q_lo = min(int(self.cols["qs"][k]), int(self.cols["qe"][k]))
        q_hi = max(int(self.cols["qs"][k]), int(self.cols["qe"][k]))
        rs_c = min(max(rs, t0), t1 - 1)
        re_c = min(max(re_, t0 + 1), t1)

        def bound(i):
            return min(t0 + i * spacing, t1)

        def refine(i, at):
            seg_s, seg_e = bound(i), bound(i + 1)
            q_pos = int(qb[i])
            dq = int(qb[i + 1]) - q_pos
            dt = seg_e - seg_s
            adv = 0
            if dt > 0:
                num = (at - seg_s) * dq
                adv = num // dt
                twice = 2 * (num - adv * dt)
                if twice > dt or (twice == dt and adv % 2):
                    adv += 1
            return min(max(q_pos + adv, q_lo), q_hi)

        i0 = min(max((rs_c - t0) // spacing, 0), n_seg - 1)
        j1 = min(max((re_c - 1 - t0) // spacing, 0), n_seg - 1)
        return (refine(i0, max(bound(i0), rs_c)),
                refine(j1, min(bound(j1 + 1), re_c)), rs, re_)

    def candidates(self, tid: int, s: int, e: int) -> np.ndarray:
        """Records of sequence `tid` overlapping [s, e), in index order."""
        lo, hi = int(self.tgt_off[tid]), int(self.tgt_off[tid + 1])
        cut = lo + int(np.searchsorted(self.cols["ts"][lo:hi], e, "left"))
        return lo + np.flatnonzero(self.cols["te"][lo:cut] > s)

    def walk(self, tid: int, start: int, end: int, max_depth: int = 2,
             min_transitive_len: int = 101, min_distance: int = 10,
             coord: str = "int", spacing: int | None = None) -> np.ndarray:
        """Rows [n, 6] (q_id, q_first, q_last, t_id, t_first, t_last) of one
        transitive walk from (tid, start, end); approximate with
        `spacing`."""
        rnd = bf16 if coord == "bf16" else int
        books: dict[int, Book] = {}

        def book(sid: int) -> Book:
            b = books.get(sid)
            if b is None:
                b = books[sid] = Book(int(self.lengths[sid]))
            return b

        rows = []
        front = []
        for s, e in book(tid).insert(start, end):
            rows.append((tid, s, e, tid, s, e))
            if abs(e - s) >= min_transitive_len:
                front.append((tid, s, e))
        c = self.cols
        for _ in range(max_depth):
            if not front:
                break
            nxt = []
            for ct, cs, ce in front:
                for k in self.candidates(ct, cs, ce).tolist():
                    rs = max(cs, int(c["ts"][k]))
                    re_ = min(ce, int(c["te"][k]))
                    p = (self.project(k, rs, re_) if spacing is None
                         else self.project_approx(k, rs, re_, spacing))
                    if p is None:
                        continue
                    aq_s, aq_e, pt_s, pt_e = (rnd(v) for v in p)
                    qid = int(c["query"][k])
                    rows.append((qid, aq_s, aq_e, ct, pt_s, pt_e))
                    if qid == ct:
                        continue
                    b = book(qid)
                    lo, hi = min(aq_s, aq_e), max(aq_s, aq_e)
                    if b.too_close(lo, hi, min_distance):
                        continue
                    for s, e in b.insert(aq_s, aq_e):
                        if abs(e - s) >= min_transitive_len:
                            nxt.append((qid, s, e))
            front = merge_frontier(nxt)
        return np.asarray(rows, np.int64).reshape(-1, 6)


def rows_off(got: np.ndarray, want: np.ndarray) -> int:
    """Rows in one multiset and not the other (both [n, 6])."""
    def counts(a):
        if a.size == 0:
            return {}
        u, n = np.unique(a, axis=0, return_counts=True)
        return dict(zip(map(tuple, u.tolist()), n.tolist()))

    g, w = counts(got), counts(want)
    return sum(abs(g.get(k, 0) - w.get(k, 0)) for k in set(g) | set(w))
