"""Columnar GFA: struct-of-arrays graph tensors behind a native tokenizer.

The port's copy of impg_tpu/graph/gfa_columns.py's `GfaColumns` (with
`to_gfa`), `parse_gfa_columns` and `_names_from_blob`: one interned name
table, segment sequences as a single blob + offsets, links as
index/orientation arrays, paths as CSR step arrays, tokenized by the port's
copy of native/gfa_parser.cpp (tests/test_torch_sortgfa.py holds the columns
equal to impg_tpu's).  `to_gfa` materializes the dict model of graph/gfa.py
(`Gfa.parse` routes through it).  `report_columns` and its helpers
(`_components`, `_dup_sequence_groups`, `_hash_weights`, `_numeric_ids`,
`_rc_lut`, `_repeat_contexts`) give `graph-report` the same dict as
gfa.report's dict-model oracle in numpy passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np

DEFAULT_HEADER = "H\tVN:Z:1.0"


@dataclass
class GfaColumns:
    header: str
    names: list[str]  # interned name table (segments/links/steps)
    seg_name_idx: np.ndarray  # int32 [n_segs]
    seq_blob: bytes
    seq_offsets: np.ndarray  # int64 [n_segs + 1]
    link_a: np.ndarray  # int32 into names
    link_a_rev: np.ndarray  # bool
    link_b: np.ndarray
    link_b_rev: np.ndarray
    path_names: list[str]
    path_is_walk: np.ndarray  # bool
    path_off: np.ndarray  # int64 [n_paths + 1]
    step_name_idx: np.ndarray  # int32
    step_rev: np.ndarray  # bool
    _seg_row_of_name: np.ndarray | None = field(default=None, repr=False)

    @classmethod
    def from_arrays(cls, cols: dict) -> "GfaColumns":
        """Columns from a dict of the public fields' values (for example
        `vars()` of another implementation's columns of the same graph):
        arrays are copied, so the result shares no buffer with `cols`."""
        kw = {}
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            v = cols[f.name]
            kw[f.name] = (np.array(v, copy=True) if isinstance(v, np.ndarray)
                          else list(v) if isinstance(v, list) else v)
        return cls(**kw)

    @property
    def n_segs(self) -> int:
        return int(self.seg_name_idx.size)

    @property
    def n_paths(self) -> int:
        return int(self.path_off.size - 1)

    def seg_lens(self) -> np.ndarray:
        return np.diff(self.seq_offsets)

    def seg_row_of_name(self) -> np.ndarray:
        """name idx -> segment row (-1 when the name has no S line; the
        LAST S line wins on duplicates, like the dict model)."""
        if self._seg_row_of_name is None:
            rows = np.full(len(self.names), -1, np.int64)
            rows[self.seg_name_idx] = np.arange(self.n_segs)
            self._seg_row_of_name = rows
        return self._seg_row_of_name

    def to_gfa(self):
        """Materialize the dict-model Gfa (equal to `Gfa.parse_python`'s)."""
        from impg_tpu_torch.graph.gfa import Gfa

        g = Gfa(header=self.header or DEFAULT_HEADER)
        names = self.names
        offs = self.seq_offsets
        if self.seq_blob.isascii():
            blob = self.seq_blob.decode()
            g.segments = {
                names[i]: blob[int(offs[r]) : int(offs[r + 1])]
                for r, i in enumerate(self.seg_name_idx.tolist())
            }
        else:
            raw = self.seq_blob
            g.segments = {
                names[i]: raw[int(offs[r]) : int(offs[r + 1])].decode()
                for r, i in enumerate(self.seg_name_idx.tolist())
            }
        g.links = list(
            zip(
                map(names.__getitem__, self.link_a.tolist()),
                self.link_a_rev.tolist(),
                map(names.__getitem__, self.link_b.tolist()),
                self.link_b_rev.tolist(),
            )
        )
        step_names = list(map(names.__getitem__,
                              self.step_name_idx.tolist()))
        revs = self.step_rev.tolist()
        offp = self.path_off.tolist()
        g.paths = [
            (
                self.path_names[p],
                list(zip(step_names[offp[p]:offp[p + 1]],
                         revs[offp[p]:offp[p + 1]])),
            )
            for p in range(self.n_paths)
        ]
        g.walk_names = {
            self.path_names[p]
            for p in np.nonzero(self.path_is_walk)[0].tolist()
        }
        return g


def _names_from_blob(blob: bytes, offsets: np.ndarray) -> list[str]:
    offs = offsets.tolist()
    if blob.isascii():
        # Byte offsets == char offsets: decode once, slice the str.
        text = blob.decode()
        return [text[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]
    # Non-ASCII names: offsets are BYTE positions — slice bytes, decode each.
    return [
        blob[offs[i]: offs[i + 1]].decode() for i in range(len(offs) - 1)
    ]


def report_columns(gc: GfaColumns) -> dict:
    """Vectorized graph characterization over GfaColumns — produces the
    same dict as graph/gfa.py report(Gfa) (the oracle), in numpy passes
    instead of per-step Python loops."""
    names = gc.names
    n_names = len(names)
    seg_rows = gc.seg_row_of_name()
    n_segs = gc.n_segs
    if n_segs and np.unique(gc.seg_name_idx).size != n_segs:
        # Duplicate S names: the dict model dedups last-wins; defer to the
        # oracle rather than double-counting rows (degenerate inputs only).
        from impg_tpu_torch.graph.gfa import report

        return report(gc.to_gfa())
    node_lens = gc.seg_lens().astype(np.int64)
    total_len = int(node_lens.sum())

    # Degrees keyed on segment rows (links to absent names fall off, as
    # the oracle's segments-only sums do).
    def deg(idx):
        rows = seg_rows[idx]
        rows = rows[rows >= 0]
        return np.bincount(rows, minlength=n_segs)

    degree_out = deg(gc.link_a)
    degree_in = deg(gc.link_b)

    # Depth + path lengths.
    step_rows = seg_rows[gc.step_name_idx] if n_names else np.zeros(
        0, np.int64
    )
    present = step_rows >= 0
    depth = np.bincount(step_rows[present], minlength=n_segs)
    if n_segs:
        step_len = np.where(present, node_lens[np.maximum(step_rows, 0)], 0)
    else:
        step_len = np.zeros(step_rows.size, np.int64)
    cum = np.zeros(gc.step_name_idx.size + 1, np.int64)
    np.cumsum(step_len, out=cum[1:])
    path_lens = (cum[gc.path_off[1:]] - cum[gc.path_off[:-1]]).tolist()

    buckets = {"0": 0, "1": 0, "2-4": 0, "5-9": 0, "10+": 0}
    buckets["0"] = int((depth == 0).sum())
    buckets["1"] = int((depth == 1).sum())
    buckets["2-4"] = int(((depth >= 2) & (depth < 5)).sum())
    buckets["5-9"] = int(((depth >= 5) & (depth < 10)).sum())
    buckets["10+"] = int((depth >= 10).sum())

    def stats(vals):
        if not vals:
            return dict(min=0, max=0, mean=0.0, median=0)
        sv = sorted(vals)
        return dict(
            min=sv[0],
            max=sv[-1],
            mean=round(sum(sv) / len(sv), 2),
            median=sv[len(sv) // 2],
        )

    branching = int((degree_out > 1).sum())
    merging = int((degree_in > 1).sum())

    # Rare repeated local contexts: per oriented-step label, the count of
    # each (left, right) oriented-context pair.  Label ids: name_idx*2+rev;
    # boundary tokens get ids beyond 2*n_names ('^' start, '$' end).
    lbl = gc.step_name_idx.astype(np.int64) * 2 + gc.step_rev
    start_tok = np.int64(2 * n_names)
    end_tok = np.int64(2 * n_names + 1)
    left = np.empty_like(lbl)
    right = np.empty_like(lbl)
    left[1:] = lbl[:-1]
    right[:-1] = lbl[1:]
    po = gc.path_off
    starts = po[:-1][po[:-1] < po[1:]]
    ends = po[1:][po[:-1] < po[1:]] - 1
    left[starts] = start_tok
    right[ends] = end_tok
    repeat_contexts = _repeat_contexts(lbl, left, right, names, n_names)

    # Connected components (native union-find over edge pairs; python
    # path-halving fallback).
    la = seg_rows[gc.link_a]
    lb = seg_rows[gc.link_b]
    ok = (la >= 0) & (lb >= 0)
    roots = _components(n_segs, la[ok], lb[ok])
    comp_sizes = np.bincount(roots, minlength=n_segs) if n_segs else roots
    comp_sizes = comp_sizes[comp_sizes > 0]
    largest = int(comp_sizes.max()) if comp_sizes.size else 0
    tips = int(((degree_in == 0) | (degree_out == 0)).sum())

    # Duplicate-sequence groups (strand-canonical identical node DNA),
    # vectorized per length group.
    dup_groups, dup_nodes = _dup_sequence_groups(
        gc.seq_blob, gc.seq_offsets, node_lens
    )

    def pctl(sv, q):
        if sv is None or len(sv) == 0:
            return 0
        return int(sv[min(int(q * (len(sv) - 1)), len(sv) - 1)])

    dv_sorted = np.sort(depth)
    n_paths = max(gc.n_paths, 1)
    high_thr = max(2 * n_paths, 10)
    singleton_mask = depth == 1
    high_mask = depth >= high_thr
    singleton_nodes = int(singleton_mask.sum())
    singleton_bp = int(node_lens[singleton_mask].sum())
    high_nodes = int(high_mask.sum())
    high_bp = int(node_lens[high_mask].sum())

    # 1D jumps over numeric node ids.
    nid, has_nid = _numeric_ids(names)
    ja, jb = nid[gc.link_a], nid[gc.link_b]
    jok = has_nid[gc.link_a] & has_nid[gc.link_b]
    link_jumps = np.sort(np.abs(ja[jok] - jb[jok]))
    sn = nid[gc.step_name_idx]
    sh = has_nid[gc.step_name_idx]
    pj_ok = np.ones(sn.size, bool)
    if sn.size:
        pj_ok[po[1:][po[1:] < sn.size]] = False  # path boundaries
        pj_ok[0] = False
        pj = np.abs(sn[1:] - sn[:-1])[pj_ok[1:] & sh[1:] & sh[:-1]]
    else:
        pj = np.zeros(0, np.int64)
    path_jumps = np.sort(pj)

    mean_depth = (
        round(float((depth * node_lens).sum()) / total_len, 3)
        if total_len
        else 0.0
    )

    return {
        "nodes": n_segs,
        "edges": int(gc.link_a.size),
        "paths": gc.n_paths,
        "total_segment_bp": total_len,
        "node_length": stats(node_lens.tolist()),
        "path_length_bp": stats(path_lens),
        "node_depth": stats(depth.tolist()),
        "depth_buckets": buckets,
        "branching_nodes": branching,
        "merging_nodes": merging,
        "repeat_contexts": repeat_contexts,
        "components": int(comp_sizes.size),
        "largest_component_nodes": largest,
        "largest_component_frac": round(largest / max(n_segs, 1), 4),
        "tips": tips,
        "duplicate_sequence_groups": dup_groups,
        "duplicate_sequence_nodes": dup_nodes,
        "coverage_p10": pctl(dv_sorted, 0.10),
        "coverage_median": pctl(dv_sorted, 0.50),
        "coverage_p90": pctl(dv_sorted, 0.90),
        "singleton_nodes": singleton_nodes,
        "singleton_bp": singleton_bp,
        "high_coverage_threshold": high_thr,
        "high_coverage_nodes": high_nodes,
        "high_coverage_bp": high_bp,
        "link_jump_p95": pctl(link_jumps, 0.95),
        "link_jump_max": int(link_jumps[-1]) if link_jumps.size else 0,
        "path_jump_p95": pctl(path_jumps, 0.95),
        "path_jump_max": int(path_jumps[-1]) if path_jumps.size else 0,
        "mean_depth": mean_depth,
    }


def _components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Root per node over undirected edges (a[i], b[i])."""
    if n == 0:
        return np.zeros(0, np.int64)
    from impg_tpu_torch.io import native as native_mod

    lib = native_mod.load()
    if lib is not None and hasattr(lib, "uf_union_pairs"):
        h = lib.uf_create(n)
        try:
            lib.uf_union_pairs(
                h,
                np.ascontiguousarray(a, np.int64),
                np.ascontiguousarray(b, np.int64),
                int(a.size),
            )
            roots = np.zeros(n, np.int64)
            orient = np.zeros(n, np.uint8)
            lib.uf_find_all(h, roots, orient, n)
            return roots
        finally:
            lib.uf_destroy(h)
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    for x, y in zip(a.tolist(), b.tolist()):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry
    return np.array([find(i) for i in range(n)], np.int64)


_RC_LUT = None


def _rc_lut() -> np.ndarray:
    global _RC_LUT
    if _RC_LUT is None:
        from impg_tpu_torch.io.fasta import _COMPLEMENT

        _RC_LUT = np.frombuffer(
            bytes(range(256)).translate(_COMPLEMENT), np.uint8
        )
    return _RC_LUT


def _dup_sequence_groups(blob: bytes, offsets: np.ndarray,
                         lens: np.ndarray) -> tuple[int, int]:
    """(groups, nodes) with >1 occurrence of the same strand-canonical
    DNA — min(seq, reverse_complement(seq)) — grouped per length."""
    n = lens.size
    if n == 0:
        return 0, 0
    arr = np.frombuffer(blob, np.uint8)
    lut = _rc_lut()
    dup_groups = 0
    dup_nodes = 0
    order = np.argsort(lens, kind="stable")
    sorted_lens = lens[order]
    group_starts = np.nonzero(
        np.concatenate([[True], sorted_lens[1:] != sorted_lens[:-1]])
    )[0]
    group_ends = np.append(group_starts[1:], n)
    for gs, ge in zip(group_starts.tolist(), group_ends.tolist()):
        rows = order[gs:ge]
        L = int(sorted_lens[gs])
        cnt = ge - gs
        if L == 0:
            if cnt > 1:
                dup_groups += 1
                dup_nodes += cnt
            continue
        if cnt == 1:
            continue
        starts = offsets[rows]
        gather = (
            np.repeat(starts, L)
            + np.tile(np.arange(L, dtype=np.int64), cnt)
        )
        mat = arr[gather].reshape(cnt, L)
        rc = lut[mat][:, ::-1]
        diff = mat != rc
        any_diff = diff.any(axis=1)
        fd = np.argmax(diff, axis=1)
        ridx = np.arange(cnt)
        take_rc = any_diff & (mat[ridx, fd] > rc[ridx, fd])
        canon = np.where(take_rc[:, None], rc, mat)
        # Hash-first grouping (sorting raw rows is slow): only rows whose
        # 64-bit content hash repeats get exact dict counting.
        w = _hash_weights(L)
        h = (canon.astype(np.uint64) * w[None, :]).sum(axis=1)
        hv, hc = np.unique(h, return_counts=True)
        rep = hv[hc > 1]
        if rep.size:
            cand = np.isin(h, rep)
            by: dict[bytes, int] = {}
            for row in canon[cand]:
                key = row.tobytes()
                by[key] = by.get(key, 0) + 1
            dup_groups += sum(1 for c in by.values() if c > 1)
            dup_nodes += sum(c for c in by.values() if c > 1)
    return dup_groups, dup_nodes


_HASH_W: dict[int, np.ndarray] = {}


def _hash_weights(L: int) -> np.ndarray:
    w = _HASH_W.get(L)
    if w is None:
        rng = np.random.default_rng(0x5EED)
        w = rng.integers(1, 2**63, L, np.uint64) | np.uint64(1)
        _HASH_W[L] = w
    return w


def _numeric_ids(names: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """int(name) per interned name where it parses (the oracle's
    try-int semantics), vectorized for plain decimals."""
    n = len(names)
    nid = np.zeros(n, np.int64)
    has = np.zeros(n, bool)
    if n == 0:
        return nid, has
    arr = np.asarray(names)
    dec = np.char.isdecimal(arr) & (np.char.str_len(arr) <= 18)
    if dec.any():
        try:
            nid[dec] = arr[dec].astype(np.int64)
            has[dec] = True
        except ValueError:  # non-ASCII decimals: resolve individually
            for i in np.nonzero(dec)[0].tolist():
                try:
                    nid[i] = int(names[i])
                    has[i] = True
                except (ValueError, OverflowError):
                    pass
    # Rare non-plain-decimal names int() still accepts ('-3', ' 4', 18+
    # digits): resolve individually.
    maybe = ~dec & (
        np.char.isdecimal(np.char.lstrip(arr, "+- \t\n\r"))
        | (np.char.str_len(arr) > 18)
    )
    for i in np.nonzero(maybe)[0].tolist():
        try:
            nid[i] = int(names[i])
            has[i] = True
        except (ValueError, OverflowError):
            pass
    return nid, has


def _repeat_contexts(lbl, left, right, names, n_names):
    """Vectorized twin of the oracle's rare-repeated-context detection.

    Groups (node_label, left, right) triples by sorting; a node label
    qualifies when its dominant context is a strict-majority unique
    maximum with few minor occurrences.  Output order mirrors the
    oracle's stable sort over first-occurrence insertion order.
    """
    max_minor, min_dominance = 2, 0.80
    if lbl.size == 0:
        return []
    order = np.lexsort((right, left, lbl))
    sl, sle, sr = lbl[order], left[order], right[order]
    new_ctx = np.ones(sl.size, bool)
    new_ctx[1:] = (
        (sl[1:] != sl[:-1]) | (sle[1:] != sle[:-1]) | (sr[1:] != sr[:-1])
    )
    ctx_starts = np.nonzero(new_ctx)[0]
    ctx_counts = np.diff(np.append(ctx_starts, sl.size))
    ctx_lbl = sl[ctx_starts]
    ctx_left = sle[ctx_starts]
    ctx_right = sr[ctx_starts]
    # Group contexts per node label.
    new_lbl = np.ones(ctx_lbl.size, bool)
    new_lbl[1:] = ctx_lbl[1:] != ctx_lbl[:-1]
    lbl_starts = np.nonzero(new_lbl)[0]
    lbl_ends = np.append(lbl_starts[1:], ctx_lbl.size)
    # First-occurrence order of node labels in the step stream (the
    # oracle's dict insertion order), via sorted-unique + searchsorted.
    uniq_lbl, first_idx = np.unique(lbl, return_index=True)

    def first_seen(code: int) -> int:
        return int(first_idx[np.searchsorted(uniq_lbl, code)])

    def label_str(code):
        if code == 2 * n_names:
            return "^"
        if code == 2 * n_names + 1:
            return "$"
        return names[code // 2] + ("-" if code % 2 else "+")

    # Per-label stats in reduceat passes; only the few survivors get a
    # python loop.
    n_lbls = lbl_starts.size
    seg_id = np.cumsum(new_lbl) - 1  # ctx -> label ordinal
    n_ctx = lbl_ends - lbl_starts
    mx = np.maximum.reduceat(ctx_counts, lbl_starts)
    total = np.add.reduceat(ctx_counts, lbl_starts)
    n_max_hits = np.bincount(
        seg_id[ctx_counts == mx[seg_id]], minlength=n_lbls
    )
    minor = total - mx
    keep = (
        (n_ctx > 1)
        & (n_max_hits == 1)
        & (minor <= max_minor)
        # float-divide like the oracle so boundary rounding matches
        & (mx.astype(np.float64) / np.maximum(total, 1) >= min_dominance)
    )
    candidates = []
    for li in np.nonzero(keep)[0].tolist():
        s, e = int(lbl_starts[li]), int(lbl_ends[li])
        counts = ctx_counts[s:e]
        w = s + int(np.argmax(counts))
        node_code = int(ctx_lbl[s])
        t = int(total[li])
        m = int(mx[li])
        candidates.append(
            (
                first_seen(node_code),
                dict(
                    node=label_str(node_code),
                    total_occurrences=t,
                    dominant_count=m,
                    minor_occurrences=t - m,
                    dominant_fraction=round(m / t, 4),
                    dominant_left=label_str(int(ctx_left[w])),
                    dominant_right=label_str(int(ctx_right[w])),
                ),
            )
        )
    candidates.sort(
        key=lambda t: (
            -t[1]["minor_occurrences"],
            -t[1]["total_occurrences"],
            t[0],
        )
    )
    return [c for _, c in candidates[:5]]



def parse_gfa_columns(text) -> GfaColumns:
    """Tokenize GFA text/bytes into GfaColumns via the native parser
    (RuntimeError when the native library did not build)."""
    from impg_tpu_torch.io import native as native_mod

    data = text.encode() if isinstance(text, str) else text
    # Zero-copy views over the native buffers (each array's base chain
    # owns the handle); the 0/1 int8 flag columns reinterpret as bool
    # without a copy.
    cols = native_mod.parse_gfa_native(data)
    return GfaColumns(
        header=cols["header"],
        names=_names_from_blob(cols["names_blob"], cols["name_offsets"]),
        seg_name_idx=cols["seg_name_idx"],
        seq_blob=cols["seq_blob"],
        seq_offsets=cols["seq_offsets"],
        link_a=cols["link_a"],
        link_a_rev=cols["link_a_rev"].view(np.bool_),
        link_b=cols["link_b"],
        link_b_rev=cols["link_b_rev"].view(np.bool_),
        path_names=_names_from_blob(
            cols["path_names_blob"], cols["path_name_offsets"]
        ),
        path_is_walk=cols["path_is_walk"].view(np.bool_),
        path_off=cols["path_off"],
        step_name_idx=cols["step_name_idx"],
        step_rev=cols["step_rev"].view(np.bool_),
    )
