"""GFA normalization: shared-affix collapse (reference: gfaffix via
graph.rs:994 run_gfaffix / normalize_and_sort).

Walk-preserving simplifications, iterated to fixpoint:
  1. duplicate siblings: children of the same oriented parent with identical
     sequence merge into one node (both directions: shared parent and
     shared child);
  2. shared prefixes: children of the same oriented parent that share a
     common sequence prefix are split so the prefix becomes one shared node
     (the GFAffix "shared prefix decomposition");
  3. shared suffixes: the symmetric decomposition, run by reversing the
     graph (RC segments, flipped links/paths), applying the prefix sweep,
     and reversing back;
  4. unchop: unbranched forward chains merge, path-endpoint aware (a chain
     is only merged when every walk that enters it traverses it whole).

All path walks re-spell the exact same bases (fuzz-tested invariant,
tests/test_invariant_fuzz.py).

Note: affix sweeps operate on forward-orientation links whose members
never appear reversed in links or walks; mixed-orientation bubbles are
left untouched (conservative subset of gfaffix). `pre_groom` flips
majority-reverse paths forward first so that subset covers more.

The port's copy of impg_tpu/graph/normalize.py (tests/test_torch_graph_pipeline.py
holds the two equal): the columnar route over the port's columnar_ops, the
dict model (with sortgfa.groom) where the columnar output fails validation.
"""

from __future__ import annotations

from impg_tpu_torch.graph.gfa import Gfa
from impg_tpu_torch.io.fasta import reverse_complement


def _rc(seq: str) -> str:
    # IUPAC-aware (lowercase, ambiguity codes): unmapped bytes pass through
    # the translate table unchanged, so the suffix-sweep's double mirror
    # (_reverse_gfa twice) is lossless on every legal GFA sequence.
    return reverse_complement(seq.encode("ascii")).decode("ascii")


def _children(gfa: Gfa) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for a, ar, b, br in gfa.links:
        if not ar and not br:
            out.setdefault(a, []).append(b)
    return out


def _rewrite_paths(gfa: Gfa, mapping: dict[str, list[str]]) -> None:
    """Replace node ids in paths: mapping id -> replacement step list."""
    new_paths = []
    for name, steps in gfa.paths:
        out = []
        for sid, rev in steps:
            repl = mapping.get(sid)
            if repl is None:
                out.append((sid, rev))
            elif rev:
                out.extend((r, True) for r in reversed(repl))
            else:
                out.extend((r, False) for r in repl)
        new_paths.append((name, out))
    gfa.paths = new_paths


def _merge_duplicate_siblings(gfa: Gfa) -> bool:
    """Merge same-sequence forward children of a common parent."""
    children = _children(gfa)
    merged: dict[str, str] = {}
    for parent, kids in children.items():
        by_seq: dict[str, str] = {}
        for kid in kids:
            if kid in merged or kid == parent:
                continue
            seq = gfa.segments.get(kid)
            if seq is None:
                continue
            keep = by_seq.get(seq)
            if keep is None:
                by_seq[seq] = kid
            elif keep != kid:
                merged[kid] = keep
    if not merged:
        return False
    # Resolve chains.
    def resolve(x: str) -> str:
        while x in merged:
            x = merged[x]
        return x

    new_links = set()
    for a, ar, b, br in gfa.links:
        new_links.add((resolve(a), ar, resolve(b), br))
    gfa.links = sorted(new_links)
    for sid in list(merged):
        gfa.segments.pop(sid, None)
    _rewrite_paths(gfa, {sid: [resolve(sid)] for sid in merged})
    return True


def _reversed_participants(gfa: Gfa) -> set[str]:
    """Nodes appearing with reversed orientation in any link or walk."""
    out: set[str] = set()
    for a, ar, b, br in gfa.links:
        if ar:
            out.add(a)
        if br:
            out.add(b)
    for _name, steps in gfa.paths:
        for sid, rev in steps:
            if rev:
                out.add(sid)
    return out


def _shared_prefix_sweep(gfa: Gfa, next_id: list[int]) -> bool:
    """Split forward children sharing a sequence prefix; the prefix becomes
    one shared node. Batched: one pass collects every applicable
    (parent, group) whose nodes are untouched so far, then applies them
    all in a single link/path rewrite (the old implementation restarted
    the whole scan after each split, capping a round at one split)."""
    children = _children(gfa)
    rev_part = _reversed_participants(gfa)
    incoming: dict[str, int] = {}
    for a, ar, b, br in gfa.links:
        if not br:
            incoming[b] = incoming.get(b, 0) + 1

    actions: list[tuple[str, list[str], int]] = []
    touched: set[str] = set()
    for parent, kids in children.items():
        if parent in touched:
            continue
        kids = [k for k in dict.fromkeys(kids)
                if k in gfa.segments and k != parent]
        if len(kids) < 2:
            continue
        by_first: dict[str, list[str]] = {}
        for k in kids:
            seq = gfa.segments[k]
            if seq:
                by_first.setdefault(seq[0], []).append(k)
        for _first, group in by_first.items():
            # Guards: every member's only forward incoming link is from
            # `parent`, no reversed participation anywhere (its links and
            # walk steps are rewritten forward-only below), untouched this
            # sweep.
            group = [
                k for k in group
                if k not in touched and k not in rev_part
                and incoming.get(k, 0) == 1
            ]
            if len(group) < 2 or parent in group:
                continue
            seqs = [gfa.segments[k] for k in group]
            prefix_len = 0
            while all(
                len(s) > prefix_len and s[prefix_len] == seqs[0][prefix_len]
                for s in seqs
            ):
                prefix_len += 1
            # A member may BE the prefix (rest empty); require prefix>0.
            if prefix_len == 0:
                continue
            actions.append((parent, group, prefix_len))
            touched.update(group)
            touched.add(parent)
    if not actions:
        return False

    mapping: dict[str, list[str]] = {}
    member_parent: dict[str, str] = {}
    add_links: list[tuple[str, bool, str, bool]] = []
    for parent, group, prefix_len in actions:
        prefix = gfa.segments[group[0]][:prefix_len]
        pid = f"n{next_id[0]}"
        next_id[0] += 1
        gfa.segments[pid] = prefix
        add_links.append((parent, False, pid, False))
        for k in group:
            member_parent[k] = parent
            rest = gfa.segments[k][prefix_len:]
            if rest:
                rid = f"n{next_id[0]}"
                next_id[0] += 1
                gfa.segments[rid] = rest
                mapping[k] = [pid, rid]
                add_links.append((pid, False, rid, False))
            else:
                mapping[k] = [pid]

    final_links = set()
    for a, ar, b, br in list(gfa.links) + add_links:
        if b in member_parent and not br:
            # the sole forward incoming = parent link, replaced by
            # parent -> pid
            continue
        if a in mapping and not ar:
            a = mapping[a][-1]
        final_links.add((a, ar, b, br))
    gfa.links = sorted(final_links)
    for k in mapping:
        gfa.segments.pop(k, None)
    _rewrite_paths(gfa, mapping)
    return True


def _reverse_gfa(gfa: Gfa) -> Gfa:
    """Mirror the graph: RC segments, links (a,ar,b,br) -> (b,br,a,ar),
    walks reversed with orientations UNCHANGED. Each mirrored walk spells
    exactly the reverse complement of the original, so a spelling-
    preserving transform applied in the mirror is spelling-preserving in
    the original; applying the mirror twice is the identity. Shared
    suffixes become shared prefixes."""
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    out.segments = {sid: _rc(seq) for sid, seq in gfa.segments.items()}
    out.links = sorted({(b, br, a, ar) for a, ar, b, br in gfa.links})
    out.paths = [
        (name, [(sid, rev) for sid, rev in reversed(steps)])
        for name, steps in gfa.paths
    ]
    return out


def _half_sides(gfa: Gfa):
    """Per-node links touching its forward END / forward START side."""
    end: dict[str, list] = {}
    start: dict[str, list] = {}
    for link in gfa.links:
        a, ar, b, br = link
        (start if ar else end).setdefault(a, []).append(link)
        (end if br else start).setdefault(b, []).append(link)
    return end, start


def _unchop(gfa: Gfa) -> bool:
    """Merge unbranched forward chains, path-endpoint aware
    (graph.rs sort 'u' stage / gfaffix post-pass role)."""
    end, start = _half_sides(gfa)

    def forward_succ(a: str) -> str | None:
        ls = end.get(a, [])
        if len(ls) != 1:
            return None
        x, xr, y, yr = ls[0]
        if x == a and not xr and not yr and y != a:
            return y  # a+ -> y+
        if y == a and yr and xr and x != a:
            return x  # (x-,a-) == a+ -> x+
        return None

    def forward_pred_unique(b: str, expect: str) -> bool:
        ls = start.get(b, [])
        if len(ls) != 1:
            return False
        x, xr, y, yr = ls[0]
        if y == b and not yr and not xr:
            return x == expect
        if x == b and xr and yr:
            return y == expect
        return False

    pairs: dict[str, str] = {}
    for a in gfa.segments:
        b = forward_succ(a)
        if b is None or b not in gfa.segments:
            continue
        if forward_pred_unique(b, a):
            pairs[a] = b
    if not pairs:
        return False
    rpairs = {b: a for a, b in pairs.items()}

    # Walk validation: every traversal must cross the pair boundary whole.
    bad: set[str] = set()
    for _name, steps in gfa.paths:
        n = len(steps)
        for i, (sid, rev) in enumerate(steps):
            if sid in pairs and sid not in bad:
                b = pairs[sid]
                if not rev:  # a+ must be followed by b+
                    if i + 1 >= n or steps[i + 1] != (b, False):
                        bad.add(sid)
                else:  # a- must be preceded by b-
                    if i == 0 or steps[i - 1] != (b, True):
                        bad.add(sid)
            if sid in rpairs and rpairs[sid] not in bad:
                a0 = rpairs[sid]
                if not rev:  # b+ must be preceded by a+
                    if i == 0 or steps[i - 1] != (a0, False):
                        bad.add(a0)
                else:  # b- must be followed by a-
                    if i + 1 >= n or steps[i + 1] != (a0, True):
                        bad.add(a0)
    for a in bad:
        pairs.pop(a, None)
    if not pairs:
        return False
    rpairs = {b: a for a, b in pairs.items()}

    # Maximal chains: head = node that is not anyone's successor.
    chains: list[list[str]] = []
    for a in pairs:
        if a in rpairs:
            continue
        chain = [a]
        while chain[-1] in pairs:
            nxt = pairs[chain[-1]]
            if nxt in chain:  # cycle guard
                break
            chain.append(nxt)
        if len(chain) > 1:
            chains.append(chain)
    if not chains:
        return False

    head_of: dict[str, list[str]] = {c[0]: c for c in chains}
    tail_of: dict[str, list[str]] = {c[-1]: c for c in chains}
    inner: set[str] = set()
    for c in chains:
        inner.update(c[1:])

    for c in chains:
        gfa.segments[c[0]] = "".join(gfa.segments[s] for s in c)
    for s in inner:
        gfa.segments.pop(s, None)

    chain_edges = set()
    for c in chains:
        for x, y in zip(c, c[1:]):
            chain_edges.add((x, False, y, False))
            chain_edges.add((y, True, x, True))
    new_links = set()
    for a, ar, b, br in gfa.links:
        if (a, ar, b, br) in chain_edges:
            continue
        # End-side references to a chain tail move to the head node.
        if a in tail_of and not ar:
            a = tail_of[a][0]
        elif a in inner or (a in tail_of and ar):
            # inner nodes have no external links; a tail's start side only
            # carries the chain edge — both already excluded above.
            pass
        if b in tail_of and br:
            b = tail_of[b][0]
        new_links.add((a, ar, b, br))
    gfa.links = sorted(new_links)

    new_paths = []
    for name, steps in gfa.paths:
        out = []
        i = 0
        n = len(steps)
        while i < n:
            sid, rev = steps[i]
            if not rev and sid in head_of:
                out.append((sid, False))
                i += len(head_of[sid])
            elif rev and sid in tail_of:
                c = tail_of[sid]
                out.append((c[0], True))
                i += len(c)
            else:
                out.append((sid, rev))
                i += 1
        new_paths.append((name, out))
    gfa.paths = new_paths
    return True


# ── columnar core ───────────────────────────────────────────────────────
# Same passes over array-backed path walks (segments/links stay small
# dict/list-model objects; the per-step work — rewrite, expansion,
# reverse, unchop validation — is where 60 MiB graphs spend their time,
# measured ~70% of normalize in `_rewrite_paths` alone).  The dict
# implementation above is the semantics oracle and the fallback; the
# columnar output is validated to spell the exact same walks before it
# is returned (mismatch -> dict rerun).


class _PathCols:
    """Path walks as one int64 key array (name_idx*2 + rev) + CSR
    offsets, with a grow-only name intern table."""

    def __init__(self, names, id_of, path_names, keys, off):
        self.names = names  # list[str]
        self.id_of = id_of  # name -> idx
        self.path_names = path_names
        self.keys = keys  # int64 [n_steps]
        self.off = off  # int64 [n_paths + 1]

    @classmethod
    def from_columns(cls, gc):
        import numpy as np

        return cls(
            list(gc.names),
            {n: i for i, n in enumerate(gc.names)},
            list(gc.path_names),
            gc.step_name_idx.astype(np.int64) * 2 + gc.step_rev,
            gc.path_off.astype(np.int64),
        )

    def intern(self, sid: str) -> int:
        i = self.id_of.get(sid)
        if i is None:
            i = len(self.names)
            self.names.append(sid)
            self.id_of[sid] = i
        return i

    def rev_participants(self) -> set:
        """Names appearing reversed in any walk step."""
        import numpy as np

        rev_idx = np.unique(self.keys[(self.keys & 1) == 1] >> 1)
        return {self.names[int(i)] for i in rev_idx}

    def rewrite_single(self, mapping: dict) -> None:
        """sid -> replacement sid (orientation preserved).

        In-place on the affected steps only: the key array is the hot
        60 MB-class buffer, and this environment demotes cold pages —
        every fresh full-size allocation pays first-touch faults worth
        20-40x the arithmetic (measured), so passes that rebuild the
        whole array are the enemy."""
        import numpy as np

        n_names = len(self.names)
        flag = np.zeros(n_names, bool)
        val = np.zeros(n_names, np.int64)
        for sid, rep in mapping.items():
            i = self.id_of.get(sid)
            if i is not None and i < n_names:
                flag[i] = True
                val[i] = self.intern(rep)
        nm = self.keys >> 1
        aff = np.flatnonzero(flag.take(nm))
        if aff.size:
            self.keys[aff] = (
                val.take(nm.take(aff)) * 2 + (self.keys.take(aff) & 1)
            )

    def rewrite_split(self, mapping: dict) -> None:
        """sid -> [a] or [a, b] step expansion (dict `_rewrite_paths`
        semantics: a reverse step traverses the replacement reversed,
        all reversed).

        Affected-steps-only like `rewrite_single`: len-1 replacements
        update in place; len-2 expansions replace the step in place with
        their first key and `np.insert` the second (ONE full copy of the
        key array — the minimum, given the output is longer)."""
        import numpy as np

        n_names = len(self.names)
        # Intern replacements first (intern mutates the table).
        rep_ids = {
            sid: [self.intern(r) for r in reps]
            for sid, reps in mapping.items()
        }
        is_two = np.zeros(n_names, bool)
        is_one = np.zeros(n_names, bool)
        ff = np.zeros(n_names, np.int64)  # forward first
        fs = np.zeros(n_names, np.int64)  # forward second
        rf = np.zeros(n_names, np.int64)  # reverse first
        rs = np.zeros(n_names, np.int64)  # reverse second
        for sid, ids in rep_ids.items():
            i = self.id_of[sid]
            if i >= n_names:
                continue  # brand-new name cannot appear in walks
            if len(ids) == 1:
                is_one[i] = True
                ff[i] = ids[0] * 2
                rf[i] = ids[0] * 2 + 1
            else:
                a, b = ids
                is_two[i] = True
                ff[i], fs[i] = a * 2, b * 2
                rf[i], rs[i] = b * 2 + 1, a * 2 + 1
        nm = self.keys >> 1
        one_pos = np.flatnonzero(is_one.take(nm))
        if one_pos.size:
            onm = nm.take(one_pos)
            orv = self.keys.take(one_pos) & 1
            self.keys[one_pos] = np.where(
                orv == 1, rf.take(onm), ff.take(onm)
            )
        two_pos = np.flatnonzero(is_two.take(nm))
        if two_pos.size:
            tnm = nm.take(two_pos)
            trv = self.keys.take(two_pos) & 1
            self.keys[two_pos] = np.where(
                trv == 1, rf.take(tnm), ff.take(tnm)
            )
            second = np.where(trv == 1, rs.take(tnm), fs.take(tnm))
            self.keys = np.insert(self.keys, two_pos + 1, second)
            self.off = self.off + np.searchsorted(
                two_pos, self.off, side="left"
            )

    def reverse(self) -> None:
        """Reverse every walk's step order (orientations unchanged — the
        `_reverse_gfa` mirror semantics)."""
        import numpy as np

        lens = np.diff(self.off)
        pos_in = (
            np.arange(self.keys.size, dtype=np.int64)
            - np.repeat(self.off[:-1], lens)
        )
        ridx = np.repeat(self.off[1:], lens) - 1 - pos_in
        self.keys = self.keys.take(ridx)

    def to_steps(self):
        """Materialize dict-model step lists (small graphs/fallbacks)."""
        names = self.names
        out = []
        ks = self.keys.tolist()
        off = self.off.tolist()
        for p, name in enumerate(self.path_names):
            out.append((
                name,
                [(names[k >> 1], bool(k & 1)) for k in ks[off[p]:off[p + 1]]],
            ))
        return out


def _merge_duplicate_siblings_c(gfa: Gfa, P: _PathCols) -> bool:
    """Columnar `_merge_duplicate_siblings`: identical discovery over
    segments/links; the path rewrite is one vectorized LUT pass."""
    children = _children(gfa)
    merged: dict[str, str] = {}
    for parent, kids in children.items():
        by_seq: dict[str, str] = {}
        for kid in kids:
            if kid in merged or kid == parent:
                continue
            seq = gfa.segments.get(kid)
            if seq is None:
                continue
            keep = by_seq.get(seq)
            if keep is None:
                by_seq[seq] = kid
            elif keep != kid:
                merged[kid] = keep
    if not merged:
        return False

    def resolve(x: str) -> str:
        while x in merged:
            x = merged[x]
        return x

    new_links = set()
    for a, ar, b, br in gfa.links:
        new_links.add((resolve(a), ar, resolve(b), br))
    gfa.links = sorted(new_links)
    for sid in list(merged):
        gfa.segments.pop(sid, None)
    P.rewrite_single({sid: resolve(sid) for sid in merged})
    return True


def _shared_prefix_sweep_c(gfa: Gfa, P: _PathCols, next_id: list) -> bool:
    """Columnar `_shared_prefix_sweep`: identical discovery; the
    expansion rewrite runs vectorized."""
    children = _children(gfa)
    rev_part = {
        a for a, ar, _b, _br in gfa.links if ar
    } | {
        b for _a, _ar, b, br in gfa.links if br
    } | P.rev_participants()
    incoming: dict[str, int] = {}
    for a, ar, b, br in gfa.links:
        if not br:
            incoming[b] = incoming.get(b, 0) + 1

    actions: list[tuple[str, list, int]] = []
    touched: set = set()
    for parent, kids in children.items():
        if parent in touched:
            continue
        kids = [k for k in dict.fromkeys(kids)
                if k in gfa.segments and k != parent]
        if len(kids) < 2:
            continue
        by_first: dict[str, list] = {}
        for k in kids:
            seq = gfa.segments[k]
            if seq:
                by_first.setdefault(seq[0], []).append(k)
        for _first, group in by_first.items():
            group = [
                k for k in group
                if k not in touched and k not in rev_part
                and incoming.get(k, 0) == 1
            ]
            if len(group) < 2 or parent in group:
                continue
            seqs = [gfa.segments[k] for k in group]
            prefix_len = 0
            while all(
                len(s) > prefix_len and s[prefix_len] == seqs[0][prefix_len]
                for s in seqs
            ):
                prefix_len += 1
            if prefix_len == 0:
                continue
            actions.append((parent, group, prefix_len))
            touched.update(group)
            touched.add(parent)
    if not actions:
        return False

    mapping: dict[str, list] = {}
    member_parent: dict[str, str] = {}
    add_links: list = []
    for parent, group, prefix_len in actions:
        prefix = gfa.segments[group[0]][:prefix_len]
        pid = f"n{next_id[0]}"
        next_id[0] += 1
        gfa.segments[pid] = prefix
        add_links.append((parent, False, pid, False))
        for k in group:
            member_parent[k] = parent
            rest = gfa.segments[k][prefix_len:]
            if rest:
                rid = f"n{next_id[0]}"
                next_id[0] += 1
                gfa.segments[rid] = rest
                mapping[k] = [pid, rid]
                add_links.append((pid, False, rid, False))
            else:
                mapping[k] = [pid]

    final_links = set()
    for a, ar, b, br in list(gfa.links) + add_links:
        if b in member_parent and not br:
            continue
        if a in mapping and not ar:
            a = mapping[a][-1]
        final_links.add((a, ar, b, br))
    gfa.links = sorted(final_links)
    for k in mapping:
        gfa.segments.pop(k, None)
    P.rewrite_split(mapping)
    return True


def _reverse_c(gfa: Gfa, P: _PathCols) -> None:
    """In-place `_reverse_gfa`: RC segments, mirror links, reverse walks
    (orientations unchanged).  Applying twice is the identity."""
    gfa.segments = {sid: _rc(seq) for sid, seq in gfa.segments.items()}
    gfa.links = sorted({(b, br, a, ar) for a, ar, b, br in gfa.links})
    P.reverse()


def _unchop_c(gfa: Gfa, P: _PathCols) -> bool:
    """Columnar `_unchop`: chain discovery over links (dict-identical),
    walk validation and the step rewrite vectorized."""
    import numpy as np

    end, start = _half_sides(gfa)

    def forward_succ(a: str):
        ls = end.get(a, [])
        if len(ls) != 1:
            return None
        x, xr, y, yr = ls[0]
        if x == a and not xr and not yr and y != a:
            return y
        if y == a and yr and xr and x != a:
            return x
        return None

    def forward_pred_unique(b: str, expect: str) -> bool:
        ls = start.get(b, [])
        if len(ls) != 1:
            return False
        x, xr, y, yr = ls[0]
        if y == b and not yr and not xr:
            return x == expect
        if x == b and xr and yr:
            return y == expect
        return False

    pairs: dict[str, str] = {}
    for a in gfa.segments:
        b = forward_succ(a)
        if b is None or b not in gfa.segments:
            continue
        if forward_pred_unique(b, a):
            pairs[a] = b
    if not pairs:
        return False

    n_names = len(P.names)
    succ_of = np.full(n_names, -1, np.int64)
    pred_of = np.full(n_names, -1, np.int64)
    for a, b in pairs.items():
        ia, ib = P.id_of.get(a), P.id_of.get(b)
        if ia is None or ib is None:
            # pair members absent from every walk: trivially valid
            continue
        succ_of[ia] = ib
        pred_of[ib] = ia

    nm = P.keys >> 1
    rv = (P.keys & 1).astype(bool)
    NONE = np.int64(-3)
    nxt_nm = np.full(nm.size, NONE)
    prv_nm = np.full(nm.size, NONE)
    nxt_rv = np.zeros(nm.size, bool)
    prv_rv = np.zeros(nm.size, bool)
    if nm.size:
        nxt_nm[:-1] = nm[1:]
        nxt_rv[:-1] = rv[1:]
        prv_nm[1:] = nm[:-1]
        prv_rv[1:] = rv[:-1]
        starts = P.off[:-1][P.off[:-1] < P.off[1:]]
        ends = P.off[1:][P.off[:-1] < P.off[1:]] - 1
        prv_nm[starts] = NONE
        nxt_nm[ends] = NONE

    bad_idx: list = []
    succ_nm = succ_of.take(nm)
    pred_nm = pred_of.take(nm)
    has_succ = succ_nm >= 0
    # a+ must be followed by b+; a- preceded by b-.
    m = has_succ & ~rv & ((nxt_nm != succ_nm) | nxt_rv)
    bad_idx.append(nm[m])
    m = has_succ & rv & ((prv_nm != succ_nm) | ~prv_rv)
    bad_idx.append(nm[m])
    has_pred = pred_nm >= 0
    # b+ must be preceded by a+; b- followed by a-.
    m = has_pred & ~rv & ((prv_nm != pred_nm) | prv_rv)
    bad_idx.append(pred_nm[m])
    m = has_pred & rv & ((nxt_nm != pred_nm) | ~nxt_rv)
    bad_idx.append(pred_nm[m])
    bad = {P.names[int(i)] for i in np.unique(np.concatenate(bad_idx))}
    for a in bad:
        pairs.pop(a, None)
    if not pairs:
        return False
    rpairs = {b: a for a, b in pairs.items()}

    chains: list[list] = []
    for a in pairs:
        if a in rpairs:
            continue
        chain = [a]
        while chain[-1] in pairs:
            nxt = pairs[chain[-1]]
            if nxt in chain:
                break
            chain.append(nxt)
        if len(chain) > 1:
            chains.append(chain)
    if not chains:
        return False

    tail_of: dict[str, list] = {c[-1]: c for c in chains}
    inner: set = set()
    for c in chains:
        inner.update(c[1:])

    for c in chains:
        gfa.segments[c[0]] = "".join(gfa.segments[s] for s in c)
    for s in inner:
        gfa.segments.pop(s, None)

    chain_edges = set()
    for c in chains:
        for x, y in zip(c, c[1:]):
            chain_edges.add((x, False, y, False))
            chain_edges.add((y, True, x, True))
    new_links = set()
    for a, ar, b, br in gfa.links:
        if (a, ar, b, br) in chain_edges:
            continue
        if a in tail_of and not ar:
            a = tail_of[a][0]
        if b in tail_of and br:
            b = tail_of[b][0]
        new_links.add((a, ar, b, br))
    gfa.links = sorted(new_links)

    # Step rewrite: a forward whole-chain run keeps only (head, +); a
    # reverse run keeps only its first step (tail, -) renamed to head.
    cat_drop = np.zeros(n_names, bool)  # drop both orientations (inner)
    head_fw = np.zeros(n_names, bool)  # head: keep +, drop -
    tail_rv = np.full(n_names, -1, np.int64)  # tail: - renamed to head
    for c in chains:
        for s in c[1:-1]:
            i = P.id_of.get(s)
            if i is not None:
                cat_drop[i] = True
        ih = P.id_of.get(c[0])
        it = P.id_of.get(c[-1])
        if ih is not None:
            head_fw[ih] = True
        if it is not None and ih is not None:
            tail_rv[it] = ih
    is_head = head_fw.take(nm)
    tail_nm = tail_rv.take(nm)
    is_tail = tail_nm >= 0
    keep = ~cat_drop.take(nm)
    keep &= ~(is_head & rv)  # (head, -) ends a reverse run: dropped
    keep &= ~(is_tail & ~rv)  # (tail, +) ends a forward run: dropped
    new_keys = P.keys[keep]
    # Rename kept (tail, -) steps to (head, -).
    knm = new_keys >> 1
    krv = (new_keys & 1).astype(bool)
    sel = (tail_rv[knm] >= 0) & krv
    new_keys = np.where(sel, tail_rv[knm] * 2 + 1, new_keys)
    cnt = np.zeros(nm.size + 1, np.int64)
    np.cumsum(keep, out=cnt[1:])
    P.keys = new_keys
    P.off = cnt[P.off]
    return True


def _normalize_columns(gfa_text: str, max_rounds: int, pre_groom: bool):
    """Columnar normalize; None when the native tokenizer is missing or
    the input is degenerate (duplicate S names)."""
    import numpy as np

    from impg_tpu_torch.graph import columnar_ops as co
    from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

    try:
        gc = parse_gfa_columns(gfa_text)
    except ValueError:
        raise
    except Exception:
        return None
    if gc is None:
        return None
    if gc.n_segs and np.unique(gc.seg_name_idx).size != gc.n_segs:
        return None
    if pre_groom:
        gc = co.groom_columns(gc)
    # Dict-model segments/links (small), columnar path walks (large).
    gfa = Gfa(header=gc.header or "H\tVN:Z:1.0")
    names = gc.names
    offs = gc.seq_offsets
    blob = gc.seq_blob.decode("latin-1")
    gfa.segments = {
        names[i]: blob[int(offs[r]):int(offs[r + 1])]
        for r, i in enumerate(gc.seg_name_idx.tolist())
    }
    gfa.links = sorted({
        (names[a], bool(ar), names[b], bool(br))
        for a, ar, b, br in zip(
            gc.link_a.tolist(), gc.link_a_rev.tolist(),
            gc.link_b.tolist(), gc.link_b_rev.tolist(),
        )
    })
    gfa.walk_names = {
        gc.path_names[p]
        for p in np.nonzero(gc.path_is_walk)[0].tolist()
    }
    P = _PathCols.from_columns(gc)

    next_id = [
        max(
            (int(s[1:]) for s in gfa.segments
             if s.startswith("n") and s[1:].isdigit()),
            default=0,
        )
        + 1000000
    ]
    for _ in range(max_rounds):
        changed = _merge_duplicate_siblings_c(gfa, P)
        changed |= _shared_prefix_sweep_c(gfa, P, next_id)
        # Suffix side: mirror in place, prefix-sweep, mirror back.
        _reverse_c(gfa, P)
        rchanged = _merge_duplicate_siblings_c(gfa, P)
        rchanged |= _shared_prefix_sweep_c(gfa, P, next_id)
        _reverse_c(gfa, P)
        changed |= rchanged
        changed |= _unchop_c(gfa, P)
        if not changed:
            break
    # Emit through the columnar writer (byte-identical to Gfa.write) —
    # materializing 10M dict-model step tuples costs more than the whole
    # fixpoint loop.
    from dataclasses import replace as _replace

    seg_items = list(gfa.segments.items())
    seg_name_idx = np.asarray(
        [P.intern(sid) for sid, _ in seg_items], np.int32
    )
    blob = "".join(seq for _, seq in seg_items).encode("latin-1")
    seq_offsets = np.zeros(len(seg_items) + 1, np.int64)
    np.cumsum(
        np.asarray([len(seq) for _, seq in seg_items], np.int64),
        out=seq_offsets[1:],
    )
    link_a = np.asarray([P.intern(a) for a, _, _, _ in gfa.links], np.int32)
    link_b = np.asarray([P.intern(b) for _, _, b, _ in gfa.links], np.int32)
    out_gc = _replace(
        gc,
        names=P.names,
        seg_name_idx=seg_name_idx,
        seq_blob=blob,
        seq_offsets=seq_offsets,
        link_a=link_a,
        link_a_rev=np.asarray([ar for _, ar, _, _ in gfa.links], bool),
        link_b=link_b,
        link_b_rev=np.asarray([br for _, _, _, br in gfa.links], bool),
        path_names=P.path_names,
        path_is_walk=np.asarray(
            [n in gfa.walk_names for n in P.path_names], bool
        ),
        path_off=P.off,
        step_name_idx=(P.keys >> 1).astype(np.int32),
        step_rev=(P.keys & 1).astype(bool),
        _seg_row_of_name=None,
    )
    return co.write_columns(out_gc)


def normalize_gfa(
    gfa_text: str, max_rounds: int = 200, pre_groom: bool = True
) -> str:
    # Columnar fast path, validated: the output must spell the exact
    # same walks as the input (the module's core invariant); any
    # mismatch — including a degenerate parse — falls back to the dict
    # implementation below.
    try:
        out = _normalize_columns(gfa_text, max_rounds, pre_groom)
    except ValueError:
        raise
    except Exception:
        out = None
    if out is not None:
        from impg_tpu_torch.graph import columnar_ops as co

        expected = co.path_spellings_of_text(gfa_text)
        ok = (
            co.validate_text_spellings(out, expected)
            if expected is not None else None
        )
        if ok:
            return out

    gfa = Gfa.parse(gfa_text)
    if pre_groom:
        # Groom first (spelling-preserving majority-orientation flips):
        # many mixed-orientation links become forward-forward, extending
        # the reach of the forward-only affix collapse below.
        from impg_tpu_torch.graph.sortgfa import groom

        gfa = groom(gfa)
    next_id = [
        max(
            (int(s[1:]) for s in gfa.segments
             if s.startswith("n") and s[1:].isdigit()),
            default=0,
        )
        + 1000000
    ]
    for _ in range(max_rounds):
        changed = _merge_duplicate_siblings(gfa)
        changed |= _shared_prefix_sweep(gfa, next_id)
        # Suffix side: reverse, prefix-sweep, reverse back.
        rev = _reverse_gfa(gfa)
        rchanged = _merge_duplicate_siblings(rev)
        rchanged |= _shared_prefix_sweep(rev, next_id)
        if rchanged:
            gfa = _reverse_gfa(rev)
            changed = True
        changed |= _unchop(gfa)
        if not changed:
            break
    return gfa.write()
